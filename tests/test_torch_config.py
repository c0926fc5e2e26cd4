"""The port's copy of the config module (sad_tpu_torch/config) against
sad_tpu.config: the same schema and defaults, the same values from both
in-repo flagship YAMLs (SOLVER, TRAIN and DISTILLATION included), the same
type aliases, deprecated keys and dataset catalog, and the same refusals of
unknown keys. Exact equality: it is a copy."""

import dataclasses
from pathlib import Path

import pytest

import sad_tpu.config as jcfg
import sad_tpu.config.catalog as jcatalog
import sad_tpu.config.config as jconfig
import sad_tpu_torch.config as tcfg
import sad_tpu_torch.config.catalog as tcatalog
import sad_tpu_torch.config.config as tconfig

REPO = Path(__file__).resolve().parent.parent
FLAGSHIP = sorted(str(p) for p in (REPO / "sad_tpu_torch" / "configs").glob("*.yaml"))


def _asdict(cfg):
    return dataclasses.asdict(cfg)


def test_defaults_and_schema_equal():
    assert _asdict(tcfg.Config()) == _asdict(jcfg.Config())
    names = lambda mod: sorted(f.name for f in dataclasses.fields(mod.Config))  # noqa: E731
    assert names(tconfig) == names(jconfig)


@pytest.mark.parametrize("path", FLAGSHIP, ids=lambda p: Path(p).stem)
def test_flagship_yaml_loads_equal(path):
    t, j = tcfg.load_cfg(path), jcfg.load_cfg(path)
    assert _asdict(t) == _asdict(j)
    for section in ("SOLVER", "TRAIN", "DISTILLATION", "RETINANET", "FPN", "MODEL"):
        assert _asdict(getattr(t, section)) == _asdict(getattr(j, section)), section
    assert t.fpn_levels() == j.fpn_levels() == (3, 4, 5, 6, 7)
    assert t.num_anchors_per_cell() == j.num_anchors_per_cell() == 9


@pytest.mark.parametrize("path", FLAGSHIP, ids=lambda p: Path(p).stem)
def test_cli_overrides_equal(path):
    opts = ["SOLVER.BASE_LR", "0.02", "SOLVER.STEPS", "(0, 60000, 80000)",
            "SOLVER.LR_POLICY", "steps_with_decay", "TRAIN.FREEZE_AT", "3",
            "PIXEL_STD", "(57.375,57.12,58.395)", "DISTILLATION.TEMPERATURE", "2.0",
            "COMPUTE_DTYPE", "float32", "NUM_GPUS", "4"]
    assert _asdict(tcfg.load_cfg(path, opts)) == _asdict(jcfg.load_cfg(path, opts))


@pytest.mark.parametrize("bad", [
    {"SOLVER": {"NOT_A_KEY": 1}},
    {"TRAIN": {"SCALEZ": (600,)}},
    {"DISTILLATION": {"LOSS_ALPHAS": 0.5}},
    {"NOT_A_SECTION": {"X": 1}},
])
def test_unknown_keys_raise_in_both(bad):
    with pytest.raises(Exception) as j_err:
        jconfig.merge_cfg_from_dict(jcfg.Config(), bad)
    with pytest.raises(Exception) as t_err:
        tconfig.merge_cfg_from_dict(tcfg.Config(), bad)
    assert type(t_err.value).__name__ == type(j_err.value).__name__
    assert str(t_err.value) == str(j_err.value)


def test_tables_equal():
    assert tconfig._TYPE_ALIASES == jconfig._TYPE_ALIASES
    assert tconfig._DEPRECATED_KEYS == jconfig._DEPRECATED_KEYS
    assert tconfig._RENAMED_KEYS == jconfig._RENAMED_KEYS
    assert sorted(tcfg.DATASET_CATALOG) == sorted(jcfg.DATASET_CATALOG)
    # the same paths under each package's data root (their defaults differ)
    t_root, j_root = tcatalog._DATA_DIR, jcatalog._DATA_DIR
    for name in jcfg.DATASET_CATALOG:
        want = {k: v.replace(j_root, t_root, 1) if isinstance(v, str) and v.startswith(j_root)
                else v for k, v in dataclasses.asdict(jcfg.get_dataset_spec(name)).items()}
        assert dataclasses.asdict(tcfg.get_dataset_spec(name)) == want, name


def test_deprecated_key_is_tolerated_in_both():
    d = {"MODEL": {"TYPE": "retinanet"}, "USE_GPU_NMS": True}
    assert _asdict(tconfig.merge_cfg_from_dict(tcfg.Config(), d)) == _asdict(
        jconfig.merge_cfg_from_dict(jcfg.Config(), d))
