"""The port's ResNet-FPN RetinaNet against sad_tpu's Flax model: the same
float32 weights (converted by sad_tpu_torch/convert.py) and the same numpy
inputs give per-level outputs within max-abs <= 1e-4 * max|ref| + 1e-5 (the
two frameworks sum f32 convolutions in different orders); the converter
round-trips exactly; at full width the port's state_dict has the keys and
shapes of the Flax parameter tree of both flagship configs."""

import dataclasses
import pickle
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import sad_tpu.config as jcfg
from sad_tpu.models import RetinaNet as JaxRetinaNet
from sad_tpu.models import arch as jarch
from sad_tpu.models.resnet import ResNetBody as JaxResNetBody
from sad_tpu_torch.convert import (
    load_params, params_to_state_dict, state_dict_to_params,
)
from sad_tpu_torch.models import RetinaNet, arch as tarch
from sad_tpu_torch.models.resnet import ResNetBody

REPO = Path(__file__).resolve().parent.parent
# the RetinaNet configs; the R-CNN ones are held in tests/test_torch_rcnn.py
FLAGSHIP = sorted(str(p) for p in (REPO / "sad_tpu_torch" / "configs").glob("retinanet_*.yaml"))

ARCHS = {
    # __graft_entry__._tiny_arch widths, one block per stage
    "tiny": {},
    # the other branches: softmax probs, a shared tower, the max-pool P6 level
    "softmax_shared_p6pool": dict(softmax=True, share_cls_bbox_tower=True, max_level=6,
                                  extra_conv_levels=False, num_convs=2, num_classes=5),
}


def _port_arch(jax_arch):
    return tarch.ModelArch(**dataclasses.asdict(jax_arch))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread while a test module of the port runs: the tiny
    models gain nothing from intra-op threads, and beside the other test
    processes on the same cores their spin-waits cost tens of seconds a
    file. Test modules import it to use it; the prior count comes back
    after the module."""
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prior)


# guards of all test processes take this lock in turn (.gitignore lists the directory)
NATIVE_GUARD_LOCK = REPO / "sad_tpu_torch" / "_build" / "sad_tpu_native_guard.lock"


def load_sad_tpu_native(wait_s: float = 120.0):
    """sad_tpu's native host kernels, loaded, or ``pytest.fail``.

    sad_tpu/native/__init__.py:28-35 compiles host_kernels.cpp into its
    source tree under one fixed temporary name and no lock. A process whose
    g++ or ``os.replace`` loses that race to another process sets
    ``_build_failed``, and from then on sad_tpu answers with its float64
    numpy fallback (``assign_overlaps`` returns None), not the float32
    native pass that the port's tests hold it to. Under an exclusive lock,
    so that guards never compile against each other, this clears the flag
    and loads again once a second for up to ``wait_s``: a compile that
    another process started lands its .so in that time."""
    import fcntl

    import sad_tpu.native as jnative

    NATIVE_GUARD_LOCK.parent.mkdir(parents=True, exist_ok=True)
    with open(NATIVE_GUARD_LOCK, "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        deadline = time.monotonic() + wait_s
        lib = jnative._get_lib()
        while lib is None and time.monotonic() < deadline:
            time.sleep(1.0)
            jnative._build_failed = False
            lib = jnative._get_lib()
    if lib is None:
        pytest.fail(f"sad_tpu's native host kernels did not load within {wait_s:g} s. "
                    "sad_tpu/native/__init__.py:28-35 builds them in the source tree under one "
                    "fixed temporary name and no lock, so a test process that loses that build "
                    "race to another one falls back to float64 numpy, which is not the reference "
                    "these tests mean (ROADMAP.md Queue 3, sad_tpu's unlocked in-tree build)",
                    pytrace=False)
    return lib


@pytest.fixture(scope="module", autouse=True)
def sad_tpu_native_loaded():
    """sad_tpu's native host kernels loaded before a test module of the port
    whose reference reaches them (``load_sad_tpu_native``). Test modules
    import it to use it."""
    load_sad_tpu_native()


def random_params(module, x, seed):
    """Float32 params for a Flax module from numpy: fan-in scaled kernels,
    AffineChannel scales and offsets away from 1/0, non-zero biases (cheaper
    than an eager Flax init, and every leaf carries signal)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            out = rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name == "s":
            out = rng.uniform(0.5, 1.5, s.shape)
        elif "cls_pred" in path[-2].key:
            out = rng.normal(-2.0, 0.5, s.shape)
        else:
            out = rng.normal(0.0, 0.1, s.shape)
        return out.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _close(ref, got):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape
    tol = 1e-4 * np.abs(ref).max() + 1e-5
    err = np.abs(ref - got).max()
    assert err <= tol, (err, tol)


@pytest.fixture(scope="module", params=sorted(ARCHS))
def pair(request):
    """(jax arch, params, jax outputs, port outputs) built once per arch."""
    arch = graft._tiny_arch(**ARCHS[request.param])
    rng = np.random.RandomState(0)
    x = rng.randn(2, 128, 128, 3).astype(np.float32)
    model = JaxRetinaNet(arch)
    params = random_params(model, x, seed=1)
    ref = jax.jit(model.apply)({"params": params}, jnp.asarray(x))  # one compile, not eager
    port = load_params(RetinaNet(_port_arch(arch)).eval(), params)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    return arch, params, ref, got, port


@pytest.mark.parametrize("key", ["cls_logits", "bbox_pred", "cls_prob"])
def test_per_level_outputs_match(pair, key):
    arch, _, ref, got, _ = pair
    assert sorted(got[key]) == list(arch.levels)
    for lvl in arch.levels:
        assert got[key][lvl].dtype == torch.float32
        _close(ref[key][lvl], got[key][lvl].numpy())


def test_converter_round_trip_is_exact(pair):
    _, params, _, _, port = pair
    back = state_dict_to_params(port.state_dict())
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and np.array_equal(a, b), path


def test_converter_rejects_mismatched_trees(pair):
    _, params, _, _, port = pair
    bad = pickle.loads(pickle.dumps(params))
    bad["head"]["not_a_module"] = {"bias": np.zeros(3, np.float32)}
    with pytest.raises(KeyError, match="unknown"):
        load_params(port, bad)
    bad = pickle.loads(pickle.dumps(params))
    del bad["fpn"]["body"]["conv1"]
    with pytest.raises(KeyError, match="missing"):
        load_params(port, bad)
    bad = pickle.loads(pickle.dumps(params))
    bad["fpn"]["body"]["res_conv1_bn"]["s"] = np.ones(3, np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_params(port, bad)


def test_body_grouped_dilated_stride3x3_matches():
    """ResNeXt groups, STRIDE_1X1=False and RES5_DILATION on the trunk alone
    (FPN's top-down path needs an undilated res5)."""
    arch = graft._tiny_arch(num_groups=2, width_per_group=4, stride_1x1=False,
                            res5_dilation=2, block_counts=(1, 2, 1, 1))
    x = np.random.RandomState(1).randn(1, 64, 96, 3).astype(np.float32)
    body = JaxResNetBody(arch)
    params = random_params(body, x, seed=2)
    ref = jax.jit(body.apply)({"params": params}, jnp.asarray(x))
    port = load_params(ResNetBody(_port_arch(arch)).eval(), params)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert sorted(got) == sorted(ref)
    for name in ref:
        _close(ref[name], got[name].permute(0, 2, 3, 1).numpy())


@pytest.mark.parametrize("path", FLAGSHIP, ids=lambda p: Path(p).stem)
def test_full_width_state_dict_matches_flax_tree(path):
    jc = jcfg.load_cfg(path)
    a = jarch.arch_from_config(jc)
    t = tarch.arch_from_config(jc)
    assert dataclasses.asdict(t) == dataclasses.asdict(a)  # field for field
    assert a.depth in (50, 101) and a.fpn_dim == 256 and a.num_classes == 81
    shapes = jax.eval_shape(JaxRetinaNet(a).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 128, 128, 3), jnp.float32))["params"]
    want = {k: tuple(v.shape) for k, v in params_to_state_dict(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)).items()}
    with torch.device("meta"):
        port = RetinaNet(t)
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == want
    assert len(got) > 150


@pytest.mark.parametrize("path", FLAGSHIP, ids=lambda p: Path(p).stem)
def test_flagship_config_values(path):
    """The flagship YAMLs hold __graft_entry__._distill_cfg's values
    (__graft_entry__.py:41-70) and make the 640x1024 landscape canvas; the
    scale-500 pair (the paper's R-101 <- X-101 experiment) trains and tests
    at scale 500, MAX_SIZE 833, on the 512x896 canvas."""
    from sad_tpu_torch.eval.test_engine import _test_canvas_shapes

    c = jcfg.load_cfg(path)
    want = graft._distill_cfg(1)
    canvas = (640, 1024)
    if path.endswith("_500.yaml"):
        canvas = (512, 896)
        want = dataclasses.replace(want, TEST=dataclasses.replace(
            want.TEST, SCALES=(500,), MAX_SIZE=833))
        assert (c.TRAIN.SCALES, c.TRAIN.MAX_SIZE) == ((500,), 833) and c.FOLD_AFFINE
    assert c.MODEL.NUM_CLASSES == 81 and c.TEST.NMS == 0.5
    assert c.fpn_levels() == (3, 4, 5, 6, 7) and c.num_anchors_per_cell() == 9
    assert c.FPN.EXTRA_CONV_LEVELS and c.FPN.COARSEST_STRIDE == 128
    for section, keys in (("RETINANET", ("ASPECT_RATIOS", "SCALES_PER_OCTAVE", "ANCHOR_SCALE",
                                         "NUM_CONVS", "PRE_NMS_TOP_N", "INFERENCE_TH")),
                          ("TEST", ("SCALES", "MAX_SIZE", "DETECTIONS_PER_IM"))):
        for key in keys:
            assert getattr(getattr(c, section), key) == getattr(getattr(want, section), key), key
    assert _test_canvas_shapes(c) == (canvas, canvas[::-1])
    body = "ResNet50" if "R-50" in path else "ResNet101"
    assert c.MODEL.CONV_BODY == f"FPN.add_fpn_{body}_conv5_body"


def test_native_checkpoint_loads_without_jax(pair, tmp_path):
    from sad_tpu.train.checkpoint import save_checkpoint

    _, params, _, _, _ = pair
    ckpt = tmp_path / "model_final.pkl"
    save_checkpoint(str(ckpt), params, iteration=3)
    out = tmp_path / "sd.pt"
    code = textwrap.dedent(f"""
        import sys, torch
        from sad_tpu_torch.convert import params_to_state_dict
        from sad_tpu_torch.train.checkpoint import load_checkpoint
        sd = params_to_state_dict(load_checkpoint({str(ckpt)!r})["params"])
        assert not [m for m in ("jax", "flax") if m in sys.modules]
        torch.save(sd, {str(out)!r})
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert res.returncode == 0, res.stderr
    loaded = torch.load(out)
    direct = params_to_state_dict(params)
    assert sorted(loaded) == sorted(direct)
    for k in direct:
        assert torch.equal(loaded[k], direct[k]), k
