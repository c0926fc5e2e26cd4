"""The port's training workflow on the CPU, on the tiny architecture of
tests/test_resume.py (CHANNEL_RATIO 0.25, SCALES (64,)) and a synthetic COCO
written by the port:

- parity: sad_tpu's ``train_model`` and the port's, from the same student
  and teacher weights (TRAIN.WEIGHTS naming sad_tpu native pickles), over a
  labeled and a pseudo-labeled stream for 4 iterations with an LR step and
  its momentum correction. Per-iteration metrics (the raw values and the
  smoothed stats.jsonl lines) within 1e-4 relative, final params and
  velocity within 1e-4 of each leaf's max, the tolerance of
  tests/test_torch_train_step.py (the frameworks sum convolutions in other
  orders); the port's loader runs in two worker processes;
- resume: a run continued from a mid-run snapshot in a fresh directory ends
  bit-identical to the uninterrupted run, for the joint SAD step and the
  Faster R-CNN step, with the LR step exactly at the resume iteration,
  under torch.use_deterministic_algorithms (two uninterrupted R-CNN runs
  differ in the last bits without it); a third invocation is a no-op;
- a NaN loss aborts with model_nan_abort.pkl;
- the train_net CLI: the teacher's pseudo-labels registered as the
  unlabeled stream and trained with --skip-test; without it the finished
  run is evaluated (results.json) and an impossible EXPECTED_RESULTS raises
  ExpectedResultsError; a distillation config without --teacher_cfg
  exits 1.
"""

import glob
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

import sad_tpu.config as jcfg
import sad_tpu_torch.config as tcfg
from sad_tpu.config.config import merge_cfg_from_dict as j_merge
from sad_tpu.models import create_model as j_create_model
from sad_tpu.train import checkpoint as jck
from sad_tpu.train import train_loop as jloop
from sad_tpu_torch.config.config import cfg_to_yaml
from sad_tpu_torch.config.config import merge_cfg_from_dict as t_merge
from sad_tpu_torch.convert import state_dict_to_params
from sad_tpu_torch.data.synth_coco import generate_synthetic_coco
from sad_tpu_torch.eval.task_evaluation import ExpectedResultsError
from sad_tpu_torch.train import checkpoint as tck
from sad_tpu_torch.train import train_loop as tloop
from test_torch_models import one_torch_thread, random_params, sad_tpu_native_loaded  # noqa: F401

LAB, PL = "torch_loop_lab", "torch_loop_pl"

BASE = {
    "MODEL": {"TYPE": "distillation", "NUM_CLASSES": 9,
              "CONV_BODY": "FPN.add_fpn_ResNet50_conv5_body"},
    "NUM_GPUS": 1,
    "FPN": {"FPN_ON": True, "RPN_MIN_LEVEL": 3, "RPN_MAX_LEVEL": 7,
            "EXTRA_CONV_LEVELS": True, "COARSEST_STRIDE": 128},
    "RETINANET": {"RETINANET_ON": True, "ASPECT_RATIOS": (1.0,), "SCALES_PER_OCTAVE": 1},
    "RESNETS": {"CHANNEL_RATIO": 0.25},
    "DISTILLATION": {"DISTILLATION_ON": True, "UNLABEL_DISTILLATION": True,
                     "UNLABEL_DATASETS": (PL,)},
    "TRAIN": {"SCALES": (64,), "MAX_SIZE": 128, "IMS_PER_BATCH": 2, "DATASETS": (LAB,),
              "SNAPSHOT_ITERS": 3, "WEIGHTS": ""},
    "SOLVER": {"BASE_LR": 1e-4, "MAX_ITER": 6, "WARM_UP_ITERS": 0, "GAMMA": 0.1,
               "LR_POLICY": "steps_with_decay", "STEPS": (0, 3)},
    "DATA_LOADER": {"NUM_THREADS": 2},
    "PIXEL_STD": (57.375, 57.12, 58.395),
    "COMPUTE_DTYPE": "float32",
}
TEACHER = {"RESNETS": {"CHANNEL_RATIO": 0.25},
           "PIXEL_MEANS": (110.0, 115.0, 120.0), "PIXEL_STD": (60.0, 61.0, 62.0)}
RCNN = {
    "MODEL": {"TYPE": "generalized_rcnn", "FASTER_RCNN": True, "NUM_CLASSES": 9,
              "CONV_BODY": "FPN.add_fpn_ResNet50_conv5_body"},
    "DISTILLATION": {"DISTILLATION_ON": False, "UNLABEL_DISTILLATION": False},
    "FPN": {"FPN_ON": True, "MULTILEVEL_RPN": True, "MULTILEVEL_ROIS": True,
            "RPN_MIN_LEVEL": 2, "RPN_MAX_LEVEL": 6, "ROI_MIN_LEVEL": 2, "ROI_MAX_LEVEL": 5,
            "COARSEST_STRIDE": 64},
    "TRAIN": {"SCALES": (64,), "MAX_SIZE": 64, "RPN_PRE_NMS_TOP_N": 32,
              "RPN_POST_NMS_TOP_N": 16, "BATCH_SIZE_PER_IM": 16},
    "FAST_RCNN": {"ROI_XFORM_RESOLUTION": 7, "MLP_HEAD_DIM": 32},
}


def _over(base, extra):
    out = dict(base)
    for k, v in (extra or {}).items():
        out[k] = {**out.get(k, {}), **v} if isinstance(v, dict) else v
    return out


def t_cfg(out_dir, *extras):
    d = dict(BASE, OUTPUT_DIR=str(out_dir))
    for e in extras:
        d = _over(d, e)
    return t_merge(tcfg.Config(), d)


def train_dir(out_dir):
    return os.path.join(str(out_dir), "train", LAB)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("loop_ds"))
    for name, split, seed, n in ((LAB, "lab", 5, 12), (PL, "pl", 6, 10)):
        img_dir, js = generate_synthetic_coco(root, split, n, seed=seed, size_range=(64, 96),
                                              objects_per_image=(1, 3), small_frac=0.0,
                                              crowd_frac=0.0, ignore_frac=0.0)
        jcfg.register_dataset(name, img_dir, js, allow_override=True)
        tcfg.register_dataset(name, img_dir, js, is_pseudo_labeled=name == PL,
                              allow_override=True)
    img_dir, js = generate_synthetic_coco(root, "unl", 6, seed=7, size_range=(64, 96),
                                          labeled=False)
    tcfg.register_dataset("torch_loop_unl", img_dir, js, allow_override=True)
    return root


def _recording_stats(records):
    """TrainingStats logging every iteration to stats.jsonl and keeping the
    raw metrics it is handed, for both packages."""
    def make(base):
        class Recording(base):
            def __init__(self, max_iter, log_file=None):
                super().__init__(max_iter, log_period=1, log_file=log_file)

            def update_iter_stats(self, cur_iter, metrics):
                records.append((cur_iter, dict(metrics)))
                super().update_iter_stats(cur_iter, metrics)
        return Recording
    return make


@pytest.fixture(scope="module")
def sad_tpu_run(data, tmp_path_factory):
    """sad_tpu's train_model once, from native pickles of seeded random
    weights; returns its cfg dicts, weights paths, state and records."""
    root = tmp_path_factory.mktemp("loop_jax")
    jc = j_merge(jcfg.Config(), dict(BASE, OUTPUT_DIR=str(root / "out")))
    jt = j_merge(jc, TEACHER)
    x = np.zeros((1, 128, 128, 3), np.float32)
    paths = {}
    for key, c, seed in (("student", jc, 1), ("teacher", jt, 2)):
        paths[key] = str(root / f"{key}.pkl")
        jck.save_checkpoint(paths[key], random_params(j_create_model(c), x, seed))
    jc = j_merge(jc, {"TRAIN": {"WEIGHTS": paths["student"]}})
    jt = j_merge(jt, {"TRAIN": {"WEIGHTS": paths["teacher"]}})
    records = []
    mp = pytest.MonkeyPatch()
    mp.setattr(jloop, "TrainingStats", _recording_stats(records)(jloop.TrainingStats))
    try:
        state = jloop.train_model(jc, jt, max_iters=4)
    finally:
        mp.undo()
    with open(os.path.join(train_dir(root / "out"), "stats.jsonl")) as f:
        lines = [json.loads(l) for l in f]
    return paths, state, records, lines


def _close_tree(got, ref, what):
    fr = jax.tree_util.tree_flatten_with_path(ref)[0]
    fg = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in fg] == [p for p, _ in fr]
    for (path, r), (_, g) in zip(fr, fg):
        r, g = np.asarray(r), np.asarray(g)
        assert np.abs(g - r).max() <= 1e-4 * np.abs(r).max() + 1e-12, (what, path)


def test_train_model_matches_sad_tpu(sad_tpu_run, tmp_path, monkeypatch):
    paths, jstate, jrecords, jlines = sad_tpu_run
    records = []
    monkeypatch.setattr(tloop, "TrainingStats", _recording_stats(records)(tloop.TrainingStats))
    cfg = t_cfg(tmp_path / "out", {"TRAIN": {"WEIGHTS": paths["student"]},
                                    "DATA_LOADER": {"NUM_PROCESSES": 2}})
    teacher = t_merge(cfg, dict(TEACHER, TRAIN={"WEIGHTS": paths["teacher"]}))
    result = tloop.train_model(cfg, teacher, max_iters=4, device="cpu")

    assert [i for i, _ in records] == [i for i, _ in jrecords] == [0, 1, 2, 3]
    for (_, got), (_, ref) in zip(records, jrecords):
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert abs(got[k] - ref[k]) <= 1e-4 * abs(ref[k]) + 1e-7, (k, got[k], ref[k])
    with open(os.path.join(train_dir(tmp_path / "out"), "stats.jsonl")) as f:
        lines = [json.loads(l) for l in f]
    assert [l["iter"] for l in lines] == [l["iter"] for l in jlines]
    for got, ref in zip(lines, jlines):
        assert got["lr"] == ref["lr"]
        for k, v in ref.items():
            if k in ("iter", "time", "eta", "lr", "queue", "host_rss_mb", "mem_peak_mb"):
                continue
            assert abs(got[k] - v) <= 1e-4 * abs(v) + 1e-6, (k, got[k], v)
    _close_tree(state_dict_to_params(result.model.state_dict()), jstate.params, "params")
    _close_tree(state_dict_to_params(result.state.velocity), jstate.velocity, "velocity")
    assert result.feed_summary()["served"] == ["labeled", "unlabeled"] * 2
    assert result.feed_summary()["workers"] == 2 and len(result.iter_seconds) == 4
    # the port's final snapshot loads in sad_tpu
    ck = jck.load_checkpoint(os.path.join(train_dir(tmp_path / "out"), "model_final.pkl"))
    assert ck["iter"] == 4
    _close_tree(ck["params"], jstate.params, "snapshot params")


def _run_and_resume(tmp_path, extras, teacher=None):
    """Run A uninterrupted (6 iters, snapshot after iter 3), then run B in a
    fresh dir holding only that snapshot; both results, and B's stats."""
    a = tloop.train_model(t_cfg(tmp_path / "a", *extras), teacher, device="cpu")
    snaps = glob.glob(os.path.join(train_dir(tmp_path / "a"), "model_iter*.pkl"))
    assert [os.path.basename(s) for s in snaps] == ["model_iter2.pkl"]
    assert tck.load_checkpoint(snaps[0])["iter"] == 3
    out_b = train_dir(tmp_path / "b")
    os.makedirs(out_b)
    shutil.copy(snaps[0], out_b)
    b = tloop.train_model(t_cfg(tmp_path / "b", *extras), teacher, device="cpu")
    with open(os.path.join(out_b, "stats.jsonl")) as f:
        stats_b = [json.loads(l) for l in f]
    return a, b, stats_b


def _assert_bit_identical(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    for k in a.state.velocity:
        assert torch.equal(a.state.velocity[k], b.state.velocity[k]), k


@pytest.fixture
def deterministic():
    """Deterministic kernels for a bit-for-bit comparison: on the CPU the
    R-CNN step's RoIAlign is the plain gather, whose autograd backward
    (an accumulating index_put) adds in thread order unless asked not to."""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


@pytest.mark.parametrize("family", ["sad", "faster_rcnn"])
def test_resume_is_bit_identical(data, tmp_path, family, deterministic):
    extras = [] if family == "sad" else [RCNN]
    teacher = t_cfg(tmp_path, TEACHER) if family == "sad" else None
    a, b, stats_b = _run_and_resume(tmp_path, extras, teacher)
    assert b.start_iter == 3 and a.start_iter == 0
    # the LR step lands exactly on the resume iteration (STEPS (0, 3)): B must
    # rescale the momentum there as A did
    assert stats_b[-1]["iter"] == 5 and stats_b[-1]["lr"] == pytest.approx(1e-5)
    if family == "sad":
        assert b.feed_summary()["served"] == ["unlabeled", "labeled", "unlabeled"]
    _assert_bit_identical(a, b)

    # a third invocation on B's directory is a no-op
    final = os.path.join(train_dir(tmp_path / "b"), "model_final.pkl")
    mtime = os.path.getmtime(final)
    c = tloop.train_model(t_cfg(tmp_path / "b", *extras), teacher, device="cpu")
    assert c.start_iter == 6 and c.iter_seconds == [] and os.path.getmtime(final) == mtime
    _assert_bit_identical(a, c)


def test_nan_loss_aborts_with_a_snapshot(data, tmp_path):
    cfg = t_cfg(tmp_path / "nan", {"SOLVER": {"BASE_LR": 1e30, "LR_POLICY": "step"},
                                    "DISTILLATION": {"UNLABEL_DISTILLATION": False}})
    with pytest.raises(FloatingPointError, match="Loss is"):
        tloop.train_model(cfg, t_cfg(tmp_path, TEACHER), device="cpu")
    path = os.path.join(train_dir(tmp_path / "nan"), "model_nan_abort.pkl")
    ck = tck.load_checkpoint(path)
    assert 0 < ck["iter"] < 6
    assert not os.path.exists(os.path.join(train_dir(tmp_path / "nan"), "model_final.pkl"))


def test_train_net_cli_on_pseudo_labels(data, tmp_path):
    """The semi-supervised flow: the teacher pseudo-labels an unlabeled
    split, the result is registered and trained as the unlabeled stream
    through train_net."""
    from sad_tpu_torch.config import register_dataset
    from sad_tpu_torch.data.dataset import combined_roidb_for_training
    from sad_tpu_torch.eval.test_engine import generate_pseudo_labels
    from sad_tpu_torch.models import create_model
    from sad_tpu_torch.tools import train_net

    teacher_cfg = t_cfg(tmp_path, TEACHER, {"TEST": {"SCALES": (64,), "MAX_SIZE": 128}})
    teacher = create_model(teacher_cfg, "cpu", torch.Generator().manual_seed(0))
    pl_json = generate_pseudo_labels(teacher_cfg, teacher, "torch_loop_unl",
                                     str(tmp_path / "pseudo.json"), score_thresh=0.0,
                                     batch_size=4)
    with open(pl_json) as f:
        doc = json.load(f)
    assert doc["annotations"] and len(doc["images"]) == 6
    spec = tcfg.get_dataset_spec("torch_loop_unl")
    register_dataset("torch_loop_pseudo", spec.image_directory, pl_json, is_pseudo_labeled=True,
                     allow_override=True)
    with_box = {a["image_id"] for a in doc["annotations"]}
    assert len(combined_roidb_for_training(["torch_loop_pseudo"], True)) == 2 * len(with_box)

    ycfg, yteacher = str(tmp_path / "student.yaml"), str(tmp_path / "teacher.yaml")
    with open(ycfg, "w") as f:
        f.write(cfg_to_yaml(t_cfg(tmp_path / "cli")))
    with open(yteacher, "w") as f:
        f.write(cfg_to_yaml(teacher_cfg))
    opts = ["OUTPUT_DIR", str(tmp_path / "cli"), "SOLVER.MAX_ITER", "4",
            "DISTILLATION.UNLABEL_DATASETS", "('torch_loop_pseudo',)"]
    result = train_net.main(["--cfg", ycfg, "--teacher_cfg", yteacher, "--skip-test",
                             "--device", "cpu"] + opts)
    run = train_dir(tmp_path / "cli")
    assert sorted(os.listdir(run)) == ["cfg.yaml", "model_final.pkl", "model_iter2.pkl",
                                       "stats.jsonl"]
    assert result.feed_summary()["served"] == ["labeled", "unlabeled"] * 2
    with open(os.path.join(run, "stats.jsonl")) as f:
        assert all(np.isfinite(json.loads(l)["loss"]) for l in f)

    # without --skip-test: the finished run resumes as a no-op, then the
    # student is evaluated on TEST.DATASETS and held to EXPECTED_RESULTS
    test_opts = opts + ["TEST.DATASETS", f"('{LAB}',)", "TEST.SCALES", "(64,)",
                        "TEST.MAX_SIZE", "128"]
    evaluated = train_net.main(["--cfg", ycfg, "--teacher_cfg", yteacher, "--device", "cpu"]
                               + test_opts)
    assert evaluated.start_iter == 4 and evaluated.iter_seconds == []
    test_dir = os.path.join(str(tmp_path / "cli"), "test", LAB)
    with open(os.path.join(test_dir, "results.json")) as f:
        results = json.load(f)
    assert len(results) == 12 and all(np.isfinite(v) for v in results.values())
    assert os.path.exists(os.path.join(test_dir, "bbox_results.json"))
    with pytest.raises(ExpectedResultsError, match="AP"):
        train_net.main(["--cfg", ycfg, "--teacher_cfg", yteacher, "--device", "cpu"] + test_opts
                       + ["EXPECTED_RESULTS", f"(('{LAB}', 'box', 'AP', 0.99),)",
                          "EXPECTED_RESULTS_RTOL", "0.0", "EXPECTED_RESULTS_ATOL", "0.0"])
    with pytest.raises(SystemExit) as info:
        train_net.main(["--cfg", ycfg, "--skip-test", "--device", "cpu"] + opts)
    assert info.value.code == 1
