"""The port's training and evaluation entry points over W = 2 ranks on the
CPU (gloo, a ``file://`` store, ``parallel.launch.spawn``; a module
fixture's worlds end within 110 s together or fail), on the tiny configuration of tests/test_torch_train_loop.py
with NUM_GPUS 2 (one loss group a rank) and a synthetic COCO the port
writes; every rank registers the splits itself.

- train_net: 3 iterations of the joint SAD step over a labeled and a
  pseudo-labeled stream, a snapshot after iteration 1: only rank 0's files
  (cfg.yaml, one stats.jsonl series, model_iter1.pkl, model_final.pkl), the
  ranks' final parameters and momenta bit-equal, and within 1e-5 relative L2
  (the worst tensor) of a one-process run; a 2-rank run resumed in a fresh
  directory from model_iter1.pkl ends bit-identical to the uninterrupted
  2-rank run, then evaluates on the val split sharded over its 2 ranks
  (no --skip-test and no --multi-gpu-testing: under torchrun the
  evaluation is always sharded, so no rank waits while another serves the
  whole split); a NaN loss aborts both ranks at the same iteration, and rank 0
  writes model_nan_abort.pkl.
- test_net --multi-gpu-testing over a val split of landscape and portrait
  images with --range 1 7 (the ranks' shards of the range), and with
  --pseudo-out over the whole split: the merged bbox_results.json and
  pseudo.json hold the one-process detections in the one-process order
  (image, category and annotation id equal; scores within 1e-5 and boxes
  within 1e-4 px: a rank batches other images beside each one).

Each world is spawned once a module; the cases read its outputs.
"""

import json
import os
import shutil
import time

import numpy as np
import pytest

import sad_tpu.config as jcfg
import sad_tpu_torch.config as tcfg
from sad_tpu.config.config import merge_cfg_from_dict as j_merge
from sad_tpu.models import create_model as j_create_model
from sad_tpu_torch.config.config import cfg_to_yaml
from sad_tpu_torch.config.config import merge_cfg_from_dict as t_merge
from sad_tpu_torch.convert import load_params
from sad_tpu_torch.data.synth_coco import generate_synthetic_coco
from sad_tpu_torch.models import create_model
from sad_tpu_torch.parallel.launch import spawn
from sad_tpu_torch.tools import profile_ddp, test_net, train_net
from sad_tpu_torch.train import checkpoint as tck
from test_torch_models import one_torch_thread, random_params  # noqa: F401
from test_torch_train_loop import BASE, TEACHER, _over

W = 2
TIMEOUT_S = 110.0  # a module fixture's worlds together
LAB, PL, VAL = "torch_ddp_lab", "torch_ddp_pl", "torch_ddp_val"
LOOP = {"NUM_GPUS": 2, "TRAIN": {"DATASETS": (LAB,), "SNAPSHOT_ITERS": 4},
        "SOLVER": {"MAX_ITER": 3},
        "DISTILLATION": {"UNLABEL_DATASETS": (PL,)},
        "TEST": {"SCALES": (64,), "MAX_SIZE": 128, "DATASETS": (VAL,)}}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The splits, registered here and handed to every rank."""
    root = str(tmp_path_factory.mktemp("ddp_loop_ds"))
    regs = []
    for name, split, seed, n, size in ((LAB, "lab", 5, 12, (64, 96)), (PL, "pl", 6, 10, (64, 96)),
                                       (VAL, "val", 8, 7, (80, 160))):
        img_dir, js = generate_synthetic_coco(root, split, n, seed=seed, size_range=size,
                                              objects_per_image=(1, 3), small_frac=0.0,
                                              crowd_frac=0.0, ignore_frac=0.0)
        tcfg.register_dataset(name, img_dir, js, is_pseudo_labeled=name == PL,
                              allow_override=True)
        regs.append((name, img_dir, js, name == PL))
    return root, regs


def _yaml(path, *extras):
    d = _over(BASE, LOOP)
    for e in extras:
        d = _over(d, e)
    with open(path, "w") as f:
        f.write(cfg_to_yaml(t_merge(tcfg.Config(), d)))
    return str(path)


def _train_dir(out):
    return os.path.join(str(out), "train", LAB)


def _argv(root, out, test=False):
    return (["--cfg", str(root / "student.yaml"), "--teacher_cfg", str(root / "teacher.yaml")]
            + ([] if test else ["--skip-test"]) + ["--device", "cpu", "OUTPUT_DIR", str(out)])


def _ranks(tool, argv, regs, deadline, nan_abort_ok=False):
    return spawn(profile_ddp.rank_cli, W, (tool, argv, regs, False, nan_abort_ok), device="cpu",
                 timeout_s=deadline - time.monotonic(), threads=1)


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    """An uninterrupted 2-rank run, a 2-rank run resumed from its snapshot in
    a fresh directory, and a one-process run of the same configuration."""
    _, regs = data
    deadline = time.monotonic() + TIMEOUT_S
    root = tmp_path_factory.mktemp("ddp_loop")
    _yaml(root / "student.yaml")
    _yaml(root / "teacher.yaml", TEACHER)
    whole = _ranks("train_net", _argv(root, root / "whole"), regs, deadline)
    os.makedirs(_train_dir(root / "resumed"))
    shutil.copy(os.path.join(_train_dir(root / "whole"), "model_iter1.pkl"),
                _train_dir(root / "resumed"))
    resumed = _ranks("train_net", _argv(root, root / "resumed", test=True), regs, deadline)
    one = train_net.main(_argv(root, root / "one"))
    return root, whole, resumed, one


def test_only_rank_zero_writes_the_run_files(runs):
    root, whole, _, _ = runs
    files = sorted(os.listdir(_train_dir(root / "whole")))
    assert files == ["cfg.yaml", "model_final.pkl", "model_iter1.pkl", "stats.jsonl"]
    with open(os.path.join(_train_dir(root / "whole"), "stats.jsonl")) as f:
        lines = [json.loads(ln) for ln in f]
    assert [ln["iter"] for ln in lines] == [0, 2]  # one series, not one a rank
    assert all(np.isfinite(ln["loss"]) for ln in lines)
    assert tck.load_checkpoint(os.path.join(_train_dir(root / "whole"),
                                            "model_iter1.pkl"))["iter"] == 2
    assert [(r["rank"], r["start_iter"], r["iters"]) for r in whole] == [(0, 0, 3), (1, 0, 3)]


def test_two_ranks_hold_the_same_state_as_one_process(runs):
    _, whole, _, one = runs
    for tree in ("params", "velocity"):
        for k, v in whole[0][tree].items():
            assert np.array_equal(whole[1][tree][k], v), (tree, k)
    ref = {"params": {n: p.detach().numpy() for n, p in one.model.named_parameters()},
           "velocity": {n: v.numpy() for n, v in one.state.velocity.items()}}
    worst = max(profile_ddp.rel_l2(whole[0]["params"][k], v) for k, v in ref["params"].items())
    assert worst <= 1e-5, worst
    assert any(np.any(v != 0) for v in whole[0]["velocity"].values())


def test_two_rank_resume_is_bit_identical(runs):
    _, whole, resumed, _ = runs
    assert [(r["start_iter"], r["iters"]) for r in resumed] == [(2, 1), (2, 1)]
    for a, b in zip(whole, resumed):
        for tree in ("params", "velocity"):
            assert sorted(a[tree]) == sorted(b[tree])
            for k, v in a[tree].items():
                assert np.array_equal(b[tree][k], v), (a["rank"], tree, k)


def test_train_net_evaluates_sharded_over_the_ranks(runs):
    root, _, resumed, _ = runs
    assert len(resumed) == W
    found = {}
    for d, _, names in os.walk(root / "resumed" / "test"):
        found.update({n: os.path.join(d, n) for n in names})
    assert {"bbox_results.json", "timing.json"} <= set(found), sorted(found)
    with open(found["timing.json"]) as f:
        timing = json.load(f)
    assert timing["ranks"] == W and timing["images"] == 7


def test_nan_loss_aborts_every_rank(data, tmp_path):
    _, regs = data
    _yaml(tmp_path / "student.yaml", {"SOLVER": {"BASE_LR": 1e30, "LR_POLICY": "step"},
                                      "DISTILLATION": {"UNLABEL_DISTILLATION": False}})
    _yaml(tmp_path / "teacher.yaml", TEACHER)
    out = _ranks("train_net", _argv(tmp_path, tmp_path / "nan"), regs,
                 time.monotonic() + TIMEOUT_S, nan_abort_ok=True)
    msgs = [r.get("nan_abort") for r in out]
    assert all(m and m.startswith("Loss is") for m in msgs) and msgs[0] == msgs[1]
    files = os.listdir(_train_dir(tmp_path / "nan"))
    assert "model_nan_abort.pkl" in files and "model_final.pkl" not in files
    ck = tck.load_checkpoint(os.path.join(_train_dir(tmp_path / "nan"), "model_nan_abort.pkl"))
    assert f"at iter {ck['iter']}" in msgs[0]


# --------------------------------------------------------------------------- #
# test_net over the ranks
# --------------------------------------------------------------------------- #

RETINA = {
    "MODEL": {"TYPE": "retinanet", "NUM_CLASSES": 9,
              "CONV_BODY": "FPN.add_fpn_ResNet50_conv5_body"},
    "RESNETS": {"CHANNEL_RATIO": 0.0625},
    "FPN": {"FPN_ON": True, "RPN_MIN_LEVEL": 3, "RPN_MAX_LEVEL": 7,
            "EXTRA_CONV_LEVELS": True, "COARSEST_STRIDE": 128},
    "RETINANET": {"RETINANET_ON": True},
    "TEST": {"SCALES": (64,), "MAX_SIZE": 128, "DATASETS": (VAL,)},
    "PIXEL_STD": (57.375, 57.12, 58.395),
    "COMPUTE_DTYPE": "float32",
}


@pytest.fixture(scope="module")
def served(data, tmp_path_factory):
    """test_net over 2 ranks and in one process, on --range 1 7 and with
    --pseudo-out over the whole split, from one saved set of weights."""
    _, regs = data
    deadline = time.monotonic() + TIMEOUT_S
    root = tmp_path_factory.mktemp("ddp_test_net")
    cfg = t_merge(tcfg.Config(), RETINA)
    params = random_params(j_create_model(j_merge(jcfg.Config(), RETINA)),
                           np.zeros((1, 128, 128, 3), np.float32), seed=3)
    pkl = str(root / "model.pkl")
    tck.save_checkpoint(pkl, load_params(create_model(cfg, "cpu"), params))
    with open(root / "cfg.yaml", "w") as f:
        f.write(cfg_to_yaml(cfg))
    common = ["--cfg", str(root / "cfg.yaml"), "--weights", pkl, "--device", "cpu",
              "--batch-size", "2"]
    out = {}
    for key, extra in (("eval", ["--range", "1", "7"]),
                       ("pseudo", ["--pseudo-out", str(root / "{}" / "pseudo.json"),
                                   "--pseudo-score-thresh", "0.0"])):
        for n in (1, W):
            d = root / f"{key}{n}"
            argv = common + [a.format(f"{key}{n}") for a in extra]
            if n == 1:
                test_net.main(argv + ["OUTPUT_DIR", str(d)])
            else:
                _ranks("test_net", argv + ["--multi-gpu-testing", "OUTPUT_DIR", str(d)], regs,
                       deadline)
            out[(key, n)] = d
    return root, out


def _read(path):
    with open(path) as f:
        return json.load(f)


def _same_detections(got, want):
    assert len(got) == len(want) > 10
    for a, b in zip(got, want):
        assert (a["image_id"], a["category_id"]) == (b["image_id"], b["category_id"])
        assert abs(a["score"] - b["score"]) <= 1e-5
        np.testing.assert_allclose(a["bbox"], b["bbox"], rtol=0, atol=1e-4)


def test_sharded_test_net_merges_in_the_one_process_order(served):
    _, out = served
    sub = os.path.join("test", VAL)
    got = _read(os.path.join(out[("eval", W)], sub, "bbox_results.json"))
    want = _read(os.path.join(out[("eval", 1)], sub, "bbox_results.json"))
    _same_detections(got, want)
    assert len({d["image_id"] for d in want}) == 6  # --range 1 7
    timing = _read(os.path.join(out[("eval", W)], sub, "timing.json"))
    assert timing["ranks"] == W and timing["rank_images"] == [3, 3] and timing["images"] == 6
    res_got = _read(os.path.join(out[("eval", W)], sub, "results.json"))
    res_want = _read(os.path.join(out[("eval", 1)], sub, "results.json"))
    assert sorted(res_got) == sorted(res_want)
    for k, v in res_want.items():
        assert abs(res_got[k] - v) <= 1e-6, k


def test_sharded_pseudo_labels_equal_one_process(served):
    root, out = served
    got = _read(root / f"pseudo{W}" / "pseudo.json")
    want = _read(root / "pseudo1" / "pseudo.json")
    assert got["images"] == want["images"] and got["categories"] == want["categories"]
    assert [a["id"] for a in got["annotations"]] == [a["id"] for a in want["annotations"]]
    _same_detections(got["annotations"], want["annotations"])
    # the split holds both orientations: the merge had to restore the order
    orient = {im["id"]: im["width"] >= im["height"] for im in want["images"]}
    assert len(set(orient.values())) == 2
