"""R-CNN loss groups that span ranks, in the port on the CPU: gloo ranks, each
a process that imports no jax (``profile_spatial.rank_jobs``); a module
fixture's worlds end within 200 s together, so that a hung collective fails
the test and does not hold the run.

- One step of three R-CNN models at float32 (the tiny sizes of
  tests/test_torch_rcnn_train.py, tests/test_torch_keypoint_rcnn.py and
  tests/test_torch_single_scale_train.py): Mask R-CNN R-50-FPN (the
  architecture of __graft_entry__.dryrun_multichip's phase 3), Keypoint
  R-CNN, and the single-scale C4 step with TRAIN.OHEM; each in two layouts,
  G = 2 over 4 ranks as 2 nodes (4 images, one a rank: every group spans
  the two ranks of a node) and G = 3 with 6 images over 2 ranks (the middle
  group split), two steps from the same weights and batch, the first with
  sad_tpu's sampler draws, the second with the run's generator:
  - the global per-group counts (box, live, mask, visible keypoints) equal
    one process's exactly after each step, and every rank's sampler
    generator is in one process's state;
  - against one process: metrics within 1e-5 relative, the worst parameter
    tensor within 1e-5 relative L2, every momentum tensor's L2 difference
    within 1e-4 of its own norm plus 1e-8 of the largest tensor's, below
    float32's rounding (Keypoint R-CNN's heatmap-logit bias has an exact
    gradient of 0, since each heatmap's softmax gradient sums to 0 over its
    cells: its momentum, ~4e-10 of the largest, is rounding alone);
    parameters and momenta bit-equal across the ranks;
  - against sad_tpu's jitted ``make_rcnn_train_step(n_groups=G)`` on the
    whole batch after the first step: metrics within 1e-4 relative (+1e-6),
    each parameter tensor within 1e-4 of its largest magnitude, each
    momentum within 2e-3 of its largest (the bound of
    tests/test_torch_rcnn_train.py).
- ``train_net`` over 4 ranks as 2 nodes with NUM_GPUS = 2 (4 images, one a
  rank) on a tiny Mask R-CNN R-50-FPN, 3 iterations with a snapshot after
  iteration 1: only rank 0's files, the ranks bit-equal and within 1e-5
  relative L2 of a one-process run, the first step's per-group counts equal
  to one process's exactly, a 4-rank run resumed in a fresh directory from
  model_iter1.pkl bit-equal to the uninterrupted one.
"""

import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sad_tpu.config as jcfg
import sad_tpu_torch.config as tcfg
from sad_tpu.config.config import merge_cfg_from_dict as j_merge
from sad_tpu.models import create_model as j_create_model
from sad_tpu.train.optimizer import init_momentum_state
from sad_tpu.train.rcnn_train import make_rcnn_train_step as j_make_rcnn_train_step
from sad_tpu.train.train_step import TrainState as JTrainState
from sad_tpu_torch.config.config import cfg_to_yaml
from sad_tpu_torch.config.config import merge_cfg_from_dict as t_merge
from sad_tpu_torch.convert import load_params, state_dict_to_params
from sad_tpu_torch.data.synth_coco import generate_synthetic_coco
from sad_tpu_torch.models import GeneralizedRCNN, SingleScaleRCNN
from sad_tpu_torch.parallel.launch import spawn
from sad_tpu_torch.tools import profile_ddp, profile_spatial, train_net
from sad_tpu_torch.tools.profile_train import SeededRCNNTrainStep
from sad_tpu_torch.train import TrainState, batch_to_torch, make_rcnn_train_step
from test_torch_keypoint_rcnn import KRCNN
from test_torch_models import one_torch_thread  # noqa: F401  (autouse)
from test_torch_rcnn import rcnn_params
from test_torch_rcnn_train import TINY, _tree_items, jax_uniforms, make_batch
from test_torch_single_scale import ss_over
from test_torch_train_loop import BASE, RCNN, _over

LR, STEPS = 1e-2, 2
TIMEOUT_S = 200.0  # the module's worlds together
OHEM = {"OHEM": True, "OHEM_ROI_PER_IMG": 5}
MODELS = {
    "mask_fpn": dict(TINY, MODEL=dict(TINY["MODEL"], MASK_ON=True)),
    "keypoint": dict(TINY, MODEL=dict(TINY["MODEL"], NUM_CLASSES=2, KEYPOINTS_ON=True),
                     KRCNN=dict(KRCNN, MIN_KEYPOINT_COUNT_FOR_VALID_MINIBATCH=4)),
    "c4_ohem": ss_over(TRAIN=OHEM),
}
# (images, groups, ranks, nodes)
LAYOUTS = {"g2_w4": (4, 2, 4, 2), "g3_w2": (6, 3, 2, 1)}
CASES = [(m, lay) for lay in LAYOUTS for m in MODELS]
LAB = "torch_span_lab"
LOOP = {"NUM_GPUS": 2, "MODEL": {"MASK_ON": True},
        "TRAIN": {"DATASETS": (LAB,), "SNAPSHOT_ITERS": 4, "IMS_PER_BATCH": 2},
        "MRCNN": {"DIM_REDUCED": 8, "RESOLUTION": 14, "ROI_XFORM_RESOLUTION": 7},
        "SOLVER": {"MAX_ITER": 3}}


def _batch(name, jc, images):
    """make_batch's images, gt boxes and RPN targets (and rasters for the
    mask model); gt keypoints for the keypoint model."""
    batch = make_batch(jc, b=images, seed=images, mask=name == "mask_fpn")
    if name == "keypoint":
        batch["gt_classes"] = np.minimum(batch["gt_classes"], 1)
        rng = np.random.RandomState(7)
        g = batch["gt_boxes"]
        u = rng.uniform(0, 1, g.shape[:2] + (17, 2))
        kp = np.zeros(g.shape[:2] + (17, 3), np.float32)
        kp[..., :2] = g[:, :, None, :2] + u * (g[:, :, None, 2:] - g[:, :, None, :2])
        kp[..., 2] = (rng.rand(*g.shape[:2], 17) < 0.8) * 2.0
        batch["gt_keypoints"] = kp
    return batch


def _case(name, layout, tmp):
    """The case's port run (saved for the ranks, the sampler's draws of the
    first step sad_tpu's) and sad_tpu's jitted step on the whole batch."""
    images, groups, _, _ = LAYOUTS[layout]
    over = dict(MODELS[name], NUM_GPUS=groups)
    jc, tc = j_merge(jcfg.Config(), over), t_merge(tcfg.Config(), over)
    jmodel = j_create_model(jc)
    params = rcnn_params(jmodel, seed=21, hw=(64, 64))
    batch = _batch(name, jc, images)
    key = jax.random.PRNGKey(3)
    model = load_params((SingleScaleRCNN if name == "c4_ohem" else GeneralizedRCNN)(tc), params)
    step = make_rcnn_train_step(tc, model, n_groups=groups,
                                generator=torch.Generator().manual_seed(11))
    run = SeededRCNNTrainStep(tc, model, step, TrainState.create(model),
                              batch_to_torch(batch, "cpu"), images)
    p = tc.TRAIN.RPN_POST_NMS_TOP_N + batch["gt_boxes"].shape[1]
    run.uniforms = [jax_uniforms(key, images, p)]
    path = str(tmp / f"{name}_{layout}.pt")
    torch.save(run, path)
    jstate = JTrainState(params, init_momentum_state(params).velocity)
    jstep = jax.jit(j_make_rcnn_train_step(jc, jmodel, n_groups=groups))
    return path, (jstate, jstep, jax.tree_util.tree_map(jnp.asarray, batch), key)


def _jax_step(ref):
    jstate, jstep, jbatch, key = ref
    new_state, metrics = jstep(jstate, jbatch, jnp.float32(LR), key)
    return ({k: float(v) for k, v in metrics.items()},
            dict(_tree_items(jax.tree_util.tree_map(np.asarray, new_state.params))),
            dict(_tree_items(jax.tree_util.tree_map(np.asarray, new_state.velocity))))


def _argv(tmp, out):
    return ["--cfg", str(tmp / "mask.yaml"), "--skip-test", "--device", "cpu",
            "OUTPUT_DIR", str(out)]


def _train_dir(out):
    return os.path.join(str(out), "train", LAB)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The worlds (4 ranks as 2 nodes: the G = 2 cases, train_net and its
    resume; 2 ranks: the G = 3 cases), one process's steps and train_net,
    and sad_tpu's steps, side by side."""
    deadline = time.monotonic() + TIMEOUT_S
    tmp = tmp_path_factory.mktemp("rcnn_span")
    img_dir, js = generate_synthetic_coco(str(tmp), "lab", 10, seed=21, size_range=(64, 96),
                                          objects_per_image=(1, 3), small_frac=0.0,
                                          crowd_frac=0.0, ignore_frac=0.0)
    tcfg.register_dataset(LAB, img_dir, js, allow_override=True)
    regs = [(LAB, img_dir, js, False)]
    with open(tmp / "mask.yaml", "w") as f:
        f.write(cfg_to_yaml(t_merge(tcfg.Config(), _over(_over(BASE, RCNN), LOOP))))
    cases = {c: _case(*c, tmp) for c in CASES}

    def steps_job(path):
        return ("rank_steps", {"build": profile_ddp.load_run, "build_kwargs": {"path": path},
                               "steps": STEPS, "lr": LR, "mesh": True})

    def world(layout, jobs):
        _, _, ranks, nodes = LAYOUTS[layout]
        return spawn(profile_spatial.rank_jobs, ranks, (jobs,), device="cpu", nodes=nodes,
                     timeout_s=deadline - time.monotonic(), threads=1)

    # train_net, then in the same world (rank 0 having copied its snapshot into a fresh
    # directory) the resumed run
    four_jobs = [steps_job(cases[(m, "g2_w4")][0]) for m in MODELS] + [
        ("cli", {"tool": "train_net", "argv": _argv(tmp, tmp / "whole"), "datasets": regs}),
        ("cli", {"tool": "train_net", "argv": _argv(tmp, tmp / "resumed"), "datasets": regs,
                 "seed_files": [(os.path.join(_train_dir(tmp / "whole"), "model_iter1.pkl"),
                                 _train_dir(tmp / "resumed"))]})]

    with ThreadPoolExecutor(4) as pool:
        four = pool.submit(world, "g2_w4", four_jobs)
        two = pool.submit(world, "g3_w2", [steps_job(cases[(m, "g3_w2")][0]) for m in MODELS])
        # XLA compiles without the GIL: sad_tpu's steps, a layout a thread, beside this
        # process's
        jax_f = [pool.submit(lambda lay=lay: {c: _jax_step(cases[c][1]) for c in CASES
                                              if c[1] == lay}) for lay in LAYOUTS]
        one = {c: profile_ddp.rank_steps(profile_ddp.load_run, {"path": cases[c][0]}, STEPS, LR)
               for c in CASES}
        loop_one = train_net.main(_argv(tmp, tmp / "one"))
        jax_refs = {k: v for f in jax_f for k, v in f.result().items()}
        four_out = four.result()
        two_out = two.result()
    ranks = {}
    for i, m in enumerate(MODELS):
        ranks[(m, "g2_w4")] = [r[i] for r in four_out]
        ranks[(m, "g3_w2")] = [r[i] for r in two_out]
    return {"ranks": ranks, "one": one, "jax": jax_refs, "tmp": tmp,
            "loop": [r[len(MODELS)] for r in four_out],
            "resumed": [r[len(MODELS) + 1] for r in four_out], "loop_one": loop_one}


@pytest.mark.parametrize("name,layout", CASES)
def test_span_counts_are_one_process_counts(runs, name, layout):
    images, groups, world, _ = LAYOUTS[layout]
    ranks, one = runs["ranks"][(name, layout)], runs["one"][(name, layout)]
    assert [r["n_images"] for r in ranks] == [images // world] * world
    want = {"box", "live"} | ({"mask"} if name == "mask_fpn" else set()) | (
        {"kps"} if name == "keypoint" else set())
    for step in range(STEPS):
        assert set(one["counts"][step]) == want
        for r in ranks:
            for k, v in one["counts"][step].items():
                assert v.shape == (groups,)
                np.testing.assert_array_equal(r["counts"][step][k], v, err_msg=f"{k} {step}")
    assert one["counts"][0]["live"].sum() > 0
    res = profile_ddp.compare(one, ranks)
    assert len(one["generator"]) == STEPS and not res["generator_unequal"]


@pytest.mark.parametrize("name,layout", CASES)
def test_span_step_matches_one_process(runs, name, layout):
    ranks, one = runs["ranks"][(name, layout)], runs["one"][(name, layout)]
    assert all(r["backend"] == "gloo" for r in ranks)
    assert {r["reduction_transport"] for r in ranks} == {
        "gloo two-level" if LAYOUTS[layout][3] > 1 else "flat"}
    res = profile_ddp.compare(one, ranks)
    assert res["metric_rel"] <= 1e-5, (res["metric_key"], res["metric_rel"])
    assert res["param_rel_l2"] <= 1e-5, (res["param_key"], res["param_rel_l2"])
    for step in range(STEPS):
        want, got = one["trees"][step]["velocity"], ranks[0]["trees"][step]["velocity"]
        norms = {k: float(np.linalg.norm(v.astype(np.float64))) for k, v in want.items()}
        floor = 1e-8 * max(norms.values())
        for k, v in want.items():
            diff = float(np.linalg.norm(got[k].astype(np.float64) - v))
            assert diff <= 1e-4 * norms[k] + floor, (step, k, diff, norms[k], floor)
    assert not res["unequal_across_ranks"], res["unequal_across_ranks"][:3]
    m = one["metrics"][0]
    assert ("loss_mask" in m) == (name == "mask_fpn") and ("loss_kps" in m) == (name == "keypoint")


@pytest.mark.parametrize("name,layout", CASES)
def test_span_step_matches_sad_tpu(runs, name, layout):
    ref, new_ref, vel_ref = runs["jax"][(name, layout)]
    got = runs["ranks"][(name, layout)][0]
    m = got["metrics"][0]
    assert sorted(m) == sorted(ref)
    for k, v in ref.items():
        assert abs(m[k] - v) <= 1e-4 * abs(v) + 1e-6, (k, m[k], v)
    tree = got["trees"][0]
    new_got = dict(_tree_items(state_dict_to_params(
        {k: torch.from_numpy(v) for k, v in tree["params"].items()})))
    vel_got = dict(_tree_items(state_dict_to_params(
        {k: torch.from_numpy(v) for k, v in tree["velocity"].items()})))
    assert sorted(new_got) == sorted(new_ref) and sorted(vel_got) == sorted(vel_ref)
    for k, r in new_ref.items():
        assert np.abs(new_got[k] - r).max() <= 1e-4 * np.abs(r).max() + 1e-12, k
        assert np.abs(vel_got[k] - vel_ref[k]).max() <= 2e-3 * np.abs(vel_ref[k]).max() + 1e-8, k


def test_mask_rcnn_train_net_over_two_nodes_matches_one_process(runs):
    tmp, loop, one = runs["tmp"], runs["loop"], runs["loop_one"]
    files = sorted(os.listdir(_train_dir(tmp / "whole")))
    assert files == ["cfg.yaml", "model_final.pkl", "model_iter1.pkl", "stats.jsonl"]
    with open(os.path.join(_train_dir(tmp / "whole"), "stats.jsonl")) as f:
        lines = [json.loads(ln) for ln in f]
    assert [ln["iter"] for ln in lines] == [0, 2]
    assert all(np.isfinite(ln["loss"]) and ln["loss_mask"] > 0 for ln in lines)
    assert [(r["rank"], r["start_iter"], r["iters"]) for r in loop] == [(r, 0, 3) for r in range(4)]
    for r in loop[1:]:
        for tree in ("params", "velocity"):
            for k, v in loop[0][tree].items():
                assert np.array_equal(r[tree][k], v), (r["rank"], tree, k)
    ref = {n: p.detach().numpy() for n, p in one.model.named_parameters()}
    worst = max(profile_ddp.rel_l2(loop[0]["params"][k], v) for k, v in ref.items())
    assert worst <= 1e-5, worst
    # the first step's per-group counts: one process's, exactly, on every rank
    want = {k: v.numpy() for k, v in one.first_counts.items()}
    assert sorted(want) == ["box", "live", "mask"] and want["live"].shape == (2,)
    for r in loop:
        assert sorted(r["first_counts"]) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(r["first_counts"][k], v, err_msg=k)


def test_mask_rcnn_train_net_over_two_nodes_resumes_bit_identically(runs):
    loop, resumed = runs["loop"], runs["resumed"]
    assert [(r["start_iter"], r["iters"]) for r in resumed] == [(2, 1)] * 4
    for a, b in zip(loop, resumed):
        for tree in ("params", "velocity"):
            for k, v in a[tree].items():
                assert np.array_equal(b[tree][k], v), (a["rank"], tree, k)
