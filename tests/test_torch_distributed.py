"""Data parallelism of the port on the CPU: W = 2 ranks over gloo, each a
process of its own that imports no jax (``parallel.launch.spawn`` checks),
meeting through a ``file://`` store in a fresh temporary directory; a
module fixture's worlds end within 110 s together, so that a hung
collective fails the test and does not hold the run.

- The joint SAD step (the tiny ResNet-FPN student and teacher of
  tests/test_torch_train_step.py, float32, 128x128, bs 8, G = 4) on two
  ranks of G / W = 2 groups against one process of 4 groups, two steps from
  the same weights and batch (a run the test saves, ``profile_ddp.load_run``):
  every metric within 1e-5 relative, every parameter tensor within 1e-5
  relative L2 (the worst one) and every momentum tensor within 1e-4 (a bias
  gradient sums many terms that cancel); the parameters and momenta
  bit-equal across the ranks; no cls-loss kernel launch on the CPU (the
  plain twin). The same two steps against sad_tpu's jitted step over a
  2-device 'data' mesh (create_mesh(n_data=2) + shard_batch_tree) from the
  same weights and batch, at the rule of tests/test_torch_train_step.py:
  metrics within 1e-4 relative, each leaf within 1e-4 * max|ref|.
- The Faster and Mask R-CNN steps the same way (1e-5), at full depth and a
  sixteenth of the width (tools/profile_train.seeded_rcnn_train_step, 3
  classes so that the box head's accuracy is not 0), where each rank draws
  the sampler's global (B, P + G) priorities and takes its rows: every
  rank's sampler generator in the one process's state after each step, and
  ``compare(held=1)`` reporting step 2 beside step 1.
- ``profile_ddp.local_steps`` (two halves of the batch in one process, no
  process group) against the ranks, and ``cudnn_witness``'s readings on the
  CPU (no cuDNN there: all within 1e-5, a repeat bit-equal).
- The loaders: the ranks' blocks of TrainingLoader's and
  MultiprocessTrainingLoader's batches, concatenated, equal the one-rank
  batches array for array (fg_num included), both streams, after a
  fast-forward; for the R-CNN builder too, whose RPN label sampling replays
  the earlier images' draws.
- check_group_layout, shard_rows and a named backend that is missing raise.

Each world is spawned once a module; the cases read its outputs.
"""

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import sad_tpu.config as jcfg
from sad_tpu.config.config import merge_cfg_from_dict as j_merge
from sad_tpu.models import RetinaNet as JaxRetinaNet
from sad_tpu.parallel import create_mesh, shard_batch_tree
from sad_tpu.parallel.mesh import replicated_sharding
from sad_tpu.train import TrainState as JTrainState
from sad_tpu.train import init_momentum_state
from sad_tpu.train import make_train_step as j_make_train_step
import sad_tpu_torch.config as tcfg
from sad_tpu_torch.config.config import merge_cfg_from_dict as t_merge
from sad_tpu_torch.convert import load_params, state_dict_to_params
from sad_tpu_torch.data import loader as tloader
from sad_tpu_torch.data.dataset import combined_roidb_for_training as t_roidb
from sad_tpu_torch.data.mp_loader import MultiprocessTrainingLoader
from sad_tpu_torch.data.rpn_minibatch import RCNNMinibatchBuilder
from sad_tpu_torch.data.synth_coco import generate_synthetic_coco
from sad_tpu_torch.models import RetinaNet
from sad_tpu_torch.models.arch import ModelArch
from sad_tpu_torch.parallel import check_group_layout, init_distributed, shard_rows
from sad_tpu_torch.tools import profile_ddp, profile_train
from sad_tpu_torch.train import TrainState, batch_to_torch, make_train_step
from test_torch_models import one_torch_thread, random_params, sad_tpu_native_loaded  # noqa: F401
from test_torch_train_step import CFG as STEP_CFG
from test_torch_train_step import TEACHER as STEP_TEACHER

W, G, B, LR, STEPS = 2, 4, 8, 1e-3, 2
HW = 128
TIMEOUT_S = 110.0  # a module fixture's worlds together
RCNN_OPTS = ["TRAIN.SCALES", "(128,)", "TRAIN.MAX_SIZE", "128", "RESNETS.CHANNEL_RATIO",
             "0.0625", "COMPUTE_DTYPE", "float32", "MODEL.NUM_CLASSES", "3",
             "TRAIN.RPN_PRE_NMS_TOP_N", "64", "TRAIN.RPN_POST_NMS_TOP_N", "32",
             "TRAIN.BATCH_SIZE_PER_IM", "16", "FAST_RCNN.MLP_HEAD_DIM", "32",
             "MRCNN.DIM_REDUCED", "8"]
CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "sad_tpu_torch", "configs")


def _compare(build, kwargs):
    return profile_ddp.run_compare(build, kwargs, W, STEPS, LR, 0, TIMEOUT_S, device="cpu",
                                   threads=1)


def _joint_batch(seed=0):
    """B uint8 canvases with content extents and random targets of G groups."""
    rng = np.random.RandomState(seed)
    batch = {"data_u8": rng.randint(0, 256, (B, HW, HW, 3)).astype(np.uint8),
             "content_hw": rng.randint(64, HW + 1, (B, 2)).astype(np.float32),
             "labels": {}, "bbox_targets": {}, "fg_mask": {},
             "fg_num": rng.randint(3, 12, G).astype(np.float32)}
    for lvl in range(3, 8):
        h = w = HW >> lvl
        batch["labels"][lvl] = rng.randint(-1, 81, (B, h, w, 9)).astype(np.int32)
        batch["bbox_targets"][lvl] = rng.randn(B, h, w, 9, 4).astype(np.float32)
        batch["fg_mask"][lvl] = rng.uniform(size=(B, h, w, 9)) < 0.2
    return batch


@pytest.fixture(scope="module")
def joint_setup(tmp_path_factory):
    """The tiny student and teacher with random float32 weights, their
    configs at G groups and one batch: saved as a run for the ranks."""
    s_arch, t_arch = graft._tiny_arch(), graft._tiny_arch(block_counts=(1, 1, 2, 1))
    x = np.zeros((1, HW, HW, 3), np.float32)
    sp = random_params(JaxRetinaNet(s_arch), x, 1)
    tp = random_params(JaxRetinaNet(t_arch), x, 2)
    over = {**STEP_CFG, "NUM_GPUS": G}
    tc = t_merge(tcfg.Config(), over)
    ttc = t_merge(tc, STEP_TEACHER)
    student = load_params(RetinaNet(ModelArch(**dataclasses.asdict(s_arch))), sp)
    teacher = load_params(RetinaNet(ModelArch(**dataclasses.asdict(t_arch))), tp)
    batch = _joint_batch()
    run = profile_train.SeededTrainStep(
        tc, ttc, student, teacher, make_train_step(tc, student, teacher, n_groups=G,
                                                   teacher_cfg=ttc),
        TrainState.create(student), batch_to_torch(batch, "cpu"), B)
    path = str(tmp_path_factory.mktemp("ddp_joint") / "run.pt")
    torch.save(run, path)
    return (s_arch, t_arch, sp, tp, over, batch), path


@pytest.fixture(scope="module")
def joint_runs(joint_setup):
    """The worlds of the joint step's comparison, and sad_tpu's mesh step,
    which this process jits and runs while the worlds run."""
    _, path = joint_setup
    with ThreadPoolExecutor(1) as pool:
        joint = pool.submit(_compare, profile_ddp.load_run, {"path": path})
        mesh = _mesh_ref(joint_setup)
        return joint.result(), mesh


@pytest.fixture(scope="module")
def joint(joint_runs):
    return joint_runs[0]


@pytest.fixture(scope="module")
def mesh_ref(joint_runs):
    return joint_runs[1]


def _mesh_ref(joint_setup):
    """sad_tpu's jitted joint step over a 2-device 'data' mesh, two steps
    from the same weights and batch."""
    (s_arch, t_arch, sp, tp, over, batch), _ = joint_setup
    jc = j_merge(jcfg.Config(), over)
    jtc = j_merge(jc, STEP_TEACHER)
    mesh = create_mesh(n_data=W, devices=jax.devices()[:W])
    rep = replicated_sharding(mesh)
    sp, tp = jax.device_put(sp, rep), jax.device_put(tp, rep)
    state = JTrainState(sp, jax.device_put(init_momentum_state(sp).velocity, rep))
    step = jax.jit(j_make_train_step(jc, JaxRetinaNet(s_arch), JaxRetinaNet(t_arch),
                                     n_groups=G, teacher_cfg=jtc))
    batch = shard_batch_tree(batch, mesh)
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, tp, batch, jnp.float32(LR))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax.device_get(state.params), jax.device_get(state.velocity)


def _check_against_one(res, velocity_tol):
    assert res["metric_rel"] <= 1e-5, (res["metric_key"], res["metric_rel"])
    assert res["param_rel_l2"] <= 1e-5, (res["param_key"], res["param_rel_l2"])
    assert res["velocity_rel_l2"] <= velocity_tol, (res["velocity_key"], res["velocity_rel_l2"])
    # the update moved every tensor the comparison holds
    assert len(res["one"]["metrics"]) == STEPS and np.isfinite(res["one"]["metrics"][-1]["loss"])


def test_joint_step_over_two_ranks_matches_one_process(joint):
    res = joint
    assert [r["n_images"] for r in res["ranks"]] == [4, 4] and res["one"]["n_images"] == B
    assert [r["n_groups"] for r in res["ranks"]] == [2, 2] and res["one"]["n_groups"] == G
    assert [r["backend"] for r in res["ranks"]] == ["gloo", "gloo"]
    _check_against_one(res, 1e-4)


def test_joint_step_parameters_are_bit_equal_across_ranks(joint):
    res = joint
    assert not res["unequal_across_ranks"]
    # on the CPU the cls losses take the plain twin: no kernel launch counted
    assert all(r["launches"]["cls_fwd"] == r["launches"]["cls_bwd"] == 0 for r in res["ranks"])
    assert res["ranks"][0]["grad_bytes"] == res["one"]["grad_bytes"] > 0


def test_two_halves_in_one_process_match_the_ranks(joint, joint_setup):
    """profile_ddp.local_steps (the witness's halves, no process group) is
    the ranks' arithmetic; its cuDNN readings on the CPU, where there is no
    cuDNN, are all within the ranks' tolerance and a repeat is bit-equal."""
    _, path = joint_setup
    got = profile_ddp.local_steps(profile_ddp.load_run(path), STEPS, LR, W)
    want = joint["ranks"][0]["params"]
    assert max(profile_ddp.rel_l2(got[k], v) for k, v in want.items()) <= 1e-5
    readings = profile_ddp.cudnn_witness(profile_ddp.load_run, {"path": path}, STEPS, LR)
    assert len(readings) == len(profile_ddp.WITNESS_READINGS)
    assert all(r["param_rel_l2"] <= 1e-5 for r in readings.values()), readings
    assert readings["bs 8, cuDNN, again vs bs 8, cuDNN"]["bit_equal"]


def test_joint_step_over_two_ranks_matches_sad_tpu_mesh(joint, mesh_ref):
    res = joint
    metrics, params, velocity = mesh_ref
    got = res["ranks"][0]
    for m, ref in zip(got["metrics"], metrics):
        assert sorted(m) == sorted(ref)
        for k, v in ref.items():
            assert abs(m[k] - v) <= 1e-4 * abs(v), (k, m[k], v)
    for tree, ref_tree in (("params", params), ("velocity", velocity)):
        sd = {k: torch.from_numpy(v) for k, v in got[tree].items()}
        flat_ref = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
        flat_got = jax.tree_util.tree_leaves(state_dict_to_params(sd))
        assert len(flat_got) == len(flat_ref)
        for (path, r), g in zip(flat_ref, flat_got):
            r = np.asarray(r)
            assert np.abs(g - r).max() <= 1e-4 * np.abs(r).max() + 1e-12, (tree, path)


@pytest.fixture(scope="module", params=["faster", "mask"])
def rcnn(request):
    yaml = os.path.join(CONFIGS, f"e2e_{request.param}_rcnn_R-50-FPN.yaml")
    kw = dict(cfg_yaml=yaml, seed=0, n_groups=G, device="cpu", opts=RCNN_OPTS)
    return request.param, _compare(profile_train.seeded_rcnn_train_step, kw)


def test_rcnn_step_over_two_ranks_matches_one_process(rcnn):
    family, res = rcnn
    assert [r["n_images"] for r in res["ranks"]] == [4, 4]
    _check_against_one(res, 1e-4)
    m = res["one"]["metrics"][0]
    assert ("loss_mask" in m) == (family == "mask") and m["accuracy_cls"] > 0


def test_rcnn_step_parameters_are_bit_equal_across_ranks(rcnn):
    _, res = rcnn
    assert not res["unequal_across_ranks"]
    # every rank's sampler generator advanced as the one process's did
    assert len(res["one"]["generator"]) == STEPS and not res["generator_unequal"]


def test_rcnn_comparison_held_over_the_first_step(rcnn):
    """compare(held=1): the tolerance's readings over step 1, the later
    step's reported beside them."""
    _, res = rcnn
    got = profile_ddp.compare(res["one"], res["ranks"], 1)
    assert got["metric_key"].startswith("step 0 ") and got["later_metric_key"].startswith("step 1 ")
    assert got["metric_rel"] <= 1e-5 and got["param_rel_l2"] <= 1e-5
    assert got["later_metric_rel"] <= 1e-5 and got["later_param_rel_l2"] == res["param_rel_l2"]
    assert not got["unequal_across_ranks"] and not got["generator_unequal"]


# --------------------------------------------------------------------------- #
# The loaders' rank shards
# --------------------------------------------------------------------------- #

LOADER_CFG = {
    "MODEL": {"TYPE": "retinanet", "NUM_CLASSES": 9},
    "NUM_GPUS": 2,
    "FPN": {"FPN_ON": True, "RPN_MIN_LEVEL": 3, "RPN_MAX_LEVEL": 7,
            "EXTRA_CONV_LEVELS": True, "COARSEST_STRIDE": 128},
    "RETINANET": {"RETINANET_ON": True, "ASPECT_RATIOS": (1.0, 2.0), "SCALES_PER_OCTAVE": 2},
    "TRAIN": {"SCALES": (64, 96), "MAX_SIZE": 128, "IMS_PER_BATCH": 2},
    "PIXEL_STD": (57.375, 57.12, 58.395),
}
RCNN_LOADER = {
    "MODEL": {"TYPE": "generalized_rcnn", "FASTER_RCNN": True, "MASK_ON": True,
              "NUM_CLASSES": 9},
    "FPN": {"FPN_ON": True, "MULTILEVEL_RPN": True, "MULTILEVEL_ROIS": True,
            "RPN_MIN_LEVEL": 2, "RPN_MAX_LEVEL": 6, "COARSEST_STRIDE": 64},
}


@pytest.fixture(scope="module")
def roidbs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ddp_loader_ds"))
    out = []
    for split, seed, n in (("lab", 3, 9), ("pl", 4, 7)):
        img_dir, js = generate_synthetic_coco(root, split, n, seed=seed, size_range=(48, 96),
                                              objects_per_image=(1, 3), small_frac=0.0)
        name = f"torch_ddp_loader_{split}"
        tcfg.register_dataset(name, img_dir, js, is_pseudo_labeled=split == "pl",
                              allow_override=True)
        out.append(t_roidb([name], True))
    return out


def _batches(kind, cfg, roidbs, builder, rank, world, n=5, skip=3):
    cls = MultiprocessTrainingLoader if kind == "mp" else tloader.TrainingLoader
    extra = {"num_workers": 2} if kind == "mp" else {"num_threads": 2}
    loader = cls(cfg, roidbs[0], None, roidbs[1], builder=builder, skip_batches=skip,
                 rank=rank, world=world, **extra)
    with loader:
        return [loader.get_next_batch(timeout=60.0) for _ in range(n)], list(loader.served)


def _concat(parts):
    if isinstance(parts[0], dict):
        return {k: _concat([p[k] for p in parts]) for k in parts[0]}
    if isinstance(parts[0], float):
        assert len(set(parts)) == 1
        return parts[0]
    return np.concatenate(parts, axis=0)


def _assert_equal(got, want, where=""):
    assert sorted(got) == sorted(want), where
    for k in want:
        if isinstance(want[k], dict):
            _assert_equal(got[k], want[k], f"{where}{k}.")
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                          err_msg=f"{where}{k}")


@pytest.mark.parametrize("kind,family", [("threads", "retinanet"), ("threads", "rcnn"),
                                         ("mp", "retinanet")])
def test_rank_shards_concatenate_to_the_one_rank_batches(roidbs, kind, family):
    over = LOADER_CFG if family == "retinanet" else {**LOADER_CFG, **RCNN_LOADER}
    cfg = t_merge(tcfg.Config(), over)

    def builder():
        return RCNNMinibatchBuilder(cfg) if family == "rcnn" else None

    one, served = _batches(kind, cfg, roidbs, builder(), 0, 1)
    ranks = [_batches(kind, cfg, roidbs, builder(), r, W) for r in range(W)]
    assert served == ["unlabeled", "labeled"] * 2 + ["unlabeled"]
    assert all(s == served for _, s in ranks)
    for i, want in enumerate(one):
        parts = [batches[i] for batches, _ in ranks]
        images = "data_u8" if "data_u8" in want else "data"
        assert all(p[images].shape[0] == want[images].shape[0] // W for p in parts)
        if family == "retinanet":
            assert all(p["fg_num"].shape == (1,) for p in parts)
        _assert_equal(_concat(parts), want, f"batch {i}: ")


# --------------------------------------------------------------------------- #
# Refusals
# --------------------------------------------------------------------------- #


def test_group_layout_needs_whole_groups_a_rank():
    """The batch's images must divide over the ranks; a loss group may span
    ranks on every step (8 images, one a rank: each group over two), the
    R-CNN step's too, while a misshaped batch is still refused."""
    cfg = t_merge(tcfg.Config(), {"NUM_GPUS": 4, "TRAIN": {"IMS_PER_BATCH": 2}})
    check_group_layout(cfg, 2)
    check_group_layout(cfg, 4)
    with pytest.raises(ValueError, match="NUM_GPUS = 4.*IMS_PER_BATCH = 2"):
        check_group_layout(cfg, 3)
    check_group_layout(cfg, 8)
    rcnn = t_merge(cfg, {"MODEL": {"TYPE": "generalized_rcnn"}})
    check_group_layout(rcnn, 4)
    check_group_layout(rcnn, 8)
    with pytest.raises(ValueError, match="NUM_GPUS = 4.*IMS_PER_BATCH = 2"):
        check_group_layout(rcnn, 3)


def test_shard_rows_takes_contiguous_blocks_and_refuses_ragged_ones():
    x = torch.arange(12).reshape(6, 2)
    assert torch.equal(shard_rows(x, 1, 3), x[2:4])
    with pytest.raises(ValueError, match="does not split"):
        shard_rows(x, 0, 4)


@pytest.mark.parametrize("backend", ["mpi", "no_such_backend"])
def test_a_named_backend_that_is_missing_raises(tmp_path, backend):
    with pytest.raises(RuntimeError, match="not available"):
        init_distributed(0, 1, 0, backend=backend,
                         init_method="file://" + str(tmp_path / "store"), device="cpu")
    assert init_distributed().world == 1  # no group was created


def test_spawn_fails_a_rank_that_raises_and_ends_a_hung_world():
    import operator
    import time

    from sad_tpu_torch.parallel.launch import spawn

    with pytest.raises(RuntimeError, match="ZeroDivisionError"):
        spawn(operator.truediv, W, (1, 0), device="cpu", timeout_s=TIMEOUT_S)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="not done after"):
        spawn(time.sleep, W, (600,), device="cpu", timeout_s=5.0)
    assert time.monotonic() - t0 < 60


def test_spawn_defaults_to_the_card_and_raises_without_one(tmp_path):
    """Without ``device`` the ranks would run on the card: on a host without
    one spawn raises before it starts a rank, and nothing runs on the CPU."""
    from sad_tpu_torch.parallel.launch import spawn

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    marker = tmp_path / "ran"
    with pytest.raises(RuntimeError, match="does not fall back"):
        spawn(marker.touch, W, (), timeout_s=TIMEOUT_S)
    assert not marker.exists()
