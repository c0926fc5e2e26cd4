"""sad_tpu's multislice ('dcn') mesh in the port on the CPU: gloo ranks, each
a process that imports no jax, whose environment is torchrun's over 2 nodes
(``launch.spawn(nodes=2)``); a module fixture's worlds end within 150 s
together, so that a hung collective fails the test and does not hold the
run.

- The layout, no collectives: over 4 and 8 ranks in 2 slices, every rank's
  slice, local index and data index, the node and cross-node groups
  (``mesh.slice_groups``); a slice count that does not divide the world
  raises; one slice cuts ``create_mesh(W)``'s blocks and sums flat.
  ``spawn(nodes=2)`` gives every rank torchrun's RANK / WORLD_SIZE /
  LOCAL_RANK / LOCAL_WORLD_SIZE / GROUP_RANK, ``init_distributed`` reads
  the node layout from them and ``create_multislice_mesh()`` takes one
  slice a node.
- The reduction (``profile_ddp.reduction_parity``): buckets of 1, 5, 7 and
  64 random elements (L = 2 ranks a node: three do not divide), summed
  flat, as gloo's two all-reduces and in NCCL's form (reduce-scatter,
  all-reduce of the shard, all-gather; gloo runs it on the CPU): each
  two-level float32 sum within 4 float32 ulps of the flat one, relative to
  the sum of the magnitudes; at float64 within 1e-12 of the exact sum; every
  sum bit-equal across the ranks.
- The joint SAD step on 2 slices x 2 ranks (the tiny student and teacher of
  tests/test_torch_train_step.py, float32, 128x128, bs 8, 2 images a rank,
  G = 2: each loss group spans the two ranks of a node), two steps from
  the same weights and batch, then one instrumented step:
  - against one process (``profile_ddp.rank_steps``): metrics within 1e-5
    relative, the worst parameter tensor within 1e-5 relative L2, the worst
    momentum within 1e-4; parameters and momenta bit-equal across the
    ranks; fg_num global and exact;
  - against sad_tpu's jitted step on ``create_multislice_mesh(n_slices=2)``
    over the 8 JAX CPU devices (as tests/test_model_and_train.py:357-403
    runs it), after the first step: metrics within 1e-4 relative, each leaf
    within 1e-4 * max|ref|. (This batch's losses are ~1e5, so the first
    update amplifies the two frameworks' rounding: at the second step one
    process of the port, like the mesh, is 2.2e-4 from sad_tpu's metrics,
    against 6.3e-6 at the first.)
  - the instrumented step's bytes: each level of the gloo sum and the flat
    all-reduce beside it take every gradient byte, the count all-reduce the
    (2, G) float32 counts.
- The loaders: a batch whose blocks cut loss groups (6 images, G = 3, over
  2 ranks; 4 images, G = 2, over 4), built by rank shards and by
  TrainingLoader's threads: the ranks' pieces joined by image equal the
  one-rank batch array for array, and their per-image fg counts, added into
  their groups, equal its fg_num.
- ``train_net`` over 4 ranks as 2 nodes with NUM_GPUS = 2 (4 images, one a
  rank, each group over a node's two ranks), 3 iterations of the SAD loop
  with a snapshot after iteration 1: only rank 0's files, the ranks bit-equal
  and within 1e-5 relative L2 of a one-process run, a 4-rank run resumed in
  a fresh directory from model_iter1.pkl bit-equal to the uninterrupted one.
"""

import dataclasses
import json
import math
import os
import time
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
from sad_tpu.parallel.mesh import create_multislice_mesh as j_create_multislice_mesh
from sad_tpu.parallel.mesh import replicated_sharding
from sad_tpu.parallel.mesh import shard_batch_tree as j_shard_batch_tree
from sad_tpu.train import TrainState as JTrainState
from sad_tpu.train import init_momentum_state
from sad_tpu.train import make_train_step as j_make_train_step
import sad_tpu_torch.config as tcfg
from sad_tpu_torch.config.config import cfg_to_yaml
from sad_tpu_torch.config.config import merge_cfg_from_dict as t_merge
from sad_tpu_torch.convert import load_params, state_dict_to_params
from sad_tpu_torch.data import loader as tloader
from sad_tpu_torch.data.dataset import combined_roidb_for_training as t_roidb
from sad_tpu_torch.data.loader import rank_builder
from sad_tpu_torch.data.minibatch import RetinaNetMinibatchBuilder
from sad_tpu_torch.data.synth_coco import generate_synthetic_coco
from sad_tpu_torch.data.synthetic import random_train_entries
from sad_tpu_torch.models import RetinaNet
from sad_tpu_torch.models.arch import ModelArch
from sad_tpu_torch.parallel import create_multislice_mesh
from sad_tpu_torch.parallel.distributed import reduction_transport
from sad_tpu_torch.parallel.launch import spawn
from sad_tpu_torch.parallel.mesh import Mesh, shard_batch_tree, slice_groups
from sad_tpu_torch.tools import profile_ddp, profile_spatial, profile_train, train_net
from sad_tpu_torch.train import TrainState, batch_to_torch, make_train_step
from test_torch_distributed import LOADER_CFG
from test_torch_mesh import _batch
from test_torch_models import one_torch_thread, random_params, sad_tpu_native_loaded  # noqa: F401
from test_torch_train_loop import BASE, TEACHER, _over
from test_torch_train_step import CFG as STEP_CFG
from test_torch_train_step import TEACHER as STEP_TEACHER

W, NODES, B, G, HW, LR, STEPS = 4, 2, 8, 2, 128, 1e-3, 2
TIMEOUT_S = 150.0  # the module's worlds together
SIZES = (1, 5, 7, 64)
LAB, PL = "torch_ms_lab", "torch_ms_pl"
LOOP = {"NUM_GPUS": 2, "TRAIN": {"DATASETS": (LAB,), "SNAPSHOT_ITERS": 4, "IMS_PER_BATCH": 2},
        "SOLVER": {"MAX_ITER": 3}, "DISTILLATION": {"UNLABEL_DATASETS": (PL,)}}


# --------------------------------------------------------------------------- #
# The layout, without collectives
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("world", [4, 8])
def test_multislice_layout_of_every_rank(world):
    per = world // 2
    nodes, crosses = slice_groups(world, 2)
    assert nodes == [list(range(per)), list(range(per, world))]
    assert crosses == [[i, per + i] for i in range(per)]
    for r in range(world):
        m = Mesh(world, 1, rank=r, n_slices=2)
        assert (m.per_slice, m.slice_index, m.local_index, m.data_index) == (
            per, r // per, r % per, r)
        assert r in nodes[m.slice_index] and r in crosses[m.local_index]
    for bad in (3, 5, 0):
        with pytest.raises(ValueError, match="do not divide"):
            slice_groups(world, bad)
    # without a process group the world is one rank: 2 slices do not divide it
    with pytest.raises(ValueError, match="do not divide 1 ranks"):
        create_multislice_mesh(2)


def test_one_slice_is_create_mesh():
    batch = _batch(4, 2, seed=3)
    for r in range(4):
        flat, one, two = (Mesh(4, 1, rank=r), Mesh(4, 1, rank=r, n_slices=1),
                          Mesh(4, 1, rank=r, n_slices=2))
        want = shard_batch_tree(batch, flat)
        for m in (one, two):
            got = shard_batch_tree(batch, m)
            np.testing.assert_array_equal(got["data_u8"], want["data_u8"])
            np.testing.assert_array_equal(got["labels"][3], want["labels"][3])
            np.testing.assert_array_equal(got["fg_num"], want["fg_num"])
    assert reduction_transport(Mesh(4, 1, n_slices=1)) == reduction_transport(None) == "flat"
    assert reduction_transport(Mesh(4, 1, backend="gloo", n_slices=2)) == "gloo two-level"
    assert reduction_transport(Mesh(4, 1, backend="nccl", n_slices=2)) == "nccl two-level"


# --------------------------------------------------------------------------- #
# The worlds
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The tiny student and teacher with random float32 weights, G = 2, one
    batch of 8 images: a run saved for the ranks; and the loop's splits."""
    s_arch, t_arch = graft._tiny_arch(), graft._tiny_arch(block_counts=(1, 1, 2, 1))
    x = np.zeros((1, HW, HW, 3), np.float32)
    sp = random_params(JaxRetinaNet(s_arch), x, 1)
    tp = random_params(JaxRetinaNet(t_arch), x, 2)
    over = {**STEP_CFG, "NUM_GPUS": G}
    tc = t_merge(tcfg.Config(), over)
    ttc = t_merge(tc, STEP_TEACHER)
    student = load_params(RetinaNet(ModelArch(**dataclasses.asdict(s_arch))), sp)
    teacher = load_params(RetinaNet(ModelArch(**dataclasses.asdict(t_arch))), tp)
    batch = _batch(B, G, seed=11)
    run = profile_train.SeededTrainStep(
        tc, ttc, student, teacher, make_train_step(tc, student, teacher, n_groups=G,
                                                   teacher_cfg=ttc),
        TrainState.create(student), batch_to_torch(batch, "cpu"), B)
    tmp = tmp_path_factory.mktemp("multislice")
    path = str(tmp / "run.pt")
    torch.save(run, path)
    regs = []
    for name, split, seed in ((LAB, "lab", 15), (PL, "pl", 16)):
        img_dir, js = generate_synthetic_coco(str(tmp), split, 10, seed=seed,
                                              size_range=(64, 96), objects_per_image=(1, 3),
                                              small_frac=0.0, crowd_frac=0.0, ignore_frac=0.0)
        tcfg.register_dataset(name, img_dir, js, is_pseudo_labeled=name == PL,
                              allow_override=True)
        regs.append((name, img_dir, js, name == PL))
    for name, extra in (("student", None), ("teacher", TEACHER)):
        d = _over(_over(BASE, LOOP), extra)
        with open(tmp / f"{name}.yaml", "w") as f:
            f.write(cfg_to_yaml(t_merge(tcfg.Config(), d)))
    return (s_arch, t_arch, sp, tp, over, batch), path, tmp, regs


def _argv(tmp, out):
    return ["--cfg", str(tmp / "student.yaml"), "--teacher_cfg", str(tmp / "teacher.yaml"),
            "--skip-test", "--device", "cpu", "OUTPUT_DIR", str(out)]


def _train_dir(out):
    return os.path.join(str(out), "train", LAB)


def _jax_multislice_steps(setup):
    """sad_tpu's jitted joint step on create_multislice_mesh(n_slices=2) over
    the 8 JAX CPU devices, one step."""
    (s_arch, t_arch, sp, tp, over, batch), _, _, _ = setup
    jc = j_merge(jcfg.Config(), over)
    jtc = j_merge(jc, STEP_TEACHER)
    mesh = j_create_multislice_mesh(n_slices=2, devices=jax.devices()[:8])
    assert mesh.devices.shape == (2, 4, 1)
    rep = replicated_sharding(mesh)
    sp, tp = jax.device_put(sp, rep), jax.device_put(tp, rep)
    state = JTrainState(sp, jax.device_put(init_momentum_state(sp).velocity, rep))
    step = jax.jit(j_make_train_step(jc, JaxRetinaNet(s_arch), JaxRetinaNet(t_arch), n_groups=G,
                                     teacher_cfg=jtc))
    sharded = j_shard_batch_tree(batch, mesh)
    state, m = step(state, tp, sharded, jnp.float32(LR))
    metrics = {k: float(v) for k, v in m.items()}
    return metrics, jax.device_get(state.params), jax.device_get(state.velocity)


def _world(jobs, deadline):
    return spawn(profile_spatial.rank_jobs, W, (jobs,), device="cpu", nodes=NODES,
                 timeout_s=deadline - time.monotonic(), threads=1)


@pytest.fixture(scope="module")
def runs(setup):
    """One world of 4 ranks as 2 nodes (the layout, the reduction, the mesh
    step, train_net and its resume); meanwhile sad_tpu's multislice step,
    one process's steps and one process's train_net."""
    _, path, tmp, regs = setup
    deadline = time.monotonic() + TIMEOUT_S
    jobs = [("layout", {}), ("parity", {"sizes": SIZES, "seed": 5}),
            ("steps", {"build": profile_ddp.load_run, "build_kwargs": {"path": path},
                       "n_data": W, "n_model": 1, "steps": STEPS, "lr": LR, "iters": 1,
                       "n_slices": NODES}),
            ("cli", {"tool": "train_net", "argv": _argv(tmp, tmp / "whole"), "datasets": regs}),
            # rank 0 copies the snapshot into a fresh directory, and the world resumes there
            ("cli", {"tool": "train_net", "argv": _argv(tmp, tmp / "resumed"), "datasets": regs,
                     "seed_files": [(os.path.join(_train_dir(tmp / "whole"), "model_iter1.pkl"),
                                     _train_dir(tmp / "resumed"))]})]

    with ThreadPoolExecutor(2) as pool:
        world_f = pool.submit(_world, jobs, deadline)
        jax_f = pool.submit(_jax_multislice_steps, setup)
        one = profile_ddp.rank_steps(profile_ddp.load_run, {"path": path}, STEPS, LR)
        loop_one = train_net.main(_argv(tmp, tmp / "one"))
        out = world_f.result()
        return {"layout": [r[0] for r in out], "parity": [r[1] for r in out],
                "steps": [r[2] for r in out], "loop": [r[3] for r in out],
                "resumed": [r[4] for r in out],
                "one": one, "loop_one": loop_one, "jax": jax_f.result(), "tmp": tmp}


def test_spawn_gives_every_rank_torchruns_node_layout(runs):
    for r, got in enumerate(runs["layout"]):
        assert got["env"] == {"RANK": str(r), "WORLD_SIZE": "4", "LOCAL_RANK": str(r % 2),
                              "LOCAL_WORLD_SIZE": "2", "GROUP_RANK": str(r // 2)}
        assert got["info"] == (r, 4, 2, r // 2, 2)  # rank, world, local world, node, nodes
        assert got["mesh"] == (2, 2, r // 2, r % 2, r)  # slices, per slice, slice, local, data
        assert got["reduction_transport"] == "gloo two-level"


def test_two_level_sum_equals_the_flat_one_and_is_bit_equal_across_ranks(runs):
    got = runs["parity"]
    # the ranks' inputs, drawn as reduction_parity draws them
    inputs = {}
    for r in range(W):
        rng = np.random.RandomState([5, r])
        for dtype in ("torch.float32", "torch.float64"):
            xs = [rng.randn(n) for n in SIZES]
            inputs.setdefault(dtype, []).append(
                [x.astype(np.float32) if dtype == "torch.float32" else x for x in xs])
    for (how, dtype), sums in got[0].items():
        for other in got[1:]:
            for a, b in zip(sums, other[(how, dtype)]):
                assert np.array_equal(a, b), (how, dtype)  # bit-equal across the ranks
        for i, n in enumerate(SIZES):
            terms = np.stack([inputs[dtype][r][i] for r in range(W)]).astype(np.float64)
            assert sums[i].shape == (n,)
            if dtype == "torch.float64":
                exact = np.array([math.fsum(c) for c in terms.T])
                assert np.abs(sums[i] - exact).max() <= 1e-12, (how, n)
            else:
                flat = got[0][("flat", dtype)][i].astype(np.float64)
                bound = 4 * np.finfo(np.float32).eps * np.abs(terms).sum(axis=0)
                assert np.all(np.abs(sums[i] - flat) <= bound), (how, n)


def test_multislice_step_matches_one_process(runs):
    ranks, one = runs["steps"], runs["one"]
    assert [r["n_images"] for r in ranks] == [2] * W
    assert [r["slice"] for r in ranks] == [0, 0, 1, 1]
    assert all(r["reduction_transport"] == "gloo two-level" for r in ranks)
    res = profile_ddp.compare(one, ranks)
    assert res["metric_rel"] <= 1e-5, (res["metric_key"], res["metric_rel"])
    assert res["param_rel_l2"] <= 1e-5, (res["param_key"], res["param_rel_l2"])
    assert res["velocity_rel_l2"] <= 1e-4, (res["velocity_key"], res["velocity_rel_l2"])
    assert not res["unequal_across_ranks"], res["unequal_across_ranks"][:3]
    fg = _batch(B, G, seed=11)["fg_num"]
    for r in ranks:
        for norms in r["normalizers"]:
            np.testing.assert_array_equal(norms["fg_num"], fg)


def test_multislice_step_matches_sad_tpu_multislice(runs):
    got = runs["steps"][0]
    ref, params, velocity = runs["jax"]
    m = got["metrics"][0]
    assert sorted(m) == sorted(ref)
    for k, v in ref.items():
        assert abs(m[k] - v) <= 1e-4 * abs(v), (k, m[k], v)
    for tree, ref_tree in (("params", params), ("velocity", velocity)):
        sd = {k: torch.from_numpy(v) for k, v in got["trees"][0][tree].items()}
        flat_ref = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
        flat_got = jax.tree_util.tree_leaves(state_dict_to_params(sd))
        assert len(flat_got) == len(flat_ref)
        for (path, r), g in zip(flat_ref, flat_got):
            r = np.asarray(r)
            assert np.abs(g - r).max() <= 1e-4 * np.abs(r).max() + 1e-12, (tree, path)


def test_instrumented_step_counts_the_bytes_of_each_level(runs):
    for r in runs["steps"]:
        (levels,) = r["reduction"]
        grad = runs["one"]["grad_bytes"]
        assert levels["node_bytes"] == levels["cross_bytes"] == levels["flat_bytes"] == grad > 0
        assert levels["counts_bytes"] == 2 * G * 4
        assert levels["node_s"] > 0 and levels["cross_s"] > 0 and levels["flat_s"] > 0


# --------------------------------------------------------------------------- #
# The loaders' blocks that cut loss groups
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("images,groups,world", [(6, 3, 2), (4, 2, 4)])
def test_rank_blocks_that_cut_groups_join_to_the_one_rank_batch(images, groups, world):
    cfg = t_merge(tcfg.Config(), {**LOADER_CFG, "NUM_GPUS": groups})
    builder = RetinaNetMinibatchBuilder(cfg, device_normalize=True)
    entries, ims = random_train_entries(np.random.RandomState(images), images, max_side=128,
                                        num_classes=9)
    whole = builder.build(entries, images_bgr=ims, seed=9).as_pytree()
    pieces = [rank_builder(builder, images, r, world).build(entries, images_bgr=ims, seed=9)
              .as_pytree() for r in range(world)]
    assert all("fg_num" not in p and p["fg_img"].shape == (images // world,) for p in pieces)
    fg = np.zeros(groups, np.float32)
    k = images // world
    for r, p in enumerate(pieces):
        np.add.at(fg, (r * k + np.arange(k)) // (images // groups), p["fg_img"])
    np.testing.assert_array_equal(fg, whole["fg_num"])
    for key, v in whole.items():
        if key == "fg_num":
            continue
        if isinstance(v, dict):
            for lvl, x in v.items():
                np.testing.assert_array_equal(np.concatenate([p[key][lvl] for p in pieces]), x)
        else:
            np.testing.assert_array_equal(np.concatenate([p[key] for p in pieces]), v)


@pytest.fixture(scope="module")
def roidb(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ms_loader_ds"))
    img_dir, js = generate_synthetic_coco(root, "lab", 9, seed=3, size_range=(48, 96),
                                          objects_per_image=(1, 3), small_frac=0.0)
    tcfg.register_dataset("torch_ms_loader", img_dir, js, allow_override=True)
    return t_roidb(["torch_ms_loader"], True)


def test_training_loader_blocks_that_cut_groups(roidb):
    """TrainingLoader's batches of 6 images (G = 3) over 2 ranks, after a
    fast-forward: every rank's block carries fg_img, and the blocks join to
    the one-rank batch with fg_num as their per-image counts summed."""
    cfg = t_merge(tcfg.Config(), {**LOADER_CFG, "NUM_GPUS": 3})

    def batches(rank, world):
        loader = tloader.TrainingLoader(cfg, roidb, num_threads=2, skip_batches=2, rank=rank,
                                        world=world)
        with loader:
            return [loader.get_next_batch(timeout=60.0) for _ in range(3)]

    one = batches(0, 1)
    ranks = [batches(r, 2) for r in range(2)]
    for i, want in enumerate(one):
        parts = [rk[i] for rk in ranks]
        fg = np.concatenate([p["fg_img"] for p in parts]).reshape(3, 2).sum(axis=1)
        np.testing.assert_array_equal(fg, want["fg_num"])
        for key in ("data_u8", "content_hw"):
            np.testing.assert_array_equal(np.concatenate([p[key] for p in parts]), want[key])
        for lvl, x in want["labels"].items():
            np.testing.assert_array_equal(np.concatenate([p["labels"][lvl] for p in parts]), x)


# --------------------------------------------------------------------------- #
# train_net over 2 nodes
# --------------------------------------------------------------------------- #


def test_train_net_over_two_nodes_matches_one_process(runs):
    tmp, loop, one = runs["tmp"], runs["loop"], runs["loop_one"]
    files = sorted(os.listdir(_train_dir(tmp / "whole")))
    assert files == ["cfg.yaml", "model_final.pkl", "model_iter1.pkl", "stats.jsonl"]
    with open(os.path.join(_train_dir(tmp / "whole"), "stats.jsonl")) as f:
        lines = [json.loads(ln) for ln in f]
    assert [ln["iter"] for ln in lines] == [0, 2] and all(np.isfinite(ln["loss"]) for ln in lines)
    assert [(r["rank"], r["start_iter"], r["iters"]) for r in loop] == [
        (r, 0, 3) for r in range(W)]
    for r in loop[1:]:
        for tree in ("params", "velocity"):
            for k, v in loop[0][tree].items():
                assert np.array_equal(r[tree][k], v), (r["rank"], tree, k)
    ref = {n: p.detach().numpy() for n, p in one.model.named_parameters()}
    worst = max(profile_ddp.rel_l2(loop[0]["params"][k], v) for k, v in ref.items())
    assert worst <= 1e-5, worst
    assert any(np.any(v != 0) for v in loop[0]["velocity"].values())


def test_train_net_over_two_nodes_resumes_bit_identically(runs):
    loop, resumed = runs["loop"], runs["resumed"]
    assert [(r["start_iter"], r["iters"]) for r in resumed] == [(2, 1)] * W
    for a, b in zip(loop, resumed):
        for tree in ("params", "velocity"):
            assert sorted(a[tree]) == sorted(b[tree])
            for k, v in a[tree].items():
                assert np.array_equal(b[tree][k], v), (a["rank"], tree, k)
