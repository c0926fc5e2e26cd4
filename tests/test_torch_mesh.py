"""The joint SAD step on a (data, model) mesh of the port on the CPU, with
loss groups that span ranks: gloo ranks, each a process that imports no jax
(``tools/profile_spatial.rank_mesh_steps``), against one process and
against sad_tpu's jitted step on its own 2-D mesh.

- The tiny student and teacher of tests/test_torch_train_step.py at
  float32, 128x128, bs 4, G = 2, two steps from the same weights and batch
  (one uint8 canvas an image, contents ending inside the second band):
  - on a 1 x 2 and a 2 x 2 mesh (the images' height split over 'model'; on
    2 x 2 every group spans two ranks) and, the groups over data ranks, on
    4 x 1 (G = 2 over 4 data ranks); and bs 6, G = 3 on 2 x 1 (one group
    split between the ranks); the plain RetinaNet step (no teacher) on 1 x 2;
  - against one process (``profile_ddp.rank_steps`` in this process):
    metrics within 1e-5 relative, the worst parameter tensor within 1e-5
    relative L2 and the worst momentum within 1e-4; the parameters and
    momenta bit-equal across the ranks;
  - the global normalizers of every step: fg_num equal to the batch's
    exactly, PowSum within 1e-6 relative of one process's;
  - on 1 x 2 and 2 x 2 against sad_tpu's jitted step on
    ``create_mesh(n_data, n_model)`` with the canvases under
    ``spatial_sharding`` (as __graft_entry__.py:190-222 runs it): metrics
    within 1e-4 relative, each leaf within 1e-4 * max|ref|.
- The bytes each rank sends in a step's halo exchanges equal the prediction
  from the shapes (``profile_spatial.predicted_halo_bytes``).
- The loaders' bands: RankShard's pieces on a 2 x 2 mesh, joined by rows,
  are the data shard's batch, array for array, fg_num over whole images.
- ``mesh.shard_batch_tree``: bands, the replicated fg_num, and the
  refusal of a misshaped batch; ``check_group_layout`` accepts groups that
  span ranks for every step, the R-CNN step's too, and refuses a batch
  whose images do not divide over the ranks; RankShard refuses R-CNN bands
  (ROADMAP.md "Not ported").

Each world is spawned once a module and runs all its jobs (a mesh each); the
cases read their results.
"""

import dataclasses
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
from sad_tpu.parallel import create_mesh as j_create_mesh
from sad_tpu.parallel import shard_batch_tree as j_shard_batch_tree
from sad_tpu.parallel.mesh import replicated_sharding, spatial_sharding
from sad_tpu.train import TrainState as JTrainState
from sad_tpu.train import init_momentum_state
from sad_tpu.train import make_train_step as j_make_train_step
import sad_tpu_torch.config as tcfg
from sad_tpu_torch.config.config import merge_cfg_from_dict as t_merge
from sad_tpu_torch.convert import load_params, state_dict_to_params
from sad_tpu_torch.data.loader import RankShard, rank_builder
from sad_tpu_torch.data.minibatch import RetinaNetMinibatchBuilder
from sad_tpu_torch.data.rpn_minibatch import RCNNMinibatchBuilder
from sad_tpu_torch.data.synthetic import random_train_entries
from sad_tpu_torch.models import RetinaNet
from sad_tpu_torch.models.arch import ModelArch
from sad_tpu_torch.ops.losses import pow_sum
from sad_tpu_torch.parallel import check_group_layout
from sad_tpu_torch.parallel.launch import spawn
from sad_tpu_torch.parallel.mesh import Mesh, shard_batch_tree
from sad_tpu_torch.tools import profile_ddp, profile_spatial, profile_train
from sad_tpu_torch.train import TrainState, batch_to_torch, make_train_step
from test_torch_distributed import LOADER_CFG
from test_torch_models import one_torch_thread, random_params, sad_tpu_native_loaded  # noqa: F401
from test_torch_train_step import CFG as STEP_CFG
from test_torch_train_step import TEACHER as STEP_TEACHER

HW, LR, STEPS = 128, 1e-3, 2
TIMEOUT_S = 110.0  # the module's worlds together
# (world, job, run, n_data, n_model); run "b4": bs 4, G = 2; "b6": bs 6, G = 3; "plain": the
# plain RetinaNet step (no teacher) of bs 4, G = 2
DISTILL_LAYOUTS = [(2, 0, "b4", 1, 2), (4, 0, "b4", 2, 2), (4, 1, "b4", 4, 1),
                   (2, 1, "b6", 2, 1)]
LAYOUTS = DISTILL_LAYOUTS + [(2, 2, "plain", 1, 2)]
RUNS = {"b4": (4, 2), "b6": (6, 3), "plain": (4, 2)}


def _batch(b, g, seed):
    """b uint8 canvases, contents from 66 to 128 rows (each ends inside the
    second band of two), random targets of g groups."""
    rng = np.random.RandomState(seed)
    hw = np.stack([rng.randint(66, HW + 1, b), rng.randint(64, HW + 1, b)], 1)
    batch = {"data_u8": rng.randint(0, 256, (b, HW, HW, 3)).astype(np.uint8),
             "content_hw": hw.astype(np.float32), "labels": {}, "bbox_targets": {},
             "fg_mask": {}, "fg_num": rng.randint(3, 12, g).astype(np.float32)}
    for lvl in range(3, 8):
        h = HW >> lvl
        batch["labels"][lvl] = rng.randint(-1, 81, (b, h, h, 9)).astype(np.int32)
        batch["bbox_targets"][lvl] = rng.randn(b, h, h, 9, 4).astype(np.float32)
        batch["fg_mask"][lvl] = rng.uniform(size=(b, h, h, 9)) < 0.2
    return batch


def _cfgs(g):
    over = {**STEP_CFG, "NUM_GPUS": g}
    tc = t_merge(tcfg.Config(), over)
    return over, tc, t_merge(tc, STEP_TEACHER)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The tiny student and teacher with random float32 weights, and a saved
    run of each batch for the ranks."""
    s_arch, t_arch = graft._tiny_arch(), graft._tiny_arch(block_counts=(1, 1, 2, 1))
    x = np.zeros((1, HW, HW, 3), np.float32)
    sp = random_params(JaxRetinaNet(s_arch), x, 1)
    tp = random_params(JaxRetinaNet(t_arch), x, 2)
    tmp = tmp_path_factory.mktemp("mesh")
    paths, batches = {}, {}
    for name, (b, g) in RUNS.items():
        _, tc, ttc = _cfgs(g)
        student = load_params(RetinaNet(ModelArch(**dataclasses.asdict(s_arch))), sp)
        teacher = load_params(RetinaNet(ModelArch(**dataclasses.asdict(t_arch))), tp)
        if name == "plain":
            tc = t_merge(tc, {"MODEL": {"TYPE": "retinanet"}})
            teacher = ttc = None
        batches[name] = _batch(b, g, seed=b)
        run = profile_train.SeededTrainStep(
            tc, ttc, student, teacher,
            make_train_step(tc, student, teacher, n_groups=g, teacher_cfg=ttc),
            TrainState.create(student), batch_to_torch(batches[name], "cpu"), b)
        paths[name] = str(tmp / f"{name}.pt")
        torch.save(run, paths[name])
    return s_arch, t_arch, sp, tp, paths, batches


def _world(world, jobs):
    return spawn(profile_spatial.rank_jobs, world, (jobs,), device="cpu", timeout_s=TIMEOUT_S,
                 threads=1)


def _jax_mesh_steps(setup, n_data, n_model):
    """sad_tpu's jitted joint step on an n_data x n_model mesh, the canvases
    height-sharded over 'model', two steps."""
    s_arch, t_arch, sp, tp, _, batches = setup
    over, _, _ = _cfgs(2)
    jc = j_merge(jcfg.Config(), over)
    jtc = j_merge(jc, STEP_TEACHER)
    mesh = j_create_mesh(n_data=n_data, n_model=n_model, devices=jax.devices()[:n_data * n_model])
    rep = replicated_sharding(mesh)
    sp, tp = jax.device_put(sp, rep), jax.device_put(tp, rep)
    state = JTrainState(sp, jax.device_put(init_momentum_state(sp).velocity, rep))
    step = jax.jit(j_make_train_step(jc, JaxRetinaNet(s_arch), JaxRetinaNet(t_arch), n_groups=2,
                                     teacher_cfg=jtc))
    batch = dict(batches["b4"])
    u8 = batch.pop("data_u8")
    batch = j_shard_batch_tree(batch, mesh)
    batch["data_u8"] = jax.device_put(u8, spatial_sharding(mesh))
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, tp, batch, jnp.float32(LR))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax.device_get(state.params), jax.device_get(state.velocity)


@pytest.fixture(scope="module")
def runs(setup):
    """The worlds' results (spawned at once); meanwhile one process's steps
    and PowSum of each batch, and sad_tpu's mesh steps."""
    _, _, _, _, paths, _ = setup
    jobs = {2: [], 4: []}
    for world, _, name, n_data, n_model in LAYOUTS:
        jobs[world].append(("steps", dict(
            build=profile_ddp.load_run, build_kwargs={"path": paths[name]}, n_data=n_data,
            n_model=n_model, steps=STEPS, lr=LR)))
    with ThreadPoolExecutor(len(jobs) + 2) as pool:
        futures = {w: pool.submit(_world, w, j) for w, j in jobs.items()}
        # XLA compiles without the GIL: the two meshes' steps side by side
        jax_futures = {layout: pool.submit(_jax_mesh_steps, setup, *layout)
                       for layout in ((1, 2), (2, 2))}
        one, powsum = {}, {}
        for name, (_, g) in RUNS.items():
            one[name] = profile_ddp.rank_steps(profile_ddp.load_run, {"path": paths[name]},
                                               STEPS, LR)
            if name == "plain":
                continue
            run = profile_ddp.load_run(paths[name])
            probs = run.step.teacher_probs(run.step.inputs(run.batch)[1])
            powsum[name] = pow_sum(list(probs.values()), 1.8, g).numpy()
        jref = {layout: f.result() for layout, f in jax_futures.items()}
        return {w: f.result() for w, f in futures.items()}, one, powsum, jref


def _ranks(runs, world, job):
    return [r[job] for r in runs[0][world]]


@pytest.mark.parametrize("world,job,name,n_data,n_model", LAYOUTS)
def test_mesh_step_matches_one_process(runs, world, job, name, n_data, n_model):
    ranks = _ranks(runs, world, job)
    one = runs[1][name]
    b, _ = RUNS[name]
    assert [r["n_images"] for r in ranks] == [b // n_data] * world
    assert all(r["backend"] == "gloo" and r["transport"] == "gloo" for r in ranks)
    if n_model > 1:
        assert [r["band_rows"] for r in ranks[:n_model]] == [[0, 64], [64, 128]]
        assert all(r["halo_bytes_per_step"] > 0 for r in ranks)
    res = profile_ddp.compare(one, ranks)
    assert ("distill_normalizer" in ranks[0]["metrics"][0]) == (name != "plain")
    assert res["metric_rel"] <= 1e-5, (res["metric_key"], res["metric_rel"])
    assert res["param_rel_l2"] <= 1e-5, (res["param_key"], res["param_rel_l2"])
    assert res["velocity_rel_l2"] <= 1e-4, (res["velocity_key"], res["velocity_rel_l2"])
    assert not res["unequal_across_ranks"], res["unequal_across_ranks"][:3]
    # on the CPU the fused losses take the plain twin: no kernel launch counted
    assert all(r["launches"]["cls_fwd"] == r["launches"]["cls_bwd"] == 0 for r in ranks)


@pytest.mark.parametrize("world,job,name,n_data,n_model", DISTILL_LAYOUTS)
def test_mesh_step_normalizers_are_global(runs, setup, world, job, name, n_data, n_model):
    """fg_num equal to the batch's exactly and PowSum within 1e-6 relative
    of one process's, on every rank after every step."""
    fg = setup[5][name]["fg_num"]
    for r in _ranks(runs, world, job):
        for norms in r["normalizers"]:
            np.testing.assert_array_equal(norms["fg_num"], fg)
            want = runs[2][name]
            assert np.abs(norms["powsum"] - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("world,job,name,n_data,n_model",
                         [x for x in LAYOUTS if x[4] > 1])
def test_halo_bytes_equal_the_shapes_prediction(runs, setup, world, job, name, n_data, n_model):
    """The bytes each rank sent in a step's exchanges (the teacher's forward,
    the student's forward and backward) equal
    ``profile_spatial.predicted_halo_bytes``, which reads only the shapes."""
    s_arch, t_arch = setup[0], setup[1]
    b, _ = RUNS[name]
    with torch.device("meta"):
        student = RetinaNet(ModelArch(**dataclasses.asdict(s_arch)))
        teacher = RetinaNet(ModelArch(**dataclasses.asdict(t_arch)))
    want = profile_spatial.predicted_halo_bytes(student, (HW, HW), b // n_data, n_model,
                                                ("cls_logits", "bbox_pred"), backward=True)
    if name != "plain":
        t = profile_spatial.predicted_halo_bytes(teacher, (HW, HW), b // n_data, n_model,
                                                 ("cls_prob",))
        want = [x + y for x, y in zip(want, t)]
    got = [r["halo_bytes_per_step"] for r in _ranks(runs, world, job)]
    assert got == want * n_data and min(want) > 0


@pytest.mark.parametrize("world,job,n_data,n_model", [(2, 0, 1, 2), (4, 0, 2, 2)])
def test_mesh_step_matches_sad_tpu_mesh(runs, world, job, n_data, n_model):
    got = _ranks(runs, world, job)[0]
    metrics, params, velocity = runs[3][(n_data, n_model)]
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


# --------------------------------------------------------------------------- #
# The loaders' bands, the batch's pieces, the refusals
# --------------------------------------------------------------------------- #


def test_rank_shard_bands_join_to_the_data_shard():
    cfg = t_merge(tcfg.Config(), {**LOADER_CFG, "NUM_GPUS": 2})
    builder = RetinaNetMinibatchBuilder(cfg, device_normalize=True)
    entries, images = random_train_entries(np.random.RandomState(0), 4, max_side=128,
                                           num_classes=9)
    whole = builder.build(entries, images_bgr=images, seed=7).as_pytree()
    for d in range(2):
        pieces = [rank_builder(builder, 4, 2 * d + m, 4, n_model=2).build(
            entries, images_bgr=images, seed=7).as_pytree() for m in range(2)]
        want = {k: ({lvl: x[2 * d:2 * d + 2] for lvl, x in v.items()} if isinstance(v, dict)
                    else v[2 * d:2 * d + 2] if k != "fg_num" else v[d:d + 1])
                for k, v in whole.items()}
        assert [p["canvas_h"] for p in pieces] == [whole["data_u8"].shape[1]] * 2
        assert pieces[0]["data_u8"].shape[1] == -(-whole["data_u8"].shape[1] // 2)
        for k, v in want.items():
            if isinstance(v, dict):
                for lvl, x in v.items():
                    np.testing.assert_array_equal(
                        np.concatenate([p[k][lvl] for p in pieces], axis=1), x, err_msg=k)
            elif k in ("data_u8",):
                np.testing.assert_array_equal(np.concatenate([p[k] for p in pieces], 1), v)
            else:  # whole images: every band holds the data shard's own
                assert all(np.array_equal(p[k], v) for p in pieces), k


def test_shard_batch_tree_bands_and_replicates():
    batch = _batch(4, 2, seed=1)
    m = Mesh(2, 2, rank=3)  # data index 1, model index 1
    got = shard_batch_tree(batch, m)
    np.testing.assert_array_equal(got["data_u8"], batch["data_u8"][2:, 64:])
    np.testing.assert_array_equal(got["labels"][7], batch["labels"][7][2:, 1:])  # P7 1 row: [1, 1)
    assert got["labels"][7].shape[1] == 0 and got["canvas_h"] == HW
    np.testing.assert_array_equal(got["fg_num"], batch["fg_num"][1:])
    # G = 2 over 4 data ranks: fg_num replicated
    np.testing.assert_array_equal(shard_batch_tree(batch, Mesh(4, 1, rank=2))["fg_num"],
                                  batch["fg_num"])
    with pytest.raises(ValueError, match="cannot be data-sharded over 3 devices"):
        shard_batch_tree(batch, Mesh(3, 1))


def test_group_layouts_that_span_ranks():
    cfg = t_merge(tcfg.Config(), {"MODEL": {"TYPE": "distillation"}, "NUM_GPUS": 3,
                                  "TRAIN": {"IMS_PER_BATCH": 2}})
    check_group_layout(cfg, 2)  # 6 images over 2 ranks: a group split
    check_group_layout(cfg, 6)
    with pytest.raises(ValueError, match="must divide its 6 images"):
        check_group_layout(cfg, 4)
    rcnn = t_merge(cfg, {"MODEL": {"TYPE": "generalized_rcnn"}})
    check_group_layout(rcnn, 3)
    check_group_layout(rcnn, 2)  # 6 images over 2 ranks: a group split
    with pytest.raises(ValueError, match="must divide its 6 images"):
        check_group_layout(rcnn, 4)
    with pytest.raises(NotImplementedError, match="Not ported"):
        RankShard(RCNNMinibatchBuilder(t_merge(tcfg.Config(), {
            "MODEL": {"TYPE": "generalized_rcnn", "FASTER_RCNN": True, "NUM_CLASSES": 9},
            "FPN": {"FPN_ON": True, "MULTILEVEL_RPN": True, "RPN_MIN_LEVEL": 2,
                    "RPN_MAX_LEVEL": 6, "COARSEST_STRIDE": 64}})), 0, 2, n_model=2)
