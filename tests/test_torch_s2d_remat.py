"""S2D_STEM and REMAT_BACKBONE in the port (models/resnet.py) against
sad_tpu's (sad_tpu/models/resnet.py:156-207 Conv1S2D / _s2d_conv, the
FOLD_AFFINE stem :307-313, nn.remat(Bottleneck) :336), on the CPU.

- S2D_STEM: the port runs the 7x7 stem with the switch on (faster on the
  H100). Its ResNetBody, equal bit for bit with the switch off, against
  sad_tpu's S2D body from the same weights (AffineChannel scales and
  offsets away from 1 / 0), FOLD_AFFINE off and on: every stage output
  within 1e-12 of its largest entry at float64 and within 1e-5 at float32.
  An odd canvas height or width is refused by name, as sad_tpu's reshape
  refuses it.
- REMAT_BACKBONE: two joint SAD steps of the tiny student and teacher
  (tests/test_torch_train_step.py), FOLD_AFFINE off and on, and one tiny
  Faster R-CNN step (tests/test_torch_rcnn_train.py) with the switch on
  and off from the same weights and batches: metrics, parameters and
  momenta bit for bit at float32; with it on every Bottleneck after
  FREEZE_AT's stage ran twice a step (forward and recompute), with it off
  once. One joint step with both switches on against sad_tpu's jitted step
  with both on, at the tolerances of test_torch_train_step.py (metrics 1e-4
  relative, each leaf 1e-4 of its largest).
- Both on a 1 x 2 'model' mesh: the joint step of tests/test_torch_mesh.py
  (bs 4, G = 2) on a 30x128 canvas, on 2 spawned gloo ranks against one
  process, held as that file holds its mesh steps (metrics 1e-5 relative,
  the worst parameter 1e-5 and momentum 1e-4 relative L2, the ranks
  bit-equal): the recompute re-enters the banded run, the second rank's
  res5 bands are empty (1 row over 2) and it still exchanges in step, and
  the canvas's bands of 15 rows pass S2D_STEM's check, which reads the
  canvas. The record run refuses an odd canvas.
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
from sad_tpu.config.config import merge_cfg_from_dict as jmerge
from sad_tpu.models import RetinaNet as JaxRetinaNet
from sad_tpu.models.resnet import ResNetBody as JaxResNetBody
from sad_tpu.train import TrainState as JaxTrainState
from sad_tpu.train import make_train_step as j_make_train_step
import sad_tpu_torch.config as tcfg
from sad_tpu_torch.config.config import merge_cfg_from_dict as tmerge
from sad_tpu_torch.convert import load_params
from sad_tpu_torch.models import GeneralizedRCNN, RetinaNet
from sad_tpu_torch.models.resnet import Bottleneck, ResNetBody
from sad_tpu_torch.parallel import spatial
from sad_tpu_torch.parallel.launch import spawn
from sad_tpu_torch.parallel.mesh import Mesh
from sad_tpu_torch.tools import profile_ddp, profile_spatial, profile_train
from sad_tpu_torch.train import TrainState, batch_to_torch, make_rcnn_train_step, make_train_step
from test_torch_mesh import _cfgs as mesh_cfgs
from test_torch_models import (  # noqa: F401
    _port_arch, one_torch_thread, random_params, sad_tpu_native_loaded,
)
from test_torch_rcnn import rcnn_params
from test_torch_rcnn_train import HW as RCNN_HW
from test_torch_rcnn_train import cfg_pair, make_batch
from test_torch_train_step import CFG, G, LR, TEACHER, _check_tree
from test_torch_train_step import _batch as step_batch

MESH_STEPS, MESH_LR, MESH_RANKS, MESH_HW = 2, 1e-3, 2, (30, 128)


def _body_arch(fold, s2d=True, dtype="float32"):
    return graft._tiny_arch(block_counts=(1, 2, 1, 1), freeze_at=0, fold_affine=fold,
                            s2d_stem=s2d, compute_dtype=dtype)


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())


@pytest.fixture(scope="module", params=[False, True], ids=["unfolded", "folded"])
def s2d_case(request):
    fold = request.param
    arch = _body_arch(fold)
    x = np.random.RandomState(4).randn(2, 64, 96, 3).astype(np.float32)
    return fold, arch, x, random_params(JaxResNetBody(arch), x, seed=5)


def _port_body(arch, params, s2d=True, dtype="float32"):
    a = dataclasses.replace(_port_arch(arch), s2d_stem=s2d, compute_dtype=dtype)
    body = load_params(ResNetBody(a), params)
    return body.double() if dtype == "float64" else body


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12), ("float32", 1e-5)])
def test_s2d_body_matches_sad_tpu(s2d_case, dtype, tol):
    fold, arch, x, params = s2d_case
    np_dt = np.float64 if dtype == "float64" else np.float32
    with jax.enable_x64(dtype == "float64"):
        body = JaxResNetBody(dataclasses.replace(arch, compute_dtype=dtype))
        p = jax.tree_util.tree_map(lambda v: jnp.asarray(np.asarray(v, np_dt)), params)
        ref = jax.tree_util.tree_map(
            np.asarray, jax.jit(body.apply)({"params": p}, jnp.asarray(x, np_dt)))
    xt = torch.from_numpy(x.astype(np_dt)).permute(0, 3, 1, 2)
    with torch.no_grad():
        s2d = _port_body(arch, params, True, dtype)(xt)
        plain = _port_body(arch, params, False, dtype)(xt)
    assert sorted(s2d) == sorted(ref)
    for k in ref:
        assert s2d[k].dtype == getattr(torch, dtype)
        assert torch.equal(s2d[k], plain[k]), k  # the 7x7 stem either way
        got = s2d[k].permute(0, 2, 3, 1).numpy()
        assert _rel(got, ref[k]) <= tol, (k, "sad_tpu", _rel(got, ref[k]))


@pytest.mark.parametrize("hw", [(65, 64), (64, 63)])
def test_s2d_refuses_an_odd_canvas(s2d_case, hw):
    _, arch, _, params = s2d_case
    with pytest.raises(ValueError, match="S2D_STEM: a .* canvas.*even height and width"):
        _port_body(arch, params)(torch.zeros(1, 3, *hw))


# --------------------------------------------------------------------------- #
# REMAT_BACKBONE: the steps bit for bit, and against sad_tpu's
# --------------------------------------------------------------------------- #


class _BlockCalls:
    """Counts the Bottleneck calls of a model (a recompute calls it again);
    ``trained``: the blocks after FREEZE_AT's stage, the ones a backward
    reaches."""

    def __init__(self, model):
        self.n = 0
        self.handles = [m.register_forward_hook(self._hook) for m in model.modules()
                        if isinstance(m, Bottleneck)]
        self.blocks = len(self.handles)
        a = model.arch
        self.trained = sum(n for stage, n in enumerate(a.block_counts, start=2)
                           if stage > a.freeze_at)

    def _hook(self, *_):
        self.n += 1


@pytest.fixture(scope="module")
def tiny_pair():
    s_arch, t_arch = graft._tiny_arch(), graft._tiny_arch(block_counts=(1, 1, 2, 1))
    x = np.zeros((1, 128, 128, 3), np.float32)
    return (s_arch, t_arch, random_params(JaxRetinaNet(s_arch), x, 1),
            random_params(JaxRetinaNet(t_arch), x, 2), [step_batch(0), step_batch(1)])


def _joint_steps(tiny_pair, **switches):
    s_arch, t_arch, sp, tp, batches = tiny_pair
    tc = tmerge(tcfg.Config(), CFG)
    student = load_params(RetinaNet(dataclasses.replace(_port_arch(s_arch), **switches)), sp)
    teacher = load_params(RetinaNet(_port_arch(t_arch)), tp)
    step = make_train_step(tc, student, teacher, n_groups=G, teacher_cfg=tmerge(tc, TEACHER))
    state = TrainState.create(student)
    calls = _BlockCalls(student)
    metrics = [step(state, batch_to_torch(b, "cpu"), LR) for b in batches]
    return metrics, student.state_dict(), state.velocity, calls


def _bit_equal(a, b):
    (ma, pa, va), (mb, pb, vb) = a, b
    assert [sorted(m) for m in ma] == [sorted(m) for m in mb]
    for x, y in zip(ma, mb):
        assert all(torch.equal(x[k], y[k]) for k in x), [k for k in x if not torch.equal(x[k], y[k])]
    for what, ta, tb in (("params", pa, pb), ("velocity", va, vb)):
        assert sorted(ta) == sorted(tb)
        unequal = [k for k in ta if not torch.equal(ta[k], tb[k])]
        assert not unequal, (what, unequal[:5])


@pytest.mark.parametrize("fold", [False, True], ids=["unfolded", "folded"])
def test_remat_joint_steps_bit_equal(tiny_pair, fold):
    on = _joint_steps(tiny_pair, remat=True, fold_affine=fold)
    off = _joint_steps(tiny_pair, remat=False, fold_affine=fold)
    _bit_equal(on[:3], off[:3])
    steps = len(tiny_pair[4])
    # with the switch on each trained block runs again in the backward
    c = on[3]
    assert c.n == steps * (c.blocks + c.trained) and off[3].n == steps * c.blocks
    assert 0 < c.trained < c.blocks


def test_remat_rcnn_step_bit_equal():
    jc, tc = cfg_pair(False)
    from sad_tpu.models import create_model as j_create_model

    params = rcnn_params(j_create_model(jc), seed=21, hw=RCNN_HW)
    batch = batch_to_torch(make_batch(jc, mask=False), "cpu")
    p = tc.TRAIN.RPN_POST_NMS_TOP_N + batch["gt_boxes"].shape[1]
    rng = np.random.RandomState(7)
    uniforms = tuple(torch.from_numpy(rng.uniform(size=(2, p)).astype(np.float32))
                     for _ in range(2))
    runs = []
    for remat in (True, False):
        cfg = tmerge(tc, {"REMAT_BACKBONE": remat})
        model = load_params(GeneralizedRCNN(cfg), params)
        assert model.arch.remat == remat
        state = TrainState.create(model)
        calls = _BlockCalls(model)
        m = make_rcnn_train_step(cfg, model, n_groups=2)(state, batch, 1e-2, uniforms=uniforms)
        runs.append(([m], model.state_dict(), state.velocity, calls))
    _bit_equal(runs[0][:3], runs[1][:3])
    c = runs[0][3]
    assert c.n == c.blocks + c.trained and runs[1][3].n == c.blocks and c.trained > 0


def _remat_names(tree, to_remat):
    """sad_tpu's nn.remat(Bottleneck) names its blocks CheckpointBottleneck_k
    in the param tree; the port keeps Bottleneck_k with the switch on."""
    if not isinstance(tree, dict):
        return tree
    a, b = ("Bottleneck_", "CheckpointBottleneck_") if to_remat else (
        "CheckpointBottleneck_", "Bottleneck_")
    return {(b + k[len(a):] if k.startswith(a) else k): _remat_names(v, to_remat)
            for k, v in tree.items()}


def test_remat_s2d_step_matches_sad_tpu(tiny_pair):
    """A joint step with REMAT_BACKBONE and S2D_STEM on in both packages."""
    s_arch, t_arch, sp, tp, batches = tiny_pair
    s_arch = dataclasses.replace(s_arch, remat=True, s2d_stem=True)
    t_arch = dataclasses.replace(t_arch, s2d_stem=True)
    jc, tc = jmerge(jcfg.Config(), CFG), tmerge(tcfg.Config(), CFG)
    jstep = jax.jit(j_make_train_step(jc, JaxRetinaNet(s_arch), JaxRetinaNet(t_arch),
                                      n_groups=G, teacher_cfg=jmerge(jc, TEACHER)))
    student = load_params(RetinaNet(_port_arch(s_arch)), sp)
    teacher = load_params(RetinaNet(_port_arch(t_arch)), tp)
    step = make_train_step(tc, student, teacher, n_groups=G, teacher_cfg=tmerge(tc, TEACHER))
    state = TrainState.create(student)
    jsp = _remat_names(sp, True)
    jstate = JaxTrainState(jsp, jax.tree_util.tree_map(np.zeros_like, jsp))
    for batch in batches[:1]:
        jstate, jm = jstep(jstate, tp, jax.tree_util.tree_map(jnp.asarray, batch),
                           jnp.float32(LR))
        m = step(state, batch_to_torch(batch, "cpu"), LR)
        assert sorted(m) == sorted(jm)
        for k in jm:
            ref = float(jm[k])
            assert abs(float(m[k]) - ref) <= 1e-4 * abs(ref), (k, float(m[k]), ref)
        _check_tree(student.state_dict(), _remat_names(jstate.params, False), "params")
        _check_tree(state.velocity, _remat_names(jstate.velocity, False), "velocity")


# --------------------------------------------------------------------------- #
# Both switches on the 'model' mesh
# --------------------------------------------------------------------------- #


def _mesh_batch(b, g, seed):
    """b uint8 canvases of MESH_HW, contents from half the height to all of
    it, random targets of g groups at each level's ceil(H / stride) rows."""
    h, w = MESH_HW
    rng = np.random.RandomState(seed)
    hw = np.stack([rng.randint(h // 2, h + 1, b), rng.randint(w // 2, w + 1, b)], 1)
    batch = {"data_u8": rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8),
             "content_hw": hw.astype(np.float32), "labels": {}, "bbox_targets": {},
             "fg_mask": {}, "fg_num": rng.randint(3, 12, g).astype(np.float32)}
    for lvl in range(3, 8):
        shape = (b, -(-h // 2 ** lvl), w >> lvl, 9)
        batch["labels"][lvl] = rng.randint(-1, 81, shape).astype(np.int32)
        batch["bbox_targets"][lvl] = rng.randn(*shape, 4).astype(np.float32)
        batch["fg_mask"][lvl] = rng.uniform(size=shape) < 0.2
    return batch


@pytest.fixture(scope="module")
def mesh_run(tiny_pair, tmp_path_factory):
    """The joint step of tests/test_torch_mesh.py with both switches on, on
    a 30-row canvas: 2 gloo ranks on a 1 x 2 mesh and this process. The
    input bands have 15 rows; res5's 1 row leaves the second rank an empty
    band in every res5 block."""
    b, g = 4, 2
    s_arch, t_arch, sp, tp, _ = tiny_pair
    _, tc, ttc = mesh_cfgs(g)
    student = load_params(RetinaNet(dataclasses.replace(_port_arch(s_arch), remat=True,
                                                        s2d_stem=True)), sp)
    teacher = load_params(RetinaNet(dataclasses.replace(_port_arch(t_arch), s2d_stem=True)), tp)
    run = profile_train.SeededTrainStep(
        tc, ttc, student, teacher, make_train_step(tc, student, teacher, n_groups=g,
                                                   teacher_cfg=ttc),
        TrainState.create(student), batch_to_torch(_mesh_batch(b, g, seed=b), "cpu"), b)
    path = str(tmp_path_factory.mktemp("s2d_remat_mesh") / "run.pt")
    torch.save(run, path)
    kw = {"path": path}
    with ThreadPoolExecutor(1) as pool:  # one process's steps while the ranks run
        world = pool.submit(spawn, profile_spatial.rank_jobs, MESH_RANKS, ([("steps", dict(
            build=profile_ddp.load_run, build_kwargs=kw, n_data=1, n_model=MESH_RANKS,
            steps=MESH_STEPS, lr=MESH_LR))],), device="cpu", timeout_s=90.0, threads=1)
        one = profile_ddp.rank_steps(profile_ddp.load_run, kw, MESH_STEPS, MESH_LR)
        return [r[0] for r in world.result()], one


def test_remat_s2d_mesh_step_matches_one_process(mesh_run):
    ranks, one = mesh_run
    assert [r["band_rows"] for r in ranks] == [[0, 15], [15, 30]]
    assert all(r["halo_bytes_per_step"] > 0 for r in ranks)
    res = profile_ddp.compare(one, ranks)
    assert res["metric_rel"] <= 1e-5, (res["metric_key"], res["metric_rel"])
    assert res["param_rel_l2"] <= 1e-5, (res["param_key"], res["param_rel_l2"])
    assert res["velocity_rel_l2"] <= 1e-4, (res["velocity_key"], res["velocity_rel_l2"])
    assert not res["unequal_across_ranks"], res["unequal_across_ranks"][:3]


def test_s2d_record_run_refuses_an_odd_canvas():
    model = RetinaNet(_port_arch(graft._tiny_arch(s2d_stem=True)))
    run = spatial.SpatialModel(model, Mesh(1, 2))
    with pytest.raises(ValueError, match="S2D_STEM: a 127x128 canvas"):
        run.plan(127, ("cls_prob",), torch.float32, "cpu")
