"""The training slice as a whole: two steps of the port's make_train_step
against two steps of sad_tpu's make_train_step (jitted on this CPU, its
Pallas loss kernels interpreted when USE_PALLAS_LOSSES is on), from the same
float32 weights, velocity and batch (one uint8 canvas with content extents,
normalised twice on the device), for the joint SAD step with
USE_PALLAS_LOSSES off and on and for the plain RetinaNet step. After each
step the metrics, the updated parameters and the velocities are compared
(the port's through convert.state_dict_to_params).

Tolerances: metrics within 1e-4 relative; each parameter and velocity leaf
within 1e-4 * max|ref|. Both packages run the tiny ResNet-FPN at float32,
and their convolutions sum in different orders; through two steps that
moves the results by up to ~1e-5 relative on these seeds. A ReLU input
within ~1e-6 of zero can round to the other side in the other order and
move a weight gradient by ~1 % (batch seed 10 has one, 2.6e-7 from zero in
res4_0_branch2b, where sad_tpu agrees with a float64 run of the port and
the port's float32 does not); these batch seeds have none."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import sad_tpu.config as jcfg
from sad_tpu.config.config import merge_cfg_from_dict as jmerge
from sad_tpu.models import RetinaNet as JaxRetinaNet
from sad_tpu.train import TrainState as JaxTrainState
from sad_tpu.train import make_train_step as j_make_train_step
import sad_tpu_torch.config as tcfg
from sad_tpu_torch.config.config import merge_cfg_from_dict as tmerge
from sad_tpu_torch.convert import load_params, params_to_state_dict, state_dict_to_params
from sad_tpu_torch.models import RetinaNet
from sad_tpu_torch.models.arch import ModelArch
from sad_tpu_torch.ops import cls_loss_kernel
from sad_tpu_torch.train import TrainState, batch_to_torch, make_train_step
from test_torch_models import one_torch_thread, random_params  # noqa: F401

G, B, H, W = 2, 4, 128, 128
LR = 1e-4
CFG = {
    "MODEL": {"TYPE": "distillation", "NUM_CLASSES": 81}, "NUM_GPUS": G,
    "FPN": {"FPN_ON": True, "RPN_MIN_LEVEL": 3, "RPN_MAX_LEVEL": 7,
            "EXTRA_CONV_LEVELS": True, "COARSEST_STRIDE": 128},
    "RETINANET": {"RETINANET_ON": True, "ASPECT_RATIOS": (1.0, 2.0, 0.5),
                  "SCALES_PER_OCTAVE": 3},
    "DISTILLATION": {"DISTILLATION_ON": True, "LOSS_ALPHA": 0.5, "LOSS_GAMMA": 2.0,
                     "ADAPTIVE_NORMALIZER": True, "LOGITS_POWER": 1.8},
    "SOLVER": {"BASE_LR": 0.01}, "COMPUTE_DTYPE": "float32",
    "PIXEL_STD": (57.375, 57.12, 58.395),
}
TEACHER = {"PIXEL_MEANS": (110.0, 115.0, 120.0), "PIXEL_STD": (60.0, 61.0, 62.0)}


def _batch(seed):
    rng = np.random.RandomState(seed)
    batch = {"data_u8": rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8),
             "content_hw": np.array([[128, 128], [100, 120], [128, 90], [64, 128]], np.float32),
             "labels": {}, "bbox_targets": {}, "fg_mask": {},
             "fg_num": np.array([7.0, 11.0], np.float32)}
    for lvl in range(3, 8):
        h, w = H >> lvl, W >> lvl
        batch["labels"][lvl] = rng.randint(-1, 81, (B, h, w, 9)).astype(np.int32)
        batch["bbox_targets"][lvl] = rng.randn(B, h, w, 9, 4).astype(np.float32)
        batch["fg_mask"][lvl] = rng.uniform(size=(B, h, w, 9)) < 0.2
    return batch


@pytest.fixture(scope="module")
def setup():
    s_arch, t_arch = graft._tiny_arch(), graft._tiny_arch(block_counts=(1, 1, 2, 1))
    x = np.zeros((1, H, W, 3), np.float32)
    sp = random_params(JaxRetinaNet(s_arch), x, 1)
    tp = random_params(JaxRetinaNet(t_arch), x, 2)
    rng = np.random.RandomState(3)
    vel = jax.tree_util.tree_map(lambda a: (rng.randn(*a.shape) * 1e-3).astype(np.float32), sp)
    return s_arch, t_arch, sp, tp, vel, [_batch(0), _batch(1)]


def _check_tree(got_sd, ref_tree, what):
    ref = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    got = jax.tree_util.tree_leaves(state_dict_to_params(got_sd))
    assert len(got) == len(ref)
    for (path, r), g in zip(ref, got):
        r = np.asarray(r)
        assert np.abs(g - r).max() <= 1e-4 * np.abs(r).max() + 1e-12, (what, path)


@pytest.mark.parametrize("mode", ["distill_unfused", "distill_pallas", "retinanet"])
def test_two_steps_match_sad_tpu(setup, mode):
    s_arch, t_arch, sp, tp, vel, batches = setup
    distill = mode != "retinanet"
    extra = {"USE_PALLAS_LOSSES": mode == "distill_pallas"}
    if not distill:
        extra["MODEL"] = {"TYPE": "retinanet", "NUM_CLASSES": 81}
    jc, tc = jmerge(jcfg.Config(), {**CFG, **extra}), tmerge(tcfg.Config(), {**CFG, **extra})
    jtc, ttc = jmerge(jc, TEACHER), tmerge(tc, TEACHER)

    jstep = jax.jit(j_make_train_step(jc, JaxRetinaNet(s_arch),
                                      JaxRetinaNet(t_arch) if distill else None,
                                      n_groups=G, teacher_cfg=jtc))
    student = load_params(RetinaNet(ModelArch(**dataclasses.asdict(s_arch))), sp)
    teacher = (load_params(RetinaNet(ModelArch(**dataclasses.asdict(t_arch))), tp)
               if distill else None)
    step = make_train_step(tc, student, teacher, n_groups=G, teacher_cfg=ttc)
    state = TrainState({k: v.clone() for k, v in params_to_state_dict(vel).items()})
    jstate = JaxTrainState(sp, vel)
    before = (cls_loss_kernel.fwd_launches, cls_loss_kernel.bwd_launches)

    for batch in batches:
        jstate, jm = jstep(jstate, tp, jax.tree_util.tree_map(jnp.asarray, batch),
                           jnp.float32(LR))
        m = step(state, batch_to_torch(batch, "cpu"), LR)
        assert sorted(m) == sorted(jm)
        assert ("fl_distill_fpn3" in m) == distill and ("distill_normalizer" in m) == distill
        for k in jm:
            ref = float(jm[k])
            assert abs(float(m[k]) - ref) <= 1e-4 * abs(ref), (k, float(m[k]), ref)
        _check_tree(student.state_dict(), jstate.params, "params")
        _check_tree(state.velocity, jstate.velocity, "velocity")
    # on the CPU the fused losses take the plain twin: no kernel launch counted
    assert (cls_loss_kernel.fwd_launches, cls_loss_kernel.bwd_launches) == before
    assert all(p.dtype == torch.float32 for p in student.parameters())


def test_distill_losses_unfused_equal_fused(setup):
    """train_step.distill_losses (one op per loss) and the fused path give
    the same distillation metrics on the same outputs."""
    from sad_tpu_torch.train.train_step import distill_losses, fused_distill_losses

    s_arch, t_arch, sp, tp, _, batches = setup
    tc = tmerge(tcfg.Config(), CFG)
    student = load_params(RetinaNet(ModelArch(**dataclasses.asdict(s_arch))), sp)
    teacher = load_params(RetinaNet(ModelArch(**dataclasses.asdict(t_arch))), tp)
    step = make_train_step(tc, student, teacher, n_groups=G)
    batch = batch_to_torch(batches[0], "cpu")
    s_data, t_data = step.inputs(batch)
    probs = step.teacher_probs(t_data)
    out = step.forward(s_data)
    _, fused = fused_distill_losses(tc, out, probs, batch, G)
    _, plain = distill_losses(tc, out, probs, batch, G)
    for k, v in plain.items():
        got, ref = float(fused[k].detach()), float(v.detach())
        assert abs(got - ref) <= 1e-5 * abs(ref), k


def test_model_outputs_and_dtypes():
    """Heads give contiguous NHWC float32 maps; only the requested outputs
    are computed; with bf16 compute the parameters and their gradients stay
    float32."""
    arch = ModelArch(**dataclasses.asdict(graft._tiny_arch(compute_dtype="bfloat16")))
    model = RetinaNet(arch)
    x = torch.randn(2, 128, 128, 3)
    out = model(x, outputs=("cls_logits", "bbox_pred"))
    assert sorted(out) == ["bbox_pred", "cls_logits"]
    for lvl in arch.levels:
        for key in out:
            t = out[key][lvl]
            assert t.dtype == torch.float32 and t.is_contiguous() and t.shape[1:3] == (
                128 >> lvl, 128 >> lvl)
    loss = sum(v.float().pow(2).mean() for v in out["cls_logits"].values())
    head = model.head.retnet_cls_pred_fpn3.weight
    (g,) = torch.autograd.grad(loss, head)
    assert head.dtype == g.dtype == torch.float32
    probs = model(x, outputs=("cls_prob",))
    assert sorted(probs) == ["cls_prob"]
    with pytest.raises(ValueError, match="unknown"):
        model(x, outputs=("features",))


def test_seeded_train_step_harness_on_cpu():
    """The harness that chip_smoke.py and profile_train drive on the card,
    at full depth but the smallest canvas (one coarsest stride each way)
    and a sixteenth of the width, on the CPU: a batch from
    RetinaNetMinibatchBuilder, finite losses, parameters that move, frozen
    ones and the teacher unchanged."""
    from sad_tpu_torch.tools.profile_train import seeded_train_step

    run = seeded_train_step(seed=0, n_groups=2, device="cpu", opts=[
        "TRAIN.SCALES", "(128,)", "TRAIN.MAX_SIZE", "128", "RESNETS.CHANNEL_RATIO", "0.0625",
        "COMPUTE_DTYPE", "float32"])
    assert tuple(run.batch["data_u8"].shape) == (4, 128, 128, 3)
    assert run.batch["fg_num"].shape == (2,) and float(run.batch["fg_num"].min()) > 0
    params = dict(run.student.named_parameters())
    snap = {n: p.detach().clone() for n, p in params.items()}
    t_snap = [p.detach().clone() for p in run.teacher.parameters()]
    for _ in range(2):
        m = run.step(run.state, run.batch, 1e-3)
        assert np.isfinite(float(m["loss"]))
    trainable = set(run.step.names)
    assert all(not torch.equal(params[n], snap[n]) for n in trainable)
    assert all(torch.equal(params[n], snap[n]) for n in params if n not in trainable)
    assert all(torch.equal(p, q) for p, q in zip(run.teacher.parameters(), t_snap))
