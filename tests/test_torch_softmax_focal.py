"""RETINANET.SOFTMAX's loss in the port (ops/losses.softmax_focal_loss, a
torch.autograd.Function with the published backward of
softmax_focal_loss_op.cu:96-140) against sad_tpu's custom_vjp
(sad_tpu/ops/detectron_ops.py:338-422) and against a float64 numpy
transcription of the CUDA op, forward and backward, on the same numpy
inputs: ignored anchors (-1), background (0) and every class, logits past
|x| = 90 (p_label under FLT_MIN), a normalizer under 1 (clamped to 1),
per-group normalizers as the train step passes them; then two RetinaNet
train steps with RETINANET.SOFTMAX on against sad_tpu's.

Tolerances: losses within 1e-5 relative, gradients within 1e-5 * max|ref|
(float32 formulas rounded by other libraries; the float64 transcription
is held at the same bounds)."""

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
from sad_tpu.ops.detectron_ops import softmax_focal_loss as j_softmax_focal_loss
from sad_tpu.train import TrainState as JaxTrainState
from sad_tpu.train import make_train_step as j_make_train_step
import sad_tpu_torch.config as tcfg
from sad_tpu_torch.config.config import merge_cfg_from_dict as tmerge
from sad_tpu_torch.convert import load_params, params_to_state_dict
from sad_tpu_torch.models import RetinaNet
from sad_tpu_torch.models.arch import ModelArch
from sad_tpu_torch.ops.losses import softmax_focal_loss
from sad_tpu_torch.train import TrainState, batch_to_torch, make_train_step
from test_torch_losses import _close, _grad
from test_torch_models import one_torch_thread, random_params  # noqa: F401
from test_torch_train_step import CFG, G, LR, _batch, _check_tree

C = 81  # background + 80 classes
FLT_MIN = np.finfo(np.float32).tiny


def _case(seed, n=2, h=5, w=6, a=3):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, h, w, a, C) * 3).astype(np.float32)
    hit = rng.uniform(size=x.shape) < 0.05
    x[hit] = np.sign(x[hit]) * rng.uniform(90, 110, hit.sum())
    kind = rng.choice(3, (n, h, w, a), p=[0.1, 0.6, 0.3])  # ignored / background / a class
    labels = np.where(kind == 2, rng.randint(1, C, kind.shape), kind - 1).astype(np.int32)
    return x, labels


def sfl_numpy(x, labels, norm, gamma, alpha, scale, g):
    """softmax_focal_loss_op.cu's forward (:55-90) and backward (:96-140) in
    float64 numpy; one normalizer for everything."""
    x = x.astype(np.float64)
    e = np.exp(x - x.max(-1, keepdims=True))
    p = e / e.sum(-1, keepdims=True)
    t = labels.astype(np.int64)
    z = np.where(t == 0, (1 - alpha) / max(norm, 1.0), 0.0) + np.where(
        t >= 1, alpha / max(norm, 1.0), 0.0)
    pl = np.take_along_axis(p, np.maximum(t, 0)[..., None], -1)[..., 0]
    logp = np.log(np.maximum(pl, FLT_MIN))
    loss = scale * np.where(t >= 0, -((1 - pl) ** gamma) * logp * z, 0.0).sum()
    buff = np.where(t >= 0, (-((1 - pl) ** gamma) + gamma * (1 - pl) ** (gamma - 1) * pl * logp)
                    * z, 0.0)
    onehot = t[..., None] == np.arange(C)
    return loss, scale * g * buff[..., None] * (onehot - p)


@pytest.mark.parametrize("seed,gamma,alpha,norm", [
    (0, 2.0, 0.25, 7.0), (1, 1.5, 0.4, 30.0), (2, 2.0, 0.25, 0.3), (3, 2.0, 0.25, 0.0)])
def test_softmax_focal_matches_sad_tpu(seed, gamma, alpha, norm):
    x, labels = _case(seed)
    assert (labels == -1).any() and (labels == 0).any()
    scale = 0.5
    loss, dx = _grad(lambda xx, tt: softmax_focal_loss(xx, tt, norm, gamma, alpha, scale),
                     x, labels)
    jl, vjp = jax.vjp(lambda xx: j_softmax_focal_loss(xx, jnp.asarray(labels), norm, gamma,
                                                      alpha, scale), jnp.asarray(x))
    (jg,) = vjp(jnp.float32(1.3))
    _close(loss, jl)
    _close(dx, jg)
    ref, rdx = sfl_numpy(x, labels, norm, gamma, alpha, scale, 1.3)
    _close(loss, ref)
    _close(dx, rdx)
    assert not dx[labels == -1].any()  # ignored anchors get no gradient


def test_softmax_focal_per_group_normalizers():
    """A (G,) normalizer takes the first axis as G groups, as jax.vmap over
    groups does in sad_tpu's train step; one group's normalizer is 0."""
    x, labels = _case(4, n=4)
    x, labels = x.reshape(2, 2, *x.shape[1:]), labels.reshape(2, 2, *labels.shape[1:])
    fg = np.array([5.0, 0.0], np.float32)
    ct = np.array([1.3, 0.7], np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = softmax_focal_loss(xt, torch.from_numpy(labels), torch.from_numpy(fg), 2.0, 0.25, 0.5)
    (dx,) = torch.autograd.grad((got * torch.from_numpy(ct)).sum(), xt)

    def jfn(xx):
        return jax.vmap(lambda a, t, s: j_softmax_focal_loss(a, t, s, 2.0, 0.25, 0.5))(
            xx, jnp.asarray(labels), jnp.asarray(fg))

    jl, vjp = jax.vjp(jfn, jnp.asarray(x))
    (jg,) = vjp(jnp.asarray(ct))
    assert got.shape == (2,)
    _close(got.detach().numpy(), jl)
    _close(dx.numpy(), jg)


def test_two_softmax_steps_match_sad_tpu():
    """The plain RetinaNet step with RETINANET.SOFTMAX (81 logits an anchor)
    against sad_tpu's: metrics, parameters and velocities after each of two
    steps, at the bounds of tests/test_torch_train_step.py."""
    arch = graft._tiny_arch(softmax=True)
    sp = random_params(JaxRetinaNet(arch), np.zeros((1, 128, 128, 3), np.float32), 5)
    rng = np.random.RandomState(6)
    vel = jax.tree_util.tree_map(lambda a: (rng.randn(*a.shape) * 1e-3).astype(np.float32), sp)
    over = {**CFG, "MODEL": {"TYPE": "retinanet", "NUM_CLASSES": 81},
            "RETINANET": {**CFG["RETINANET"], "SOFTMAX": True}}
    jc, tc = jmerge(jcfg.Config(), over), tmerge(tcfg.Config(), over)
    jstep = jax.jit(j_make_train_step(jc, JaxRetinaNet(arch), None, n_groups=G))
    student = load_params(RetinaNet(ModelArch(**dataclasses.asdict(arch))), sp)
    step = make_train_step(tc, student, None, n_groups=G)
    state = TrainState({k: v.clone() for k, v in params_to_state_dict(vel).items()})
    jstate = JaxTrainState(sp, vel)
    for seed in (2, 3):
        batch = _batch(seed)
        jstate, jm = jstep(jstate, {}, jax.tree_util.tree_map(jnp.asarray, batch),
                           jnp.float32(LR))
        m = step(state, batch_to_torch(batch, "cpu"), LR)
        assert sorted(m) == sorted(jm) and "fl_fpn3" in m
        for k in jm:
            ref = float(jm[k])
            assert abs(float(m[k]) - ref) <= 1e-4 * abs(ref), (k, float(m[k]), ref)
        _check_tree(student.state_dict(), jstate.params, "params")
        _check_tree(state.velocity, jstate.velocity, "velocity")
