"""The port's loss ops (sad_tpu_torch/ops/losses.py), forward and backward,
against the NumPy transcriptions of the reference CUDA ops
(sad_tpu/ops/reference_numpy.py) and against sad_tpu's JAX ops, on the same
numpy inputs. A tenth of the logits sit at |x| > 90, inside the FLT_MIN
clamp of log p, where the published distillation backward differs from the
true derivative (tests/test_gradient_checks.py): the port must follow the
published one.

Tolerances: loss sums within 1e-5 relative (float32 sums in different
orders; the NumPy oracle sums in float64); gradients element-wise within
1e-5 * max|ref| + 1e-12 (the same float32 formulas, rounded by different
libraries)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sad_tpu.ops import losses as J
from sad_tpu.ops import reference_numpy as R
from sad_tpu_torch.ops import losses as T

C = 80


def _case(seed, n=2, h=5, w=6, a=3, clamp=True):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, h, w, a, C) * 3).astype(np.float32)
    if clamp:
        hit = rng.uniform(size=x.shape) < 0.1
        x[hit] = np.sign(x[hit]) * rng.uniform(90, 110, hit.sum())
    pt = rng.uniform(1e-3, 1 - 1e-3, (n, h, w, a, C)).astype(np.float32)
    labels = rng.randint(-1, C + 1, (n, h, w, a)).astype(np.int32)
    return x, pt, labels


def _nchw(x):
    """(N, H, W, A, K) -> the CUDA ops' (N, A*K, H, W)."""
    n, h, w, a, k = x.shape
    return x.reshape(n, h, w, a * k).transpose(0, 3, 1, 2)


def _labels_nchw(t):
    return t.transpose(0, 3, 1, 2)


def _close(got, ref, rel=1e-5):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max() + 1e-12, (err, np.abs(ref).max())


def _grad(fn, *inputs):
    """Loss and d(loss)/d(first input) of a port op, upstream cotangent 1.3."""
    x = torch.from_numpy(inputs[0]).requires_grad_(True)
    loss = fn(x, *[torch.from_numpy(v) if isinstance(v, np.ndarray) else v for v in inputs[1:]])
    (g,) = torch.autograd.grad(loss * 1.3, x)
    return loss.detach().numpy(), g.numpy()


@pytest.mark.parametrize("seed,gamma,alpha", [(0, 2.0, 0.25), (1, 1.5, 0.4)])
def test_focal_loss(seed, gamma, alpha):
    x, _, labels = _case(seed)
    norm, scale = 7.0, 0.5
    loss, dx = _grad(lambda xx, tt: T.sigmoid_focal_loss(xx, tt, norm, gamma, alpha, scale),
                     x, labels)
    ref, _ = R.sigmoid_focal_loss_fwd(_nchw(x), _labels_nchw(labels), norm, gamma, alpha, C, scale)
    rdx = R.sigmoid_focal_loss_bwd(_nchw(x), _labels_nchw(labels), norm, gamma, alpha, C, scale, 1.3)
    _close(loss, ref)
    _close(_nchw(dx), rdx)
    jl, jg = jax.value_and_grad(lambda xx: 1.3 * J.sigmoid_focal_loss(
        xx, jnp.asarray(labels), norm, gamma, alpha, scale))(jnp.asarray(x))
    _close(1.3 * loss, jl)
    _close(dx, jg)


@pytest.mark.parametrize("seed,gamma,alpha,beta,ignored", [
    (0, 2.0, 0.5, 0.0, -1), (1, 2.5, 0.3, 0.5, 3), (2, 1.0, 0.5, 0.0, 0)])
def test_adaptive_distill_loss(seed, gamma, alpha, beta, ignored):
    x, pt, labels = _case(seed)
    norm, scale = 423.5, 0.25
    loss, dx = _grad(lambda xx, pp, tt: T.sigmoid_adaptive_distill_loss(
        xx, pp, tt, norm, gamma, alpha, beta, ignored, scale), x, pt, labels)
    args = (_nchw(x), _nchw(pt), _labels_nchw(labels), norm, gamma, alpha, beta, C, ignored, scale)
    ref, _ = R.sigmoid_adaptive_distill_loss_fwd(*args)
    _close(loss, ref)
    if beta == 0.0:  # the oracle's entropy is unclamped, as published; exact only at beta = 0
        _close(_nchw(dx), R.sigmoid_adaptive_distill_loss_bwd(*args, 1.3))
    jl, jg = jax.value_and_grad(lambda xx: 1.3 * J.sigmoid_adaptive_distill_loss(
        xx, jnp.asarray(pt), jnp.asarray(labels), norm, gamma, alpha, beta, ignored,
        scale))(jnp.asarray(x))
    _close(1.3 * loss, jl)
    _close(dx, jg)


def test_grouped_forms_equal_vmap():
    """A (G,) normalizer gives the per-group losses of sad_tpu's vmap."""
    x, pt, labels = _case(5, n=4)
    g = 2
    fg = np.array([5.0, 0.5], np.float32)  # the second is clamped to 1
    dn = np.array([80.0, 120.0], np.float32)
    gv = lambda v: v.reshape((g, v.shape[0] // g) + v.shape[1:])  # noqa: E731
    focal = T.sigmoid_focal_loss(torch.from_numpy(gv(x)), torch.from_numpy(gv(labels)),
                                 torch.from_numpy(fg), 2.0, 0.25, 0.5)
    jf = jax.vmap(lambda xx, tt, nn: J.sigmoid_focal_loss(xx, tt, nn, 2.0, 0.25, 0.5))(
        jnp.asarray(gv(x)), jnp.asarray(gv(labels)), jnp.asarray(fg))
    _close(focal.numpy(), jf)
    dist = T.sigmoid_adaptive_distill_loss(
        torch.from_numpy(gv(x)), torch.from_numpy(gv(pt)), torch.from_numpy(gv(labels)),
        torch.from_numpy(dn), 2.0, 0.5, 0.0, -1, 0.5)
    jd = jax.vmap(lambda xx, pp, tt, nn: J.sigmoid_adaptive_distill_loss(
        xx, pp, tt, nn, 2.0, 0.5, 0.0, -1, 0.5))(
        jnp.asarray(gv(x)), jnp.asarray(gv(pt)), jnp.asarray(gv(labels)), jnp.asarray(dn))
    _close(dist.numpy(), jd)


def test_pow_sum():
    _, p1, _ = _case(3)
    _, p2, _ = _case(4, h=2, w=3)
    got = T.pow_sum([torch.from_numpy(p1), torch.from_numpy(p2)], 1.8)
    _close(got.numpy(), R.pow_sum([p1, p2], 1.8))
    _close(got.numpy(), J.pow_sum([jnp.asarray(p1), jnp.asarray(p2)], 1.8))
    per_group = T.pow_sum([torch.from_numpy(p1), torch.from_numpy(p2)], 1.8, n_groups=2)
    for i in range(2):
        _close(per_group[i].numpy(), R.pow_sum([p1[i:i + 1], p2[i:i + 1]], 1.8))


@pytest.mark.parametrize("beta", [0.11, 1.0])
def test_select_smooth_l1(beta):
    rng = np.random.RandomState(9)
    n, h, w, a = 2, 4, 5, 3
    pred = rng.randn(n, h, w, a, 4).astype(np.float32)
    tgt = (pred + rng.randn(n, h, w, a, 4) * rng.choice([0.05, 1.0], (n, h, w, a, 1))
           ).astype(np.float32)
    mask = rng.uniform(size=(n, h, w, a)) < 0.3
    fg = float(mask.sum())
    loss, dx = _grad(lambda pp, tt, mm: T.select_smooth_l1_loss(pp, tt, mm, fg, beta, 0.5),
                     pred, tgt, mask)
    nn_, yy, xx, aa = np.nonzero(mask)
    locs = np.stack([nn_, aa * 4, yy, xx], 1).astype(np.float32)
    ref, _ = R.select_smooth_l1_loss_fwd(_nchw(pred), tgt[mask], locs, fg, beta, 0.5)
    rdx = R.select_smooth_l1_loss_bwd(_nchw(pred), tgt[mask], locs, fg, beta, 0.5, 1.3)
    _close(loss, ref)
    _close(_nchw(dx), rdx)
    jl, jg = jax.value_and_grad(lambda pp: 1.3 * J.select_smooth_l1_loss(
        pp, jnp.asarray(tgt), jnp.asarray(mask), fg, beta, 0.5))(jnp.asarray(pred))
    _close(1.3 * loss, jl)
    _close(dx, jg)


def test_no_gradient_to_teacher_labels_or_normalizer():
    x, pt, labels = _case(6)
    xt = torch.from_numpy(x).requires_grad_(True)
    ptt = torch.from_numpy(pt).requires_grad_(True)
    norm = torch.tensor(5.0, requires_grad=True)
    loss = T.sigmoid_adaptive_distill_loss(xt, ptt, torch.from_numpy(labels), norm,
                                           2.0, 0.5, 0.0, -1, 1.0)
    gx, gp, gn = torch.autograd.grad(loss, (xt, ptt, norm), allow_unused=True)
    assert gx is not None and gp is None and gn is None
