"""The fused classification losses of the port (ops/fused_losses.py) on the
CPU, where FusedClsLossesRaw takes the plain twin of the CUDA kernels,
against sad_tpu's fused_cls_losses_raw with its Pallas kernels interpreted:
the per-group raw sums (focal, distillation, PowSum on and off) and the
logits' gradient from jax.vjp, on the aligned-tile geometry (PACK=8, a tile
that divides the rows of a group) and on the masked partial-tile one, with
integer and non-integer gammas, beta != 0, an ignored label that is a class
and logits inside the FLT_MIN clamp.

Tolerances: sums within 1e-5 relative (float32 sums in different orders);
dx element-wise within 1e-5 * max|dx| (the same float32 formulas)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sad_tpu.ops.pallas_losses import _choose_tile, _pack_factor, fused_cls_losses_raw
from sad_tpu_torch.ops import cls_loss_kernel
from sad_tpu_torch.ops.cls_loss_kernel import ClsLossParams
from sad_tpu_torch.ops.fused_losses import (
    FusedClsLossesRaw, cls_losses_bwd_plain, cls_losses_fwd_plain, fused_cls_losses_raw_plain,
)

FLAGSHIP = ClsLossParams(2.0, 0.25, 2.0, 0.5, 0.0, -1, 1.8, True)
VARIANTS = {
    "flagship": FLAGSHIP,
    "powsum_off": FLAGSHIP._replace(want_powsum=False),
    "gamma_1.5_2.5": FLAGSHIP._replace(gamma_f=1.5, gamma_d=2.5),
    "beta_0.5": FLAGSHIP._replace(beta_d=0.5),
    "ignored_5_gamma_3_1": FLAGSHIP._replace(ignored_label=5, gamma_f=3.0, gamma_d=1.0),
}
# (N, H, W, A), G: the aligned path (512 rows, PACK 8, tile 32) and the
# masked partial-tile one (P7-like, 90 rows a group, PACK 1, no tile)
GEOMETRIES = {"aligned": ((2, 8, 8, 4), 2), "partial_tile": ((4, 5, 9, 1), 2),
              "one_group": ((3, 5, 7, 3), 1)}


def _case(seed, shape, clamp=True):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape, 80) * 3).astype(np.float32)
    if clamp:
        hit = rng.uniform(size=x.shape) < 0.05
        x[hit] = np.sign(x[hit]) * rng.uniform(90, 110, hit.sum())
    pt = rng.uniform(1e-3, 1 - 1e-3, shape + (80,)).astype(np.float32)
    labels = rng.randint(-1, 81, shape).astype(np.int32)
    return x, pt, labels


def _jax_raw(x, pt, labels, g, p):
    return fused_cls_losses_raw(jnp.asarray(x), jnp.asarray(pt), jnp.asarray(labels), g,
                                p.gamma_f, p.alpha_f, p.gamma_d, p.alpha_d, p.beta_d,
                                p.ignored_label, p.logits_power, p.want_powsum)


def _rel_close(got, ref, rel=1e-5):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.all(np.abs(got - ref) <= rel * np.abs(ref) + 1e-30), (got, ref)


def _max_close(got, ref, rel=1e-5):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


def test_geometries_take_both_pallas_paths():
    (shape, g), (pshape, pg) = GEOMETRIES["aligned"], GEOMETRIES["partial_tile"]
    m = int(np.prod(shape))
    assert _pack_factor(m, g) == 8 and _choose_tile(m // 8 // g) is not None
    pm = int(np.prod(pshape))
    assert _pack_factor(pm, pg) == 1 and _choose_tile(pm // pg) is None


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_forward_and_vjp_match_pallas(geometry, variant):
    shape, g = GEOMETRIES[geometry]
    p = VARIANTS[variant]
    x, pt, labels = _case(sorted(GEOMETRIES).index(geometry) * 10
                          + sorted(VARIANTS).index(variant), shape)
    cot = np.random.RandomState(1).uniform(0.5, 1.5, (2, g)).astype(np.float32)

    jout, vjp = jax.vjp(lambda xx: _jax_raw(xx, pt, labels, g, p), jnp.asarray(x))
    (jdx,) = vjp((jnp.asarray(cot[0]), jnp.asarray(cot[1]), jnp.zeros(g, jnp.float32)))

    xt = torch.from_numpy(x).requires_grad_(True)
    out = FusedClsLossesRaw.apply(xt, torch.from_numpy(pt), torch.from_numpy(labels), g, p)
    for got, ref in zip(out, jout):
        assert got.shape == (g,) and got.dtype == torch.float32
        _rel_close(got.detach().numpy(), ref)
    if not p.want_powsum:
        assert not out[2].any()
    (dx,) = torch.autograd.grad(out[0] @ torch.from_numpy(cot[0])
                                + out[1] @ torch.from_numpy(cot[1]), xt)
    assert dx.shape == x.shape
    _max_close(dx.numpy(), jdx)


def test_plain_twin_functions_and_per_group_sums():
    """The twin's forward is per group: group g's sums equal a one-group
    call on its rows; its backward takes each group's cotangent."""
    x, pt, labels = _case(7, (4, 6, 6, 9))
    c = lambda v: torch.from_numpy(v.reshape(-1, 80) if v.ndim == 5 else v.reshape(-1))  # noqa: E731
    xs, ps, ts = c(x), c(pt), c(labels)
    sums = cls_losses_fwd_plain(xs, ps, ts, 4, FLAGSHIP)
    rows = xs.shape[0] // 4
    for i in range(4):
        sl = slice(i * rows, (i + 1) * rows)
        one = cls_losses_fwd_plain(xs[sl], ps[sl], ts[sl], 1, FLAGSHIP)
        np.testing.assert_allclose(sums[i].numpy(), one[0].numpy(), rtol=1e-6)
    gf, gd = torch.tensor([1.0, 0.0, 2.0, 0.5]), torch.tensor([0.0, 1.0, 0.25, 3.0])
    dx = cls_losses_bwd_plain(xs, ps, ts, gf, gd, FLAGSHIP)
    for i in range(4):
        sl = slice(i * rows, (i + 1) * rows)
        one = cls_losses_bwd_plain(xs[sl], ps[sl], ts[sl], gf[i:i + 1], gd[i:i + 1], FLAGSHIP)
        assert torch.equal(dx[sl], one)


def test_no_gradient_to_teacher_probs_or_powsum():
    x, pt, labels = _case(3, (2, 4, 4, 9))
    xt = torch.from_numpy(x).requires_grad_(True)
    ptt = torch.from_numpy(pt).requires_grad_(True)
    focal, distill, powsum = fused_cls_losses_raw_plain(xt, ptt, torch.from_numpy(labels), 2,
                                                        FLAGSHIP)
    assert not powsum.requires_grad
    gx, gp = torch.autograd.grad((focal + distill).sum(), (xt, ptt), allow_unused=True)
    assert gx is not None and gp is None


def test_kernel_wrappers_refuse_cpu_tensors():
    x, pt, labels = (torch.zeros((8, 80)), torch.zeros((8, 80)),
                     torch.zeros((8,), dtype=torch.int32))
    before = (cls_loss_kernel.fwd_launches, cls_loss_kernel.bwd_launches)
    with pytest.raises(ValueError, match="CUDA"):
        cls_loss_kernel.cls_losses_fwd(x, pt, labels, 2, FLAGSHIP)
    with pytest.raises(ValueError, match="CUDA"):
        cls_loss_kernel.cls_losses_bwd(x, pt, labels, torch.ones(2), torch.ones(2), FLAGSHIP)
    assert (cls_loss_kernel.fwd_launches, cls_loss_kernel.bwd_launches) == before


def test_fused_dispatch_has_no_path_for_other_devices():
    meta = lambda *s, **k: torch.zeros(*s, device="meta", **k)  # noqa: E731
    with pytest.raises(ValueError, match="no path"):
        FusedClsLossesRaw.apply(meta((2, 3, 80)), meta((2, 3, 80)),
                                meta((2, 3), dtype=torch.int32), 2, FLAGSHIP)


@pytest.mark.parametrize("gamma,want", [(2.0, 2), (0.0, 0), (4.0, 4), (1.5, -1), (5.0, -1),
                                        (-1.0, -1)])
def test_int_gamma_follows_ipow_or_pow(gamma, want):
    assert cls_loss_kernel.int_gamma(gamma) == want
