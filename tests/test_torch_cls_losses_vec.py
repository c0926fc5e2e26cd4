"""A numpy transcription of the partition and arithmetic of the cls-loss
kernels (sad_tpu_torch/csrc/cls_losses.cu), which cannot run on the CPU:
- the partition: group g's rows*C elements in chunks of VEC floats (4 when
  C % 4 == 0, 1 for the scalar instance), block b of a group taking in its
  iteration i the chunks (b + i*bpg)*tile + u*THREADS + thread, with the
  blocks per group of ``launch_geometry`` and the multiply-high division
  that finds a chunk's row;
- the sums: each thread's iteration of 16 terms summed in float32 in (u, v)
  order, added into float64, the block's threads and the group's blocks
  summed in float64; the gamma-2 arithmetic (fmaf, selects for the label's
  class, pt^power as exp2(power * log2(pt)); numpy's float32 quotient,
  exp2 and log2 stand for the card's refined reciprocal and MUFU ex2/lg2)
  and the published backward.
Checked: every element of every group is taken exactly once, no chunk
straddles a row or a group, and the transcribed sums and dx agree with the
plain twin (ops/fused_losses.py) and with sad_tpu's fused_cls_losses_raw,
its Pallas kernels interpreted as tests/test_torch_fused_losses.py runs them.

Tolerances: sums within 1e-5 relative (float32 terms summed in other
orders); dx within 1e-5 * max|dx| (fmaf and exp2/log2 round differently from
the twin's separate multiplies and powf, by an ulp or so)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sad_tpu.ops.pallas_losses import fused_cls_losses_raw
from sad_tpu_torch.ops import cls_loss_kernel as K
from sad_tpu_torch.ops.fused_losses import cls_losses_bwd_plain, cls_losses_fwd_plain

FLAGSHIP = K.ClsLossParams(2.0, 0.25, 2.0, 0.5, 0.0, -1, 1.8, True)
LOG_FLT_MIN = np.float32(-87.33654475)
F32 = np.float32

# (rows per group, G, C, vec): P7 of a bs 8 step, rows that fill no block,
# one group, C = 20 and 8 (16-byte chunks), C = 9 and an unaligned view
# (the scalar instance)
GEOMETRIES = {
    "P7_bs8": (720, 4, 80, 4),
    "odd_rows": (1013, 3, 80, 4),
    "one_group": (4099, 1, 80, 4),
    "C20": (401, 2, 20, 4),
    "C8": (5, 2, 8, 4),
    "C9_scalar": (1001, 3, 9, 1),
    "unaligned_scalar": (301, 2, 80, 1),
}


def find_divisor(d):
    """The source's find_divisor: e / d = (e * mul) >> 32 >> shr for e < 2^31."""
    if d <= 1:
        return 0, 0
    p = 31 + int(np.ceil(np.log2(d)))
    return (2**p + d - 1) // d, p - 32


def row_of(e, c):
    mul, shr = find_divisor(c)
    if c == 1:
        return e
    return ((e.astype(np.uint64) * np.uint64(mul)) >> np.uint64(32 + shr)).astype(np.int64)


def partition(rows_per_group, n_groups, c, vec):
    """Chunk index j (or -1 past the end) at [b, i, u, thread] for one group,
    the group's n chunks and its blocks."""
    n = rows_per_group * c // vec
    u_count = K.ELEMS_PER_THREAD // vec
    tile = u_count * K.THREADS
    bpg = K.launch_geometry(rows_per_group, n_groups, c)
    iters = -(-n // (bpg * tile))
    b, i, u, t = np.meshgrid(np.arange(bpg), np.arange(iters), np.arange(u_count),
                             np.arange(K.THREADS), indexing="ij")
    j = (b + i * bpg) * tile + u * K.THREADS + t
    return np.where(j < n, j, -1), n, bpg


def _fma(a, b, c):
    return (a.astype(np.float64) * b + c).astype(F32)


def element_terms(x, pt, t, k1, p):
    """The gamma-2 instance's per-element focal, distill and PowSum terms and
    dx (with unit cotangents), float32."""
    with np.errstate(over="ignore", divide="ignore", invalid="ignore"):
        pos = x >= 0
        e = np.exp(-np.abs(x)).astype(F32)
        one_pe = F32(1) + e
        log1pe = np.log(one_pe).astype(F32)
        prob = (np.where(pos, F32(1), e) / one_pe).astype(F32)
        log_1mp = np.where(pos, -x, F32(0)) - log1pe
        log_p = np.maximum(x + log_1mp, LOG_FLT_MIN)
        d = _fma(-x, pt - pos.astype(F32), log1pe)
        exp_neg_d = np.exp(-d).astype(F32)
        q = F32(1) - exp_neg_d
        omp = F32(1) - prob
        c1, c2 = t == k1, (t != -1) & (t != k1)
        a_f = F32(p.alpha_f)
        focal = np.where(c1, (-a_f * (omp * omp)) * log_p,
                         np.where(c2, -(((F32(1) - a_f) * (prob * prob)) * log_1mp), F32(0)))
        a_d = F32(p.alpha_d)
        dlt = _fma(a_d * pt, log_p, ((F32(1) - a_d) * (F32(1) - pt)) * log_1mp)
        keep = t != p.ignored_label
        distill = np.where(keep, -((q * q) * dlt), F32(0))
        pows = (np.exp2(F32(p.logits_power) * np.log2(pt)).astype(F32) if p.want_powsum
                else np.zeros_like(pt))
        term1 = (omp * omp) * (omp - (prob * F32(2)) * log_p)
        term2 = (prob * prob) * ((log_1mp * omp) * F32(2) - prob)
        dx_f = np.where(c1, -a_f * term1, np.where(c2, -((F32(1) - a_f) * term2), F32(0)))
        pmp = pt - prob
        a = (((-pmp * F32(2)) * q) * exp_neg_d) * dlt
        bb = _fma(np.full_like(pmp, a_d), pmp,
                  -(((F32(1) - F32(2) * a_d) * (F32(1) - pt)) * prob))
        dx_d = np.where(keep, -_fma(q * q, bb, a), F32(0))
    return focal.astype(F32), distill.astype(F32), pows, dx_f.astype(F32), dx_d.astype(F32)


def transcribe(x, pt, labels, n_groups, p, vec, gf, gd):
    """(G, 3) sums and dx as the kernels compute them."""
    m, c = x.shape
    rpg = m // n_groups
    jmap, n, _ = partition(rpg, n_groups, c, vec)
    sums = np.zeros((n_groups, 3), np.float64)
    dx = np.full(x.shape, np.nan, F32)
    for g in range(n_groups):
        xg, pg = x[g * rpg:(g + 1) * rpg].reshape(-1), pt[g * rpg:(g + 1) * rpg].reshape(-1)
        lg = labels[g * rpg:(g + 1) * rpg]
        ok = jmap >= 0
        e = np.where(ok, jmap, 0)[..., None] * vec + np.arange(vec)  # [b, i, u, thread, v]
        row = row_of(e, c)
        terms = element_terms(xg[e], pg[e], lg[row], e - row * c + 1, p)
        ok = np.broadcast_to(ok[..., None], e.shape)
        acc = np.zeros(e.shape[:2] + e.shape[3:4] + (3,), F32)  # [b, i, thread, k]
        for u in range(e.shape[2]):
            for v in range(vec):
                for k in range(3):
                    acc[..., k] += np.where(ok[:, :, u, :, v], terms[k][:, :, u, :, v], F32(0))
        sums[g] = acc.astype(np.float64).sum(axis=1).sum(axis=1).sum(axis=0)
        dxg = dx[g * rpg:(g + 1) * rpg].reshape(-1)
        dxg[e[ok]] = (terms[3] * F32(gf[g]) + terms[4] * F32(gd[g]))[ok]
    return sums.astype(F32), dx


def _case(seed, rows, c):
    rng = np.random.RandomState(seed)
    x = (rng.randn(rows, c) * 3).astype(F32)
    hit = rng.uniform(size=x.shape) < 0.05
    x[hit] = np.sign(x[hit]) * rng.uniform(90, 110, hit.sum())
    pt = rng.uniform(1e-3, 1 - 1e-3, (rows, c)).astype(F32)
    labels = rng.randint(-1, c + 1, rows).astype(np.int32)
    return x, pt, labels


def _rel_close(got, ref, rel=1e-5):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.all(np.abs(got - ref) <= rel * np.abs(ref) + 1e-30), (got, ref)


def _max_close(got, ref, rel=1e-5):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape and np.isfinite(got).all()
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_partition_takes_every_element_once_and_no_chunk_straddles(geometry):
    rpg, g, c, vec = GEOMETRIES[geometry]
    jmap, n, bpg = partition(rpg, g, c, vec)
    taken = np.sort(jmap[jmap >= 0])
    assert np.array_equal(taken, np.arange(n))  # every chunk of the group once
    assert n * vec == rpg * c  # the group's chunks end at its last element
    e = taken * vec
    row = row_of(e, c)
    assert np.array_equal(row, e // c)
    assert np.array_equal(row_of(e + vec - 1, c), row)  # no chunk straddles a row
    assert row.max() < rpg  # nor a group: group g's chunks index its own rows
    assert 1 <= bpg <= max(1, K.TARGET_BLOCKS // g)


@pytest.mark.parametrize("c", [1, 2, 3, 7, 8, 9, 20, 80, 81, 128, 1000, 65537])
def test_multiply_high_division_is_exact_below_2_31(c):
    rng = np.random.RandomState(c)
    e = np.concatenate([np.arange(4096), rng.randint(0, 2**31, 100000),
                        2**31 - 1 - np.arange(4096)]).astype(np.int64)
    mul, _ = find_divisor(c)
    assert mul < 2**32
    assert np.array_equal(row_of(e, c), e // c)


def test_kernel_instance_picks_width_and_arithmetic():
    p = FLAGSHIP
    assert K.kernel_instance(80, 256, 1024, p) == (4, K.GAMMA2_POW)
    assert K.kernel_instance(80, 256, 1028, p) == (1, K.GAMMA2_POW)  # pt 4 bytes off
    assert K.kernel_instance(9, 256, 1024, p) == (1, K.GAMMA2_POW)
    assert K.kernel_instance(20, 0, 16, p._replace(want_powsum=False)) == (4, K.GAMMA2_NOPOW)
    for q in (p._replace(beta_d=0.5), p._replace(gamma_f=1.5), p._replace(gamma_d=3.0),
              p._replace(logits_power=0.0), p._replace(logits_power=0.5)):
        assert K.kernel_instance(80, 0, 0, q) == (4, K.GENERIC)
    assert K.kernel_instance(80, 0, 0, p._replace(logits_power=0.0, want_powsum=False)) == (
        4, K.GAMMA2_NOPOW)


@pytest.mark.parametrize("powsum", [True, False])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_transcription_matches_the_plain_twin(geometry, powsum):
    rpg, g, c, vec = GEOMETRIES[geometry]
    p = FLAGSHIP._replace(want_powsum=powsum)
    x, pt, labels = _case(sorted(GEOMETRIES).index(geometry), rpg * g, c)
    cot = np.random.RandomState(1).uniform(0.5, 1.5, (2, g)).astype(F32)
    sums, dx = transcribe(x, pt, labels, g, p, vec, cot[0], cot[1])
    tx, tp, tl = torch.from_numpy(x), torch.from_numpy(pt), torch.from_numpy(labels)
    ref = cls_losses_fwd_plain(tx, tp, tl, g, p).numpy()
    _rel_close(sums[:, :2], ref[:, :2])
    if powsum:
        _rel_close(sums[:, 2], ref[:, 2])
    else:
        assert not sums[:, 2].any() and not ref[:, 2].any()
    dref = cls_losses_bwd_plain(tx, tp, tl, torch.from_numpy(cot[0]), torch.from_numpy(cot[1]),
                                p).numpy()
    _max_close(dx, dref)


@pytest.mark.parametrize("geometry", ["C20", "C8", "C9_scalar", "P7_bs8"])
def test_transcription_matches_pallas(geometry):
    rpg, g, c, vec = GEOMETRIES[geometry]
    rpg = min(rpg, 128)
    p = FLAGSHIP
    x, pt, labels = _case(40 + sorted(GEOMETRIES).index(geometry), rpg * g, c)
    cot = np.random.RandomState(2).uniform(0.5, 1.5, (2, g)).astype(F32)
    sums, dx = transcribe(x, pt, labels, g, p, vec, cot[0], cot[1])

    def raw(xx):
        return fused_cls_losses_raw(xx, jnp.asarray(pt), jnp.asarray(labels), g, p.gamma_f,
                                    p.alpha_f, p.gamma_d, p.alpha_d, p.beta_d, p.ignored_label,
                                    p.logits_power, p.want_powsum)

    jout, vjp = jax.vjp(raw, jnp.asarray(x))
    (jdx,) = vjp((jnp.asarray(cot[0]), jnp.asarray(cot[1]), jnp.zeros(g, jnp.float32)))
    for k in range(3):
        _rel_close(sums[:, k], np.asarray(jout[k]))
    _max_close(dx, np.asarray(jdx))
