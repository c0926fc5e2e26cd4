"""The fused classification losses of the SAD step: per-group raw sums of
the focal loss, the adaptive distillation loss and the PowSum normalizer in
one pass over a level's dense grid, and the logits' gradient in one more
(ref: sad_tpu/ops/pallas_losses.py:385-594).

Both published backwards are linear in 1/Np, so the forward emits raw sums
with alpha folded in and 1/Np left out, and the caller applies
``scale * raw / max(norm, 1)`` on (G,) scalars afterwards; the cotangents
that autograd of that combine hands back are per group, and the backward is
one pass too. No gradient reaches the teacher probs (the reference's
gradient maker passes GI(0) only), and d(powsum)/d(logits) is 0.

``FusedClsLossesRaw`` sends CUDA tensors to the kernels
(ops/cls_loss_kernel.py -> csrc/cls_losses.cu) and CPU tensors to the plain
twin of this module (``cls_losses_fwd_plain``/``cls_losses_bwd_plain``,
PyTorch ops with the kernels' arithmetic); any other device raises.
``fused_cls_losses_raw_plain`` takes the plain twin on any device, so that a
run on the card can hold the kernels against it.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from .cls_loss_kernel import ClsLossParams, cls_losses_bwd, cls_losses_fwd, int_gamma

FLT_MIN = torch.finfo(torch.float32).tiny
LOG_FLT_MIN = -87.33654475  # float32(log(FLT_MIN)), as in pallas_losses.py


def _ipow_or_pow(x: torch.Tensor, gamma: float) -> torch.Tensor:
    """x**gamma with integer gammas 0..4 as multiplies (pallas_losses.py:72-83)."""
    g = int_gamma(gamma)
    if g < 0:
        return torch.pow(x, gamma)
    out = torch.ones_like(x)
    if g > 0:
        out = x
        for _ in range(g - 1):
            out = out * x
    return out


def _terms(x, pt, p: ClsLossParams):
    """_elementwise_terms (pallas_losses.py:104-127): p, log p, log(1-p),
    q = 1 - exp(-D) and exp(-D) from one exp, one log and one exp."""
    ge = (x >= 0).float()
    e = torch.exp(-x.abs())
    log1pe = torch.log(1.0 + e)
    prob = (ge + (1.0 - ge) * e) / (1.0 + e)
    log_1mp = -x * ge - log1pe
    log_p = torch.clamp_min(x + log_1mp, LOG_FLT_MIN)
    d = -x * (pt - ge) + log1pe
    if p.beta_d != 0.0:
        c = torch.clamp(pt, FLT_MIN, 1.0 - 1e-7)
        d = d + p.beta_d * (c * torch.log(c) + (1.0 - c) * torch.log(1.0 - c))
    exp_neg_d = torch.exp(-d)
    return prob, log_p, log_1mp, 1.0 - exp_neg_d, exp_neg_d


def _masks(x, labels, p: ClsLossParams):
    t = labels[:, None]
    k = torch.arange(1, x.shape[1] + 1, dtype=labels.dtype, device=x.device)
    c1 = (t == k).float()
    c2 = ((t != -1) & (t != k)).float()
    dmask = (t != p.ignored_label).float()
    return c1, c2, dmask


def cls_losses_fwd_plain(x: torch.Tensor, pt: torch.Tensor, labels: torch.Tensor,
                         n_groups: int, p: ClsLossParams) -> torch.Tensor:
    """The plain twin of the forward kernel: (G, 3) float32 per-group
    (focal_raw, distill_raw, powsum) of (M, C) x and pt and (M,) labels."""
    c1, c2, dmask = _masks(x, labels, p)
    prob, log_p, log_1mp, q, _ = _terms(x, pt, p)
    focal = (-c1 * p.alpha_f * _ipow_or_pow(1.0 - prob, p.gamma_f) * log_p
             - c2 * (1.0 - p.alpha_f) * _ipow_or_pow(prob, p.gamma_f) * log_1mp)
    distill = (-_ipow_or_pow(q, p.gamma_d)
               * (p.alpha_d * pt * log_p + (1.0 - p.alpha_d) * (1.0 - pt) * log_1mp)
               * dmask)
    sums = [focal.reshape(n_groups, -1).sum(1), distill.reshape(n_groups, -1).sum(1)]
    if p.want_powsum:
        sums.append(torch.pow(pt, p.logits_power).reshape(n_groups, -1).sum(1))
    else:
        sums.append(torch.zeros_like(sums[0]))
    return torch.stack(sums, dim=1)


def cls_losses_bwd_plain(x: torch.Tensor, pt: torch.Tensor, labels: torch.Tensor,
                         g_focal: torch.Tensor, g_distill: torch.Tensor,
                         p: ClsLossParams) -> torch.Tensor:
    """The plain twin of the backward kernel: dx (M, C) with the published
    factoring of _bwd_kernel (pallas_losses.py:240-259)."""
    n_groups = g_focal.shape[0]
    c1, c2, dmask = _masks(x, labels, p)
    prob, log_p, log_1mp, q, exp_neg_d = _terms(x, pt, p)
    rows = x.shape[0] // n_groups
    gf = g_focal.float().repeat_interleave(rows)[:, None]
    gd = g_distill.float().repeat_interleave(rows)[:, None]
    term1 = _ipow_or_pow(1.0 - prob, p.gamma_f) * (1.0 - prob - prob * p.gamma_f * log_p)
    term2 = _ipow_or_pow(prob, p.gamma_f) * (log_1mp * (1.0 - prob) * p.gamma_f - prob)
    dx_f = (-c1 * p.alpha_f * term1 - c2 * (1.0 - p.alpha_f) * term2) * gf
    d_loss_term = p.alpha_d * pt * log_p + (1.0 - p.alpha_d) * (1.0 - pt) * log_1mp
    dx_d = (-(-(pt - prob) * p.gamma_d * _ipow_or_pow(q, p.gamma_d - 1.0) * exp_neg_d
              * d_loss_term
              + _ipow_or_pow(q, p.gamma_d)
              * (p.alpha_d * (pt - prob) - (1.0 - 2.0 * p.alpha_d) * (1.0 - pt) * prob))
            * dmask * gd)
    return dx_f + dx_d


def _dispatch(x: torch.Tensor, plain: bool) -> Tuple[Callable, Callable]:
    if plain or x.device.type == "cpu":
        return cls_losses_fwd_plain, cls_losses_bwd_plain
    if x.is_cuda:
        return cls_losses_fwd, cls_losses_bwd
    raise ValueError(f"the fused cls losses have no path for device {x.device}")


def _rows(logits, teacher_probs, labels):
    """(M, C) float32 / (M,) int32 contiguous row views of (..., A, C) /
    (..., A) grids (no copy when they already are)."""
    c = logits.shape[-1]
    if teacher_probs.shape != logits.shape or labels.shape != logits.shape[:-1]:
        raise ValueError(f"logits {tuple(logits.shape)}, teacher probs "
                         f"{tuple(teacher_probs.shape)}, labels {tuple(labels.shape)}")
    return (logits.reshape(-1, c).float().contiguous(),
            teacher_probs.reshape(-1, c).float().contiguous(),
            labels.reshape(-1).to(torch.int32).contiguous())


class FusedClsLossesRaw(torch.autograd.Function):
    """(focal_raw, distill_raw, powsum), each (G,), of one level; dx by the
    backward kernel (or its plain twin)."""

    @staticmethod
    def forward(ctx, logits, teacher_probs, labels, n_groups: int, p: ClsLossParams,
                plain: bool = False):
        x, pt, t = _rows(logits, teacher_probs, labels)
        fwd, _ = _dispatch(x, plain)
        sums = fwd(x, pt, t, n_groups, p)
        ctx.save_for_backward(x, pt, t)
        ctx.consts = (p, plain, logits.shape, logits.dtype)
        powsum = sums[:, 2]
        ctx.mark_non_differentiable(powsum)
        return sums[:, 0], sums[:, 1], powsum

    @staticmethod
    def backward(ctx, g_focal, g_distill, _g_pow):
        x, pt, t = ctx.saved_tensors
        p, plain, shape, dtype = ctx.consts
        _, bwd = _dispatch(x, plain)
        dx = bwd(x, pt, t, g_focal.contiguous(), g_distill.contiguous(), p)
        return dx.reshape(shape).to(dtype), None, None, None, None, None


def fused_cls_losses_raw(logits, teacher_probs, labels, n_groups: int, p: ClsLossParams):
    """Per-group raw sums in one pass: the kernels on the card, the plain
    twin on the CPU. Returns (focal_raw, distill_raw, powsum), each (G,)."""
    return FusedClsLossesRaw.apply(logits, teacher_probs, labels, n_groups, p, False)


def fused_cls_losses_raw_plain(logits, teacher_probs, labels, n_groups: int,
                               p: ClsLossParams):
    """fused_cls_losses_raw through the plain twin on any device."""
    return FusedClsLossesRaw.apply(logits, teacher_probs, labels, n_groups, p, True)
