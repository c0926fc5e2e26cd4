"""Detection loss ops with the reference's published backwards (ref:
sad_tpu/ops/losses.py:67-344; caffe2/modules/detectron/*.cu).

- ``sigmoid_focal_loss`` (sigmoid_focal_loss_op.cu:25-110),
- ``sigmoid_adaptive_distill_loss``, the SAD loss
  (sigmoid_adaptive_distillation_loss_op.cu:28-105),
- ``pow_sum``, the adaptive normalizer (pow_sum_op.cu:26-43),
- ``select_smooth_l1_loss``, dense and masked
  (select_smooth_l1_loss_op.cu:23-96).

The first two and the last are ``torch.autograd.Function``s whose backwards
transcribe the published CUDA backwards, not autograd of the forward: the
distillation backward folds alpha in differently from its forward, and the
two differ inside the forward's FLT_MIN clamp (tests/test_gradient_checks.py).
Gradients reach the logits / box predictions only; the teacher probs,
labels, targets and normalizers get none (the reference's gradient makers
pass GI(0) only, sigmoid_adaptive_distillation_loss_op.cc:99-112).

Layout, as in sad_tpu: logits and teacher probs ``(..., A, C)``, labels
``(..., A)`` int (-1 ignore / 0 bg / 1..C fg). A 0-d normalizer gives a
scalar loss over everything. A ``(G,)`` normalizer takes the first axis of
the other inputs as G groups (what ``jax.vmap`` over groups does in
sad_tpu.train.train_step) and gives the ``(G,)`` per-group losses.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

FLT_MIN = torch.finfo(torch.float32).tiny


def _stable_log1p_exp(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x - 2*x*[x>=0])), the CUDA kernels' stable-BCE idiom."""
    ge = (x >= 0).float()
    return torch.log(1.0 + torch.exp(x - 2.0 * x * ge))


def _stable_log_one_minus_p(x: torch.Tensor) -> torch.Tensor:
    """log(1 - sigmoid(x)), computed stably as in the CUDA kernels."""
    ge = (x >= 0).float()
    return -x * ge - _stable_log1p_exp(x)


def _group_norm(normalizer, x: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """max(normalizer, 1) shaped to broadcast over x, and whether the loss
    is per group."""
    n = torch.as_tensor(normalizer, dtype=torch.float32, device=x.device)
    if n.dim() > 1:
        raise ValueError(f"normalizer must be a scalar or (G,), got {tuple(n.shape)}")
    np_ = torch.clamp_min(n, 1.0)
    return np_.reshape(n.shape + (1,) * (x.dim() - n.dim())), n.dim() == 1


def _reduce(losses: torch.Tensor, grouped: bool) -> torch.Tensor:
    return losses.flatten(1).sum(1) if grouped else losses.sum()


def _expand_grad(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return g.float().reshape(g.shape + (1,) * (x.dim() - g.dim()))


def _class_masks(x: torch.Tensor, labels: torch.Tensor):
    """c1 = [label == class + 1], c2 = [label != -1 and label != class + 1]."""
    t = labels[..., None].to(torch.int32)
    d = torch.arange(x.shape[-1], dtype=torch.int32, device=x.device)
    c1 = (t == d + 1).float()
    c2 = ((t != -1) & (t != d + 1)).float()
    return c1, c2


class SigmoidFocalLoss(torch.autograd.Function):
    """RetinaNet sigmoid focal loss, summed then scaled."""

    @staticmethod
    def forward(ctx, logits, labels, normalizer, gamma: float, alpha: float, scale: float):
        x = logits.float()
        c1, c2 = _class_masks(x, labels)
        np_, grouped = _group_norm(normalizer, x)
        zn, zp = (1.0 - alpha) / np_, alpha / np_
        p = torch.sigmoid(x)
        term1 = torch.pow(1.0 - p, gamma) * torch.log(torch.clamp_min(p, FLT_MIN))
        term2 = torch.pow(p, gamma) * _stable_log_one_minus_p(x)
        losses = -c1 * term1 * zp - c2 * term2 * zn
        ctx.save_for_backward(logits, labels, torch.as_tensor(normalizer, device=x.device))
        ctx.consts = (gamma, alpha, scale)
        return scale * _reduce(losses, grouped)

    @staticmethod
    def backward(ctx, g):
        logits, labels, normalizer = ctx.saved_tensors
        gamma, alpha, scale = ctx.consts
        x = logits.float()
        c1, c2 = _class_masks(x, labels)
        np_, _ = _group_norm(normalizer, x)
        zn, zp = (1.0 - alpha) / np_, alpha / np_
        p = torch.sigmoid(x)
        # sigmoid_focal_loss_op.cu:94-107, as published
        term1 = torch.pow(1.0 - p, gamma) * (
            1.0 - p - p * gamma * torch.log(torch.clamp_min(p, FLT_MIN)))
        term2 = torch.pow(p, gamma) * (_stable_log_one_minus_p(x) * (1.0 - p) * gamma - p)
        dx = (-c1 * zp * term1 - c2 * zn * term2) * _expand_grad(g, x)
        return (scale * dx).to(logits.dtype), None, None, None, None, None


def sigmoid_focal_loss(logits, labels, normalizer, gamma: float, alpha: float,
                       scale: float) -> torch.Tensor:
    """Ref: sigmoid_focal_loss_op.cu:25-66; wired at retinanet_heads.py:281-291."""
    return SigmoidFocalLoss.apply(logits, labels, normalizer, gamma, alpha, scale)


def _distill_d(x: torch.Tensor, pt: torch.Tensor, beta: float) -> torch.Tensor:
    """D = BCE(x, pt) + beta * (-H(pt)), with pt clamped for the entropy."""
    ge = (x >= 0).float()
    bce = -x * (pt - ge) + torch.log(torch.clamp_min(1.0 + torch.exp(x - 2.0 * x * ge), FLT_MIN))
    if beta != 0.0:
        # the reference computes pt*log(pt) unguarded (finite only because the
        # shipped configs have beta = 0); clamp pt away from {0, 1}
        ptc = torch.clamp(pt, FLT_MIN, 1.0 - 1e-7)
        bce = bce + beta * (ptc * torch.log(ptc) + (1.0 - ptc) * torch.log(1.0 - ptc))
    return bce


class SigmoidAdaptiveDistillLoss(torch.autograd.Function):
    """Adaptive distillation loss, summed then scaled; published backward."""

    @staticmethod
    def forward(ctx, logits, teacher_probs, labels, normalizer, gamma: float, alpha: float,
                beta: float, ignored_label: int, scale: float):
        x = logits.float()
        pt = teacher_probs.float()
        mask = (labels[..., None] != ignored_label).float()
        np_, grouped = _group_norm(normalizer, x)
        zn, zp = (1.0 - alpha) / np_, alpha / np_
        p = torch.sigmoid(x)
        q = 1.0 - torch.exp(-_distill_d(x, pt, beta))
        losses = (-torch.pow(q, gamma)
                  * (pt * torch.log(torch.clamp_min(p, FLT_MIN)) * zp
                     + (1.0 - pt) * _stable_log_one_minus_p(x) * zn)
                  * mask)
        ctx.save_for_backward(logits, teacher_probs, labels,
                              torch.as_tensor(normalizer, device=x.device))
        ctx.consts = (gamma, alpha, beta, ignored_label, scale)
        return scale * _reduce(losses, grouped)

    @staticmethod
    def backward(ctx, g):
        logits, teacher_probs, labels, normalizer = ctx.saved_tensors
        gamma, alpha, beta, ignored_label, scale = ctx.consts
        x = logits.float()
        pt = teacher_probs.float()
        mask = (labels[..., None] != ignored_label).float()
        np_, _ = _group_norm(normalizer, x)
        p = torch.sigmoid(x)
        # sigmoid_adaptive_distillation_loss_op.cu:92-102 as published: alpha
        # enters DLoss folded differently from the forward
        exp_dl = torch.exp(-_distill_d(x, pt, beta))
        q = 1.0 - exp_dl
        d_loss = (alpha * pt * torch.log(torch.clamp_min(p, FLT_MIN))
                  + (1.0 - alpha) * (1.0 - pt) * _stable_log_one_minus_p(x))
        dx = (-(-(pt - p) * gamma * torch.pow(q, gamma - 1.0) * exp_dl * d_loss
                + torch.pow(q, gamma) * (alpha * (pt - p) - (1.0 - 2.0 * alpha) * (1.0 - pt) * p))
              * _expand_grad(g, x) * mask) / np_
        return (scale * dx).to(logits.dtype), None, None, None, None, None, None, None, None


def sigmoid_adaptive_distill_loss(logits, teacher_probs, labels, normalizer, gamma: float,
                                  alpha: float, beta: float, ignored_label: int,
                                  scale: float) -> torch.Tensor:
    """Per element: D = BCE(x, pt) + beta*(-H(pt)); q = 1 - exp(-D);
    loss = -q^gamma * (pt*log p * alpha/Np + (1-pt)*log(1-p) * (1-alpha)/Np),
    zero where the anchor label is ignored_label; summed and scaled by
    ``scale`` (= loss_scale * T^2, retinanet_heads.py:342)."""
    return SigmoidAdaptiveDistillLoss.apply(logits, teacher_probs, labels, normalizer,
                                            gamma, alpha, beta, ignored_label, scale)


def pow_sum(inputs: Sequence[torch.Tensor], power: float, n_groups: int = 0) -> torch.Tensor:
    """Sum over all inputs of ``x ** power``: a scalar, or with ``n_groups``
    the (G,) sums of each input's first axis cut into G equal groups.
    Plain autograd, as in sad_tpu: its inputs are the detached teacher probs."""
    total = 0.0
    for arr in inputs:
        powed = torch.pow(arr.float(), power)
        total = total + (powed.reshape(n_groups, -1).sum(1) if n_groups else powed.sum())
    return total


def _huber(val: torch.Tensor, beta: float) -> torch.Tensor:
    a = val.abs()
    return torch.where(a < beta, 0.5 * val * val / beta, a - 0.5 * beta)


class SelectSmoothL1Loss(torch.autograd.Function):
    """Smooth-L1 over the fg anchors, normalized by the fg count."""

    @staticmethod
    def forward(ctx, bbox_pred, bbox_targets, fg_mask, fg_num, beta: float, scale: float):
        pred = bbox_pred.float()
        m = fg_mask.float()[..., None]
        s, grouped = _group_norm(fg_num, pred)
        losses = _huber(pred - bbox_targets.float(), beta) / s * m
        ctx.save_for_backward(bbox_pred, bbox_targets, fg_mask,
                              torch.as_tensor(fg_num, device=pred.device))
        ctx.consts = (beta, scale)
        return scale * _reduce(losses, grouped)

    @staticmethod
    def backward(ctx, g):
        bbox_pred, bbox_targets, fg_mask, fg_num = ctx.saved_tensors
        beta, scale = ctx.consts
        val = bbox_pred.float() - bbox_targets.float()
        m = fg_mask.float()[..., None]
        s, _ = _group_norm(fg_num, val)
        # f'(x) = x/beta if |x| < beta else sign(x) (select_smooth_l1_loss_op.cu:63-84)
        dval = torch.where(val.abs() < beta, val / beta, torch.sign(val))
        dx = scale * _expand_grad(g, val) * dval / s * m
        return dx.to(bbox_pred.dtype), None, None, None, None, None


def select_smooth_l1_loss(bbox_pred, bbox_targets, fg_mask, fg_num, beta: float,
                          scale: float) -> torch.Tensor:
    """The reference gathers the M fg rows (select_smooth_l1_loss_op.cu:23-48);
    the dense masked form gives the same total, as in sad_tpu."""
    return SelectSmoothL1Loss.apply(bbox_pred, bbox_targets, fg_mask, fg_num, beta, scale)
