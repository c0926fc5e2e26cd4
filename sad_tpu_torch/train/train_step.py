"""Training steps: plain RetinaNet and the joint teacher+student SAD step
(ref: sad_tpu/train/train_step.py:50-326).

- Loss normalizers are per group of TRAIN.IMS_PER_BATCH images, as the
  reference computes them per GPU over its 2-image minibatch; every loss is
  scaled by 1/G (detector.py:650-655).
- Over W ranks (parallel/distributed.py) a step holds the rank's G / W
  groups (``n_groups`` is that local count), scales its losses by 1 / G all
  the same (the loss functions' ``total_groups``), and sums the gradients
  over the ranks before the update; the per-group normalizers (fg_num, PowSum) are never reduced
  across ranks.
- The frozen teacher runs under ``torch.no_grad()`` on its own pixel
  normalisation of the same uint8 canvas (minibatch.py:74-82); its probs
  come from its float32 logits.
- The distillation step computes the classification losses through
  ``FusedClsLossesRaw`` (ops/fused_losses.py): per level, the per-group raw
  focal and distillation sums and the PowSum normalizer in one pass (the CUDA
  kernels on the card), then ``scale * raw / max(norm, 1)`` on (G,)
  scalars, sad_tpu's fused factoring (train_step.py:168-234). sad_tpu's
  USE_PALLAS_LOSSES chooses between two numerically identical paths on the
  TPU (tests/test_pallas_losses.py); the port loads the key and ignores it.
  ``distill_losses`` is the unfused form, kept as the reference of the
  fused one. The bbox loss is plain PyTorch, as it is jnp in sad_tpu.
- The update is Caffe2 momentum SGD in place on the student's float32
  parameters and the velocity (train/optimizer.py).

Batch (tensors on the model's device, NHWC):
  data_u8:       (B, H, W, 3) uint8 canvas + content_hw (B, 2) float32, or
  data / teacher_data: (B, H, W, 3) float32, already normalised
  labels:        {lvl: (B, H_l, W_l, A) int32}
  bbox_targets:  {lvl: (B, H_l, W_l, A, 4) float32}
  fg_mask:       {lvl: (B, H_l, W_l, A) bool}
  fg_num:        (G,) float32 per-group fg counts
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..models import bias_mask, trainable_mask
from ..ops.cls_loss_kernel import ClsLossParams
from ..ops.fused_losses import fused_cls_losses_raw
from ..ops.image_norm import content_mask, normalize_u8_on_device
from ..ops.losses import (
    pow_sum, select_smooth_l1_loss, sigmoid_adaptive_distill_loss, sigmoid_focal_loss,
    softmax_focal_loss,
)
from ..parallel.distributed import all_reduce_grads
from .optimizer import init_velocity, momentum_sgd_update

Metrics = Dict[str, torch.Tensor]


@dataclass
class TrainState:
    """The momentum of every student parameter, keyed by parameter name;
    the parameters themselves live in the student module."""

    velocity: Dict[str, torch.Tensor]

    @classmethod
    def create(cls, model: nn.Module) -> "TrainState":
        return cls(init_velocity(model))


def batch_to_torch(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """A batch of numpy arrays (RetinaNetBatch.as_pytree(), or what
    RCNNMinibatchBuilder.build returns) as tensors on ``device``, level dicts
    and plain numbers kept."""
    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, (int, float)):
            return v
        return torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return {k: conv(v) for k, v in batch.items()}


def _group_view(x: torch.Tensor, n_groups: int) -> torch.Tensor:
    """(B, ...) -> (G, B/G, ...)."""
    return x.reshape((n_groups, x.shape[0] // n_groups) + tuple(x.shape[1:]))


def _split_anchor_axis(x: torch.Tensor, num_anchors: int) -> torch.Tensor:
    """(..., A*K) -> (..., A, K)."""
    return x.reshape(tuple(x.shape[:-1]) + (num_anchors, x.shape[-1] // num_anchors))


def _bbox_loss(cfg, student_out, batch, lvl: int, n_groups: int, total_groups: int
               ) -> torch.Tensor:
    """(G,) select-smooth-L1 losses of one level, scaled by
    1 / ``total_groups`` (the groups of every rank)."""
    r = cfg.RETINANET
    pred = _split_anchor_axis(student_out["bbox_pred"][lvl], cfg.num_anchors_per_cell())
    return select_smooth_l1_loss(
        _group_view(pred, n_groups), _group_view(batch["bbox_targets"][lvl], n_groups),
        _group_view(batch["fg_mask"][lvl], n_groups), batch["fg_num"],
        r.BBOX_REG_BETA, (1.0 / total_groups) * r.BBOX_REG_WEIGHT)


def retinanet_losses(cfg, outputs, batch, n_groups: int, total_groups: Optional[int] = None
                     ) -> Tuple[torch.Tensor, Metrics]:
    """Focal + select-smooth-L1 over all levels with per-group normalizers
    (ref: retinanet_heads.py:248-311), scaled by 1 / ``total_groups`` (the
    groups of every rank; ``n_groups`` by default)."""
    total_groups = total_groups or n_groups
    a = cfg.num_anchors_per_cell()
    # the softmax variant's class axis holds background at 0 (retinanet_heads.py:295-305)
    focal_loss = softmax_focal_loss if cfg.RETINANET.SOFTMAX else sigmoid_focal_loss
    metrics: Metrics = {}
    total = 0.0
    for lvl in cfg.fpn_levels():
        logits = _split_anchor_axis(outputs["cls_logits"][lvl], a)
        focal = focal_loss(
            _group_view(logits, n_groups), _group_view(batch["labels"][lvl], n_groups),
            batch["fg_num"], cfg.RETINANET.LOSS_GAMMA, cfg.RETINANET.LOSS_ALPHA,
            1.0 / total_groups)
        bbox = _bbox_loss(cfg, outputs, batch, lvl, n_groups, total_groups)
        metrics[f"fl_fpn{lvl}"] = focal.sum()
        metrics[f"retnet_loss_bbox_fpn{lvl}"] = bbox.sum()
        total = total + focal.sum() + bbox.sum()
    return total, metrics


def distill_losses(cfg, student_out, teacher_probs, batch, n_groups: int
                   ) -> Tuple[torch.Tensor, Metrics]:
    """Adaptive distillation losses over all levels, one op per loss
    (ref: retinanet_heads.py:313-352)."""
    d = cfg.DISTILLATION
    a = cfg.num_anchors_per_cell()
    metrics: Metrics = {}
    if d.ADAPTIVE_NORMALIZER:
        # PowSum over every level's teacher probs, per group (retinanet_heads.py:320-328)
        norms = pow_sum([teacher_probs[lvl] for lvl in cfg.fpn_levels()], d.LOGITS_POWER,
                        n_groups)
        metrics["distill_normalizer"] = norms.mean()
    else:
        norms = batch["fg_num"]
    total = 0.0
    for lvl in cfg.fpn_levels():
        dl = sigmoid_adaptive_distill_loss(
            _group_view(_split_anchor_axis(student_out["cls_logits"][lvl], a), n_groups),
            _group_view(_split_anchor_axis(teacher_probs[lvl], a), n_groups),
            _group_view(batch["labels"][lvl], n_groups), norms,
            d.LOSS_GAMMA, d.LOSS_ALPHA, d.LOSS_BETA, d.IGNORED_LABEL,
            (1.0 / n_groups) * d.TEMPERATURE * d.TEMPERATURE)
        metrics[f"fl_distill_fpn{lvl}"] = dl.sum()
        total = total + dl.sum()
    return total, metrics


def cls_loss_params(cfg) -> ClsLossParams:
    r, d = cfg.RETINANET, cfg.DISTILLATION
    return ClsLossParams(r.LOSS_GAMMA, r.LOSS_ALPHA, d.LOSS_GAMMA, d.LOSS_ALPHA, d.LOSS_BETA,
                         d.IGNORED_LABEL, d.LOGITS_POWER, d.ADAPTIVE_NORMALIZER)


def fused_distill_losses(cfg, student_out, teacher_probs, batch, n_groups: int,
                         cls_losses: Callable = fused_cls_losses_raw,
                         total_groups: Optional[int] = None) -> Tuple[torch.Tensor, Metrics]:
    """Focal + adaptive distillation + PowSum per level in one pass of
    ``cls_losses`` (the fused kernels), the 1/Np of each group applied on
    (G,) scalars afterwards; plus the bbox loss. Scaled by 1 /
    ``total_groups`` (the groups of every rank; ``n_groups`` by default)."""
    total_groups = total_groups or n_groups
    d = cfg.DISTILLATION
    a = cfg.num_anchors_per_cell()
    loss_scale = 1.0 / total_groups
    distill_scale = loss_scale * d.TEMPERATURE * d.TEMPERATURE
    p = cls_loss_params(cfg)
    metrics: Metrics = {}
    fg_num = batch["fg_num"]
    raw = {
        lvl: cls_losses(_split_anchor_axis(student_out["cls_logits"][lvl], a),
                        _split_anchor_axis(teacher_probs[lvl], a),
                        batch["labels"][lvl], n_groups, p)
        for lvl in cfg.fpn_levels()
    }
    if d.ADAPTIVE_NORMALIZER:
        norms = sum(raw[lvl][2] for lvl in cfg.fpn_levels())
        metrics["distill_normalizer"] = norms.mean()
    else:
        norms = fg_num
    fg_np = torch.clamp_min(fg_num, 1.0)
    dn_np = torch.clamp_min(norms, 1.0)
    total = 0.0
    for lvl in cfg.fpn_levels():
        focal_raw, distill_raw, _ = raw[lvl]
        focal = loss_scale * (focal_raw / fg_np).sum()
        distill = distill_scale * (distill_raw / dn_np).sum()
        bbox = _bbox_loss(cfg, student_out, batch, lvl, n_groups, total_groups).sum()
        metrics[f"fl_fpn{lvl}"] = focal
        metrics[f"fl_distill_fpn{lvl}"] = distill
        metrics[f"retnet_loss_bbox_fpn{lvl}"] = bbox
        total = total + focal + distill + bbox
    return total, metrics


class TrainStep:
    """``step(state, batch, lr) -> metrics``: one training step, which
    updates the student's parameters and ``state.velocity`` in place and
    returns the metrics as 0-d tensors on the device (nothing waits for the
    card). Its stages are methods, so that a profiler can time each one:
    inputs -> teacher_probs -> forward -> losses -> grads -> reduce -> apply.
    ``world`` > 1: the step of one of that many ranks, which holds
    ``n_groups`` of the batch's groups."""

    def __init__(self, cfg, student: nn.Module, teacher: Optional[nn.Module] = None,
                 n_groups: Optional[int] = None, teacher_cfg=None,
                 cls_losses: Callable = fused_cls_losses_raw, world: int = 1):
        self.cfg = cfg
        self.tcfg = teacher_cfg if teacher_cfg is not None else cfg
        self.student = student
        self.teacher = teacher
        self.n_groups = n_groups
        self.cls_losses = cls_losses
        self.world = world
        t_mask = trainable_mask(student, cfg.TRAIN.FREEZE_AT, cfg.TRAIN.FREEZE_CONV_BODY)
        b_mask = bias_mask(student)
        named = dict(student.named_parameters())
        self.names = [n for n in named if t_mask[n]]
        self.params = [named[n] for n in self.names]
        self.is_bias = [b_mask[n] for n in self.names]

    def inputs(self, batch) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The student's and the teacher's normalised images: one uint8 canvas
        normalised twice on the device, or the batch's float images."""
        if "data_u8" not in batch:
            return batch["data"], batch.get("teacher_data")
        u8 = batch["data_u8"]
        mask = content_mask(u8.shape, batch["content_hw"])
        c, tc = self.cfg, self.tcfg
        s_data = normalize_u8_on_device(u8, c.PIXEL_MEANS, c.PIXEL_DIV, c.PIXEL_STD, mask=mask)
        t_data = None
        if self.teacher is not None:
            t_data = normalize_u8_on_device(u8, tc.PIXEL_MEANS, tc.PIXEL_DIV, tc.PIXEL_STD,
                                            mask=mask)
        return s_data, t_data

    def teacher_probs(self, t_data) -> Optional[Dict[int, torch.Tensor]]:
        if self.teacher is None:
            return None
        with torch.no_grad():
            return self.teacher(t_data, outputs=("cls_prob",))["cls_prob"]

    def forward(self, s_data):
        return self.student(s_data, outputs=("cls_logits", "bbox_pred"))

    def losses(self, out, teacher_probs, batch) -> Tuple[torch.Tensor, Metrics]:
        groups = self.n_groups if self.n_groups is not None else batch["fg_num"].shape[0]
        if teacher_probs is None:
            total, metrics = retinanet_losses(self.cfg, out, batch, groups, groups * self.world)
        else:
            total, metrics = fused_distill_losses(self.cfg, out, teacher_probs, batch, groups,
                                                  self.cls_losses, groups * self.world)
        metrics["loss"] = total
        metrics["retnet_fg_num"] = batch["fg_num"].sum()
        return total, metrics

    def grads(self, total: torch.Tensor):
        return torch.autograd.grad(total, self.params)

    def reduce(self, grads):
        """The gradients summed over the ranks (none to sum over at world 1)."""
        return all_reduce_grads(grads) if self.world > 1 else grads

    def apply(self, state: TrainState, grads, lr: float) -> None:
        solver = self.cfg.SOLVER
        momentum_sgd_update(self.params, grads, [state.velocity[n] for n in self.names],
                            self.is_bias, float(lr), momentum=solver.MOMENTUM,
                            weight_decay=solver.WEIGHT_DECAY)

    def __call__(self, state: TrainState, batch: Dict[str, Any], lr: float) -> Metrics:
        s_data, t_data = self.inputs(batch)
        probs = self.teacher_probs(t_data)
        total, metrics = self.losses(self.forward(s_data), probs, batch)
        self.apply(state, self.reduce(self.grads(total)), lr)
        return {k: v.detach() for k, v in metrics.items()}


def make_train_step(cfg, student: nn.Module, teacher: Optional[nn.Module] = None,
                    n_groups: Optional[int] = None, teacher_cfg=None,
                    cls_losses: Callable = fused_cls_losses_raw, world: int = 1) -> TrainStep:
    """The train step of ``student`` (ref: sad_tpu make_train_step).
    Distillation is on iff ``teacher`` is given; ``teacher_cfg`` supplies the
    teacher's pixel normalisation of a uint8 batch. ``cls_losses`` is the
    fused cls-loss function of the distillation step (the plain twin,
    ``fused_cls_losses_raw_plain``, to hold the kernels against it). Over
    ``world`` ranks, ``n_groups`` is the rank's own count."""
    return TrainStep(cfg, student, teacher, n_groups, teacher_cfg, cls_losses, world)
