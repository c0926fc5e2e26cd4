"""Training steps: plain RetinaNet and the joint teacher+student SAD step
(ref: sad_tpu/train/train_step.py:50-326).

- Loss normalizers are per group of TRAIN.IMS_PER_BATCH images, as the
  reference computes them per GPU over its 2-image minibatch; every loss is
  scaled by 1/G (detector.py:650-655).
- Over W ranks (parallel/distributed.py) a step holds the rank's G / W
  groups (``n_groups`` is that local count), scales its losses by 1 / G all
  the same (the loss functions' ``total_groups``), and sums the gradients
  over the ranks before the update; each rank holds whole groups, so their
  normalizers (fg_num, PowSum) are its own.
- On a ``Mesh`` (parallel/mesh.py; ``n_groups`` is then the batch's G) a
  rank holds its data shard's images, or with n_model > 1 a band of rows of
  each (the models run through parallel/spatial.py), and a loss group may
  span ranks: the fused kernels run with one group a local image, the
  per-image PowSum is added into the batch's G groups and one all-reduce of
  the (2, G) partial fg_num and PowSum makes both global (fg_num exactly:
  its counts are integers). Every loss is linear in a group's raw sums once
  the normalizers are global, so the ranks' losses sum to one process's and
  so do their gradients (``mesh_losses``). Its metrics are the global ones,
  the same on every rank.
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
  fg_num:        (G,) float32 per-group fg counts, or on a mesh
  fg_img:        (B,) float32 per-image fg counts of a block that cuts a group
  canvas_h:      int, the canvas height (bands on a mesh with n_model > 1)
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
from ..parallel.distributed import all_reduce_counts, all_reduce_grads, all_reduce_sum
from ..parallel.mesh import Mesh
from ..parallel.spatial import spatialize
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
                         total_groups: Optional[int] = None,
                         normalizers: Optional[Callable] = None) -> Tuple[torch.Tensor, Metrics]:
    """Focal + adaptive distillation + PowSum per level in one pass of
    ``cls_losses`` (the fused kernels), the 1/Np of each group applied on
    (G,) scalars afterwards; plus the bbox loss. Scaled by 1 /
    ``total_groups`` (the groups of every rank; ``n_groups`` by default).
    ``normalizers`` maps the (fg_num, PowSum) of the ``n_groups`` groups of
    this call to the values each is normalised by: the identity by default;
    ``mesh_losses`` passes the global values of each local image's loss
    group. A level of no rows (an empty band) adds a 0 tied to its logits."""
    total_groups = total_groups or n_groups
    d = cfg.DISTILLATION
    a = cfg.num_anchors_per_cell()
    loss_scale = 1.0 / total_groups
    distill_scale = loss_scale * d.TEMPERATURE * d.TEMPERATURE
    p = cls_loss_params(cfg)
    metrics: Metrics = {}
    logits = student_out["cls_logits"]
    raw = {
        lvl: cls_losses(_split_anchor_axis(logits[lvl], a),
                        _split_anchor_axis(teacher_probs[lvl], a),
                        batch["labels"][lvl], n_groups, p) if logits[lvl].numel() else None
        for lvl in cfg.fpn_levels()
    }
    fg_num = batch["fg_num"]
    powsum = sum((r[2] for r in raw.values() if r is not None),
                 torch.zeros(n_groups, dtype=torch.float32, device=fg_num.device))
    if normalizers is not None:
        fg_num, powsum = normalizers(fg_num, powsum)
    if d.ADAPTIVE_NORMALIZER:
        norms = powsum
        metrics["distill_normalizer"] = norms.mean()
    else:
        norms = fg_num
    fg_np = torch.clamp_min(fg_num, 1.0)
    dn_np = torch.clamp_min(norms, 1.0)
    box_batch = {**batch, "fg_num": fg_num}
    total = 0.0
    for lvl in cfg.fpn_levels():
        if raw[lvl] is None:
            focal = distill = logits[lvl].sum() * 0.0
        else:
            focal_raw, distill_raw, _ = raw[lvl]
            focal = loss_scale * (focal_raw / fg_np).sum()
            distill = distill_scale * (distill_raw / dn_np).sum()
        bbox = _bbox_loss(cfg, student_out, box_batch, lvl, n_groups, total_groups).sum()
        metrics[f"fl_fpn{lvl}"] = focal
        metrics[f"fl_distill_fpn{lvl}"] = distill
        metrics[f"retnet_loss_bbox_fpn{lvl}"] = bbox
        total = total + focal + distill + bbox
    return total, metrics


def mesh_losses(cfg, out, teacher_probs, batch, n_groups: int, mesh: Mesh,
                cls_losses: Callable = fused_cls_losses_raw, normalizers: Optional[dict] = None
                ) -> Tuple[torch.Tensor, Metrics]:
    """The losses of this rank's images, or bands of them, on ``mesh``, of a
    batch of ``n_groups`` loss groups, and the batch's global metrics.

    Local image j is the batch's image d B_loc + j (d the data index) and
    belongs to group (d B_loc + j) // (B / G). ``batch['fg_num']`` holds all
    G counts (replicated) or the data shard's G / n_data (sliced), as
    ``mesh.shard_batch_tree`` leaves it, or ``batch['fg_img']`` the data
    shard's per-image counts (a loader's block that cuts a group,
    data/minibatch.py), which are added into their groups.
    ``fused_distill_losses`` (or ``retinanet_losses`` for the plain step)
    runs with one group a local
    image, each normalised by its loss group's global fg_num and PowSum,
    which one all-reduce of the (2, G) partial counts over the world makes:
    fg_num from one rank a group, PowSum from every band of every image
    (both kept in ``normalizers`` as 'fg_num' and 'powsum' when it is
    given). The returned loss is this rank's share: the ranks' shares and
    their gradients sum to one process's."""
    logits0 = out["cls_logits"][cfg.fpn_levels()[0]]
    b_loc, dev = logits0.shape[0], logits0.device
    images = b_loc * mesh.n_data
    if images % n_groups:
        raise ValueError(f"a batch of {images} images does not hold {n_groups} loss groups")
    gidx = (mesh.data_index * b_loc + torch.arange(b_loc, device=dev)) // (images // n_groups)
    fg_part = torch.zeros(n_groups, dtype=torch.float32, device=dev)
    fg = batch["fg_num"].float() if "fg_img" not in batch else None
    if fg is None:
        if mesh.model_index == 0:
            fg_part.index_add_(0, gidx, batch["fg_img"].float())
    elif fg.shape[0] == n_groups:
        if mesh.rank == 0:
            fg_part = fg.clone()
    elif fg.shape[0] * mesh.n_data == n_groups:
        if mesh.model_index == 0:
            k = fg.shape[0]
            fg_part[mesh.data_index * k:(mesh.data_index + 1) * k] = fg
    else:
        raise ValueError(f"fg_num of {fg.shape[0]} groups on a batch of {n_groups} over "
                         f"{mesh.n_data} data ranks")
    found = {}

    def global_normalizers(_, pow_img):
        sums = torch.stack([fg_part, torch.zeros_like(fg_part).index_add_(0, gidx, pow_img)])
        found["fg_num"], found["powsum"] = all_reduce_counts(sums)
        return found["fg_num"][gidx], found["powsum"][gidx]

    # the rank's partial counts stand in for fg_num; normalizers replaces them
    batch = {**{k: v for k, v in batch.items() if k != "fg_img"}, "fg_num": fg_part}
    if teacher_probs is None:
        fg_img, _ = global_normalizers(None, torch.zeros(b_loc, device=dev))
        total, metrics = retinanet_losses(cfg, out, {**batch, "fg_num": fg_img}, b_loc, n_groups)
    else:
        total, metrics = fused_distill_losses(cfg, out, teacher_probs, batch, b_loc, cls_losses,
                                              n_groups, global_normalizers)
    if normalizers is not None:
        normalizers.update({k: v.detach() for k, v in found.items()})
    metrics.pop("distill_normalizer", None)
    metrics["loss"] = total
    names = sorted(metrics)
    shares = all_reduce_sum(torch.stack([metrics[k].detach().float() for k in names]))
    metrics = dict(zip(names, shares))
    if teacher_probs is not None and cfg.DISTILLATION.ADAPTIVE_NORMALIZER:
        metrics["distill_normalizer"] = found["powsum"].mean()
    metrics["retnet_fg_num"] = found["fg_num"].sum()
    return total, metrics


class TrainStep:
    """``step(state, batch, lr) -> metrics``: one training step, which
    updates the student's parameters and ``state.velocity`` in place and
    returns the metrics as 0-d tensors on the device (nothing waits for the
    card). Its stages are methods, so that a profiler can time each one:
    inputs -> teacher_probs -> forward -> losses -> grads -> reduce -> apply.
    ``world`` > 1: the step of one of that many ranks, which holds
    ``n_groups`` of the batch's groups. ``mesh``: the step of this rank of a
    (data, model) mesh, ``n_groups`` the batch's G (cfg.NUM_GPUS by
    default), on the piece of the batch ``mesh.shard_batch_tree`` cuts
    (``mesh_losses``); its metrics are the batch's."""

    def __init__(self, cfg, student: nn.Module, teacher: Optional[nn.Module] = None,
                 n_groups: Optional[int] = None, teacher_cfg=None,
                 cls_losses: Callable = fused_cls_losses_raw, world: int = 1,
                 mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.tcfg = teacher_cfg if teacher_cfg is not None else cfg
        self.student = student
        self.teacher = teacher
        self.n_groups = n_groups
        self.cls_losses = cls_losses
        self.world = world
        self.mesh = mesh
        self.height = None  # the canvas height of the batch last given to inputs (bands)
        self.normalizers: Dict[str, torch.Tensor] = {}  # a mesh step's last global (G,) ones
        if mesh is not None:
            if world != 1:
                raise ValueError("a step takes a world or a mesh, not both")
            self.world = mesh.world
            self.n_groups = n_groups if n_groups is not None else cfg.NUM_GPUS
            self.banded = [spatialize(m, mesh) if m is not None else None
                           for m in (student, teacher)]
        t_mask = trainable_mask(student, cfg.TRAIN.FREEZE_AT, cfg.TRAIN.FREEZE_CONV_BODY)
        b_mask = bias_mask(student)
        named = dict(student.named_parameters())
        self.names = [n for n in named if t_mask[n]]
        self.params = [named[n] for n in self.names]
        self.is_bias = [b_mask[n] for n in self.names]

    def inputs(self, batch) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The student's and the teacher's normalised images: one uint8 canvas
        normalised twice on the device, or the batch's float images."""
        self.height = batch.get("canvas_h")
        if "data_u8" not in batch:
            return batch["data"], batch.get("teacher_data")
        u8 = batch["data_u8"]
        row0 = 0 if self.mesh is None or self.height is None else self.mesh.band(self.height)[0]
        mask = content_mask(u8.shape, batch["content_hw"], row0)
        c, tc = self.cfg, self.tcfg
        s_data = normalize_u8_on_device(u8, c.PIXEL_MEANS, c.PIXEL_DIV, c.PIXEL_STD, mask=mask)
        t_data = None
        if self.teacher is not None:
            t_data = normalize_u8_on_device(u8, tc.PIXEL_MEANS, tc.PIXEL_DIV, tc.PIXEL_STD,
                                            mask=mask)
        return s_data, t_data

    def _run(self, which: int, x, outputs):
        """The student (0) or the teacher (1) on ``x``: on its bands on a
        mesh with n_model > 1."""
        if self.mesh is None or self.mesh.n_model == 1:
            return (self.student, self.teacher)[which](x, outputs=outputs)
        return self.banded[which](x, outputs=outputs, height=self.height)

    def teacher_probs(self, t_data) -> Optional[Dict[int, torch.Tensor]]:
        if self.teacher is None:
            return None
        with torch.no_grad():
            return self._run(1, t_data, ("cls_prob",))["cls_prob"]

    def forward(self, s_data):
        return self._run(0, s_data, ("cls_logits", "bbox_pred"))

    def losses(self, out, teacher_probs, batch) -> Tuple[torch.Tensor, Metrics]:
        if self.mesh is not None:
            return mesh_losses(self.cfg, out, teacher_probs, batch, self.n_groups, self.mesh,
                               self.cls_losses, self.normalizers)
        groups = self.n_groups if self.n_groups is not None else batch["fg_num"].shape[0]
        if teacher_probs is None:
            total, metrics = retinanet_losses(self.cfg, out, batch, groups, groups * self.world)
        else:
            total, metrics = fused_distill_losses(self.cfg, out, teacher_probs, batch, groups,
                                                  self.cls_losses, groups * self.world)
        metrics["loss"] = total
        metrics["retnet_fg_num"] = batch["fg_num"].sum()
        return total, metrics

    @property
    def global_metrics(self) -> bool:
        """A step on a mesh returns the batch's metrics (``mesh_losses``);
        over ``world`` ranks each rank's are its share."""
        return self.mesh is not None

    def grads(self, total: torch.Tensor):
        if self.mesh is None:
            return torch.autograd.grad(total, self.params)
        # a rank whose band of a level is empty does not use that level's convs
        grads = torch.autograd.grad(total, self.params, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g for p, g in zip(self.params, grads)]

    def reduce(self, grads):
        """The gradients summed over the ranks (none to sum over at world
        1), in two levels on a multislice mesh."""
        return all_reduce_grads(grads, self.mesh) if self.world > 1 else grads

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
                    cls_losses: Callable = fused_cls_losses_raw, world: int = 1,
                    mesh: Optional[Mesh] = None) -> TrainStep:
    """The train step of ``student`` (ref: sad_tpu make_train_step).
    Distillation is on iff ``teacher`` is given; ``teacher_cfg`` supplies the
    teacher's pixel normalisation of a uint8 batch. ``cls_losses`` is the
    fused cls-loss function of the distillation step (the plain twin,
    ``fused_cls_losses_raw_plain``, to hold the kernels against it). Over
    ``world`` ranks, ``n_groups`` is the rank's own count; on a ``mesh`` it
    is the batch's, and loss groups may span ranks."""
    return TrainStep(cfg, student, teacher, n_groups, teacher_cfg, cls_losses, world, mesh)
