"""The Faster / Mask / Keypoint R-CNN end-to-end training step on an FPN backbone (ref:
sad_tpu/train/rcnn_train.py, the FPN branch of make_rcnn_train_step; the
reference's generalized_rcnn training graph, model_builder.py:74-92, with
the GenerateProposalLabels Python op on the device).

One step: images -> ResNet-FPN -> RPN head and RPN losses -> train-mode
proposals (per-level top-k, decode, ONE batched NMS over all level x image
problems, global top-k) -> fg/bg sampling with targets on the device ->
multilevel RoIAlign -> box head, softmax-CE + smooth-L1 -> for Mask and
Keypoint R-CNN the fg prefix -> mask RoIAlign -> mask head -> mask targets
cropped on the device -> sigmoid-CE, and keypoint RoIAlign -> keypoint head
-> heatmap labels on the device -> softmax-CE -> backward -> Caffe2
momentum SGD. Proposals, sampling
and targets run under ``torch.no_grad()`` (sad_tpu stops the gradient
there); nothing reads a value back to the host. On the card the NMS and both
directions of RoIAlign are the hand-written kernels.

Loss wiring (group-exact: the reference's per-GPU losses scaled 1 / NUM_GPUS
and a gradient allreduce-SUM are the average of per-GPU terms; a group is
TRAIN.IMS_PER_BATCH consecutive images):
- RPN cls: sum of sigmoid-CE over sampled anchors / (RPN_BATCH_SIZE_PER_IM *
  total images) (FPN.py:410-418),
- RPN bbox: smooth-L1 with inside / outside weights, beta 1/9, / dim 0
  (FPN.py:422-431),
- box head: softmax-CE as a per-group mean over sampled rois, smooth-L1 with
  class-specific weights (fast_rcnn_heads.py add_fast_rcnn_losses),
- mask and keypoints: train/mask_keypoint.py.
Over W ranks (parallel/distributed.py) each rank holds B / W images and
G / W groups; every denominator above stays the global one (images, rows,
groups times W), the box head's accuracy divides by the live rois of all
ranks, the sampler draws the global (B, P + G) priorities and takes the
rank's rows, and the gradients are summed over the ranks before the update.

Not ported yet, each raising NotImplementedError (ROADMAP.md Queue 1 item 8):
the single-scale (C4) and R-FCN branches, training from precomputed
proposals, TRAIN.OHEM.

Batch (tensors on the model's device, NHWC; data/rpn_minibatch.py):
  data (B, H, W, 3) float32 normalised, or data_u8 (B, H, W, 3) uint8 +
  content_hw (B, 2);  im_hw (B, 2) the scaled content extents;
  rpn_labels {lvl: (B, H_l, W_l, A) int32}, rpn_bbox_targets /
  rpn_bbox_inside_weights / rpn_bbox_outside_weights {lvl: (B, H_l, W_l, A, 4)};
  gt_boxes (B, G, 4), gt_classes (B, G) with 0 = padding;
  for Mask R-CNN gt_mask_rasters (B, G, Hm, Wm) and gt_mask_stride (a number);
  for Keypoint R-CNN gt_keypoints (B, G, K, 3) [x, y, visibility].
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..models import bias_mask, trainable_mask
from ..models.rcnn import flat_rois
from ..ops.image_norm import content_mask, normalize_u8_on_device
from ..ops.losses import smooth_l1_loss
from ..ops.proposals import (
    map_rois_to_fpn_levels, multilevel_roi_align, sample_proposal_labels, sampled_fg_cap,
)
from ..parallel.distributed import all_reduce_grads, all_reduce_sum, shard_rows
from .mask_keypoint import (
    keypoint_loss, keypoint_targets_on_device, mask_loss, mask_targets_on_device,
)
from .optimizer import momentum_sgd_update
from .train_step import Metrics, TrainState

_LATER = " is not ported to sad_tpu_torch yet (ROADMAP.md Queue 1 item 8)"


def rpn_losses(cfg, logits: Dict[int, torch.Tensor], deltas: Dict[int, torch.Tensor],
               batch: Dict[str, Any], total_images: Optional[int] = None
               ) -> Tuple[torch.Tensor, Metrics]:
    """Per-level RPN losses (FPN.py:391-431). Both denominators are static
    (RPN_BATCH_SIZE_PER_IM * B and B, B = ``total_images``: the images of
    every rank, this batch's by default), so the batch-global forms are
    exact for any grouping."""
    metrics: Metrics = {}
    total = 0.0
    for lvl in sorted(logits):
        x = logits[lvl].float()
        t = batch["rpn_labels"][lvl]
        # sum of CE with -1 ignored (SigmoidCrossEntropyLoss normalize=0)
        ge = (x >= 0).float()
        ce = -x * (t.float() - ge) + torch.log(1.0 + torch.exp(x - 2.0 * x * ge))
        ce = torch.where(t == -1, 0.0, ce)
        n = total_images or x.shape[0]
        cls = ce.sum() / (cfg.TRAIN.RPN_BATCH_SIZE_PER_IM * n)
        d = deltas[lvl].reshape(tuple(deltas[lvl].shape[:-1]) + (t.shape[-1], 4))
        bbox = smooth_l1_loss(  # its denominator is this batch's images
            d, batch["rpn_bbox_targets"][lvl], batch["rpn_bbox_inside_weights"][lvl],
            batch["rpn_bbox_outside_weights"][lvl], beta=1.0 / 9.0,
            scale=1.0 / (n // x.shape[0]))
        metrics[f"loss_rpn_cls_fpn{lvl}"] = cls
        metrics[f"loss_rpn_bbox_fpn{lvl}"] = bbox
        total = total + cls + bbox
    return total, metrics


def fast_rcnn_losses(cfg, cls_score, labels, bbox_pred, bbox_targets, inside_w, outside_w,
                     valid, n_groups: int, total_groups: Optional[int] = None
                     ) -> Tuple[torch.Tensor, Metrics]:
    """Box-head losses (fast_rcnn_heads.py add_fast_rcnn_losses):
    SoftmaxWithLoss as the average of per-group means over the live rois
    (rows are n_groups consecutive blocks) and SmoothL1Loss, whose
    denominator is its static dim 0, scaled by MODEL.BBOX_REG_WEIGHT_SCALE.
    With ``total_groups`` (the groups of every rank) above ``n_groups``, the
    groups and rows of all ranks, and the accuracy over their live rois."""
    ranks = (total_groups or n_groups) // n_groups
    if cfg.TRAIN.OHEM:
        raise NotImplementedError("TRAIN.OHEM" + _LATER)
    logp = torch.log_softmax(cls_score.float(), dim=-1)
    nll = -torch.gather(logp, 1, labels.long().clamp_min(0)[:, None])[:, 0]
    live = valid & (labels >= 0)
    nll = torch.where(live, nll, 0.0)
    live_f = live.float()
    sum_g = nll.reshape(n_groups, -1).sum(dim=1)
    cnt_g = torch.clamp_min(live_f.reshape(n_groups, -1).sum(dim=1), 1.0)
    cls_loss = (sum_g / cnt_g).sum() / (n_groups * ranks)
    bbox_loss = smooth_l1_loss(bbox_pred, bbox_targets, inside_w, outside_w, beta=1.0,
                               scale=cfg.MODEL.BBOX_REG_WEIGHT_SCALE / ranks)
    hit = (cls_score.argmax(dim=-1) == labels) & valid
    # the live rois of every rank: the ranks' accuracies then sum to the batch's
    live_n = all_reduce_sum(live_f.sum().detach()) if ranks > 1 else live_f.sum()
    accuracy = hit.float().sum() / torch.clamp_min(live_n, 1.0)
    return cls_loss + bbox_loss, {"loss_cls": cls_loss, "loss_bbox": bbox_loss,
                                  "accuracy_cls": accuracy}


class RCNNTrainStep:
    """``step(state, batch, lr) -> metrics``: one training step of a
    GeneralizedRCNN, which updates the model's parameters and
    ``state.velocity`` in place and returns the metrics as 0-d tensors on the
    device. Its stages are methods, so that a profiler can time each one:
    inputs -> backbone -> rpn -> proposals -> sample -> box_branch ->
    mask_branch / keypoint_branch -> grads -> apply.

    The sampler's random priorities come from ``generator`` (a
    torch.Generator on the model's device), or are handed to the step as
    ``uniforms`` = two (B, P + G) tensors. ``rank`` of ``world`` > 1: the step
    of one rank, which holds ``n_groups`` of the batch's groups; it draws
    the whole batch's priorities from ``generator`` and takes its rows."""

    def __init__(self, cfg, model: nn.Module, n_groups: Optional[int] = None,
                 generator: Optional[torch.Generator] = None, rank: int = 0, world: int = 1):
        if not (cfg.FPN.FPN_ON and cfg.FPN.MULTILEVEL_RPN and cfg.FPN.MULTILEVEL_ROIS):
            raise NotImplementedError("the single-scale (C4 / R-FCN) R-CNN training step"
                                      + _LATER)
        if not cfg.MODEL.FASTER_RCNN:
            raise NotImplementedError("MODEL.FASTER_RCNN False: training from precomputed "
                                      "proposals" + _LATER)
        if cfg.TRAIN.OHEM:
            raise NotImplementedError("TRAIN.OHEM" + _LATER)
        self.cfg = cfg
        self.model = model
        self.n_groups = n_groups or cfg.NUM_GPUS
        self.generator = generator
        self.rank, self.world = rank, world
        t_mask = trainable_mask(model, cfg.TRAIN.FREEZE_AT, cfg.TRAIN.FREEZE_CONV_BODY)
        b_mask = bias_mask(model)
        named = dict(model.named_parameters())
        self.names = [n for n in named if t_mask[n]]
        self.params = [named[n] for n in self.names]
        self.is_bias = [b_mask[n] for n in self.names]

    # ---- stages

    def inputs(self, batch) -> torch.Tensor:
        """The normalised images: the batch's float images, or its uint8
        canvases normalised on the device."""
        if "data_u8" not in batch:
            return batch["data"]
        c, u8 = self.cfg, batch["data_u8"]
        return normalize_u8_on_device(u8, c.PIXEL_MEANS, c.PIXEL_DIV, c.PIXEL_STD,
                                      mask=content_mask(u8.shape, batch["content_hw"]))

    def backbone(self, data: torch.Tensor) -> Dict[int, torch.Tensor]:
        """NCHW feature maps {level: (B, C, H_l, W_l)}."""
        return self.model._features(data)

    def rpn(self, nchw, batch):
        """RPN head and losses: (logits, deltas, total, metrics)."""
        logits, deltas = self.model.rpn_outputs(nchw)
        images = next(iter(logits.values())).shape[0] * self.world
        total, metrics = rpn_losses(self.cfg, logits, deltas, batch, images)
        return logits, deltas, total, metrics

    @torch.no_grad()
    def proposals(self, logits, deltas, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """Train-mode proposals: (boxes (B, P, 4), valid (B, P))."""
        boxes, _scores, valid, _levels = self.model.proposals_from_rpn(
            logits, deltas, batch["im_hw"], train=True)
        return boxes, valid

    @torch.no_grad()
    def sample(self, boxes, valid, batch, uniforms=None) -> Dict[str, torch.Tensor]:
        t, m = self.cfg.TRAIN, self.cfg.MODEL
        if uniforms is None and self.world > 1:
            # the whole batch's draws, in the order one process makes them
            shape = (boxes.shape[0] * self.world, boxes.shape[1] + batch["gt_boxes"].shape[1])
            uniforms = tuple(
                shard_rows(torch.rand(shape, generator=self.generator, device=boxes.device),
                           self.rank, self.world) for _ in range(2))
        return sample_proposal_labels(
            boxes, valid, batch["gt_boxes"], batch["gt_classes"], t.BATCH_SIZE_PER_IM,
            t.FG_FRACTION, t.FG_THRESH, t.BG_THRESH_HI, t.BG_THRESH_LO, m.NUM_CLASSES,
            m.BBOX_REG_WEIGHTS, generator=self.generator, uniforms=uniforms)

    def _roi_levels(self, rois5: torch.Tensor) -> torch.Tensor:
        f = self.cfg.FPN
        return map_rois_to_fpn_levels(rois5[:, 1:], f.ROI_MIN_LEVEL, f.ROI_MAX_LEVEL,
                                      f.ROI_CANONICAL_SCALE, f.ROI_CANONICAL_LEVEL)

    def box_branch(self, feats, sampled) -> Tuple[torch.Tensor, Metrics]:
        """RoIAlign of the sampled rois from the NHWC ``feats``, the box head
        and its losses."""
        cfg = self.cfg
        rois5 = flat_rois(sampled["rois"])
        roi_feats = multilevel_roi_align(
            feats, rois5, self._roi_levels(rois5), sampled["valid"].reshape(-1),
            cfg.FAST_RCNN.ROI_XFORM_RESOLUTION, cfg.FAST_RCNN.ROI_XFORM_SAMPLING_RATIO)
        cls_score, bbox_pred = self.model.box_head(roi_feats)
        n = cls_score.shape[0]
        return fast_rcnn_losses(
            cfg, cls_score, sampled["labels"].reshape(-1), bbox_pred,
            sampled["bbox_targets"].reshape(n, -1),
            sampled["bbox_inside_weights"].reshape(n, -1),
            sampled["bbox_outside_weights"].reshape(n, -1),
            sampled["valid"].reshape(-1), self.n_groups, self.n_groups * self.world)

    def _aux_cap(self, knob: int) -> int:
        """Slots an image of an aux branch: the fg prefix of the sampler's
        output, or fewer with the branch's ROI_SLOTS_PER_IM ``knob`` (fg
        rois beyond the cap keep their box supervision and get no loss of
        the branch)."""
        t = self.cfg.TRAIN
        fg_cap = sampled_fg_cap(t.BATCH_SIZE_PER_IM, t.FG_FRACTION)
        return fg_cap if knob <= 0 else min(knob, fg_cap)

    def mask_cap(self) -> int:
        """Mask-branch slots an image (MRCNN.ROI_SLOTS_PER_IM)."""
        return self._aux_cap(self.cfg.MRCNN.ROI_SLOTS_PER_IM)

    def kps_cap(self) -> int:
        """Keypoint-branch slots an image (KRCNN.ROI_SLOTS_PER_IM)."""
        return self._aux_cap(self.cfg.KRCNN.ROI_SLOTS_PER_IM)

    def fg_prefix(self, sampled) -> Dict[str, torch.Tensor]:
        """The leading slots of every image at the larger cap of the aux
        branches that are on, which hold every fg roi (the sampler sorts
        them first), with their RoI levels: made once and sliced by each
        branch (sad_tpu's ``_branch_slice``). Every entry is (B, cap, ...)."""
        m = self.cfg.MODEL
        cap = max(self.mask_cap() if m.MASK_ON else 1, self.kps_cap() if m.KEYPOINTS_ON else 1)
        rois = sampled["rois"][:, :cap]
        levels = self._roi_levels(flat_rois(rois)).reshape(rois.shape[:2])
        return {"rois": rois, "levels": levels, "is_fg": sampled["is_fg"][:, :cap],
                "labels": sampled["labels"][:, :cap], "matched_gt": sampled["matched_gt"][:, :cap]}

    def _branch(self, feats, sampled, prefix, cap: int, res: int, sr: int):
        """A branch's slice of the fg prefix and its RoIAlign: (slice with
        'is_fg' flattened, roi features (B * cap, res, res, C))."""
        p = {k: v[:, :cap] for k, v in (prefix or self.fg_prefix(sampled)).items()}
        p["is_fg"] = p["is_fg"].reshape(-1)
        return p, multilevel_roi_align(feats, flat_rois(p["rois"]), p["levels"].reshape(-1),
                                       p["is_fg"], res, sr)

    def mask_branch(self, feats, sampled, batch, prefix=None) -> torch.Tensor:
        """The mask loss on the leading ``mask_cap`` slots of every image:
        RoIAlign, mask head, targets cropped from the gt rasters on the
        device."""
        cfg = self.cfg
        p, mfeats = self._branch(feats, sampled, prefix, self.mask_cap(),
                                 cfg.MRCNN.ROI_XFORM_RESOLUTION,
                                 cfg.MRCNN.ROI_XFORM_SAMPLING_RATIO)
        mlogits = self.model.mask_head(mfeats)
        targets = mask_targets_on_device(
            batch["gt_mask_rasters"], p["rois"], p["matched_gt"],
            cfg.MRCNN.RESOLUTION, float(batch["gt_mask_stride"]))
        return mask_loss(cfg, mlogits, targets, p["labels"].reshape(-1), p["is_fg"],
                         self.n_groups, self.n_groups * self.world)

    def keypoint_branch(self, feats, sampled, batch, prefix=None) -> torch.Tensor:
        """The keypoint loss on the leading ``kps_cap`` slots of every image:
        RoIAlign, keypoint head, heatmap labels from the gt keypoints on the
        device."""
        cfg = self.cfg
        p, kfeats = self._branch(feats, sampled, prefix, self.kps_cap(),
                                 cfg.KRCNN.ROI_XFORM_RESOLUTION,
                                 cfg.KRCNN.ROI_XFORM_SAMPLING_RATIO)
        klogits = self.model.keypoint_heads(kfeats)
        labels, valid = keypoint_targets_on_device(batch["gt_keypoints"], p["rois"],
                                                   p["matched_gt"], klogits.shape[1])
        return keypoint_loss(cfg, klogits, labels, valid, p["is_fg"], self.n_groups,
                             n_images=p["rois"].shape[0],
                             total_groups=self.n_groups * self.world)

    def losses(self, batch, uniforms=None) -> Tuple[torch.Tensor, Metrics]:
        """Forward and every loss: (total, metrics)."""
        nchw = self.backbone(self.inputs(batch))
        logits, deltas, total, metrics = self.rpn(nchw, batch)
        boxes, valid = self.proposals(logits, deltas, batch)
        sampled = self.sample(boxes, valid, batch, uniforms)
        feats = self.model.roi_features({l: f.permute(0, 2, 3, 1) for l, f in nchw.items()})
        box_total, box_metrics = self.box_branch(feats, sampled)
        total = total + box_total
        metrics.update(box_metrics)
        m = self.cfg.MODEL
        mask = m.MASK_ON and "gt_mask_rasters" in batch
        kps = m.KEYPOINTS_ON and "gt_keypoints" in batch
        if mask or kps:
            prefix = self.fg_prefix(sampled)
            aux = []
            if mask:
                metrics["loss_mask"] = self.mask_branch(feats, sampled, batch, prefix)
                aux.append(metrics["loss_mask"])
            if kps:
                metrics["loss_kps"] = self.keypoint_branch(feats, sampled, batch, prefix)
                aux.append(metrics["loss_kps"])
            total = total + sum(aux)  # the aux losses summed first, as in sad_tpu
        metrics["loss"] = total
        return total, metrics

    def grads(self, total: torch.Tensor):
        """Gradients of the trainable parameters; one that the loss does not
        reach (the mask head of a batch without rasters, the keypoint head
        of one without keypoints) gets zeros, and so still decays."""
        got = torch.autograd.grad(total, self.params, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g for p, g in zip(self.params, got)]

    def reduce(self, grads):
        """The gradients summed over the ranks (none to sum over at world 1)."""
        return all_reduce_grads(grads) if self.world > 1 else grads

    def apply(self, state: TrainState, grads, lr: float) -> None:
        solver = self.cfg.SOLVER
        momentum_sgd_update(self.params, grads, [state.velocity[n] for n in self.names],
                            self.is_bias, float(lr), momentum=solver.MOMENTUM,
                            weight_decay=solver.WEIGHT_DECAY)

    def __call__(self, state: TrainState, batch: Dict[str, Any], lr: float,
                 uniforms=None) -> Metrics:
        total, metrics = self.losses(batch, uniforms)
        self.apply(state, self.reduce(self.grads(total)), lr)
        return {k: v.detach() for k, v in metrics.items()}


def make_rcnn_train_step(cfg, model: nn.Module, n_groups: Optional[int] = None,
                         generator: Optional[torch.Generator] = None, rank: int = 0,
                         world: int = 1) -> RCNNTrainStep:
    """The training step of a Faster / Mask / Keypoint R-CNN ``model`` (ref: sad_tpu
    make_rcnn_train_step). ``n_groups`` defaults to cfg.NUM_GPUS; over
    ``world`` ranks it is the rank's own count."""
    return RCNNTrainStep(cfg, model, n_groups, generator, rank, world)
