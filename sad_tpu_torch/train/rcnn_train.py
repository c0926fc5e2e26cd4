"""The Fast / Faster / Mask / Keypoint R-CNN and R-FCN end-to-end training step (ref:
sad_tpu/train/rcnn_train.py make_rcnn_train_step, its FPN and single-scale
branches; the reference's generalized_rcnn training graph,
model_builder.py:74-92, with the GenerateProposalLabels Python op on the
device).

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
Over W ranks (parallel/distributed.py; a ``Mesh``, or ``world`` W as the
(W, 1) mesh) each rank holds its block of B / W images, and a loss group may
span ranks (sad_tpu's train_loop.py:206-245 trains on gcd(images, devices)
devices with NUM_GPUS groups; XLA makes the per-group counts global). The
step counts, an image at a time, what each group's losses divide by (the box
head's live rois or OHEM keeps, the mask's fg rois, the visible keypoints,
and the live rois of the accuracy), adds the counts into the batch's G
groups and makes them global with ONE all-reduce (``group_counts``; integers
in float32, so exact); each image's sums are divided by its group's global
count and the losses scaled 1 / G, so the ranks' losses and gradients sum
to one process's. The static denominators (the RPN's, the box smooth-L1's
dim 0, the fixed keypoint count) stay the global ones; the sampler draws the
global (B, P + G) priorities and takes the rank's rows; the gradients are
summed over the ranks before the update (in two levels on a multislice
mesh); the metrics are the rank's shares, which sum to the batch's.

Fast R-CNN (MODEL.FASTER_RCNN False, a batch with 'proposal_boxes'; ref:
sad_tpu/train/rcnn_train.py:224-270): no RPN head and no RPN losses; the
sampler draws from the precomputed proposals and the gt boxes, then the box
branch and the mask branch as above.

Single-scale models (models/single_scale.SingleScaleRCNN: C4, VGG, R-FCN;
ref: sad_tpu/train/rcnn_train.py:206-450): one feature map at level
log2(RPN.STRIDE), the RPN losses at that level, the NMS picks as the rois,
``box_forward`` (RoIAlign of every sampled roi and the res5 or fc6 / fc7
head, or R-FCN's PSRoIPool vote with its class-agnostic (R, 8) targets,
``_rfcn_targets`` / ``_rfcn_weights``); the C4 mask branch on the fg prefix
of ``sampled_fg_cap`` slots: v0upshare from the box branch's res5 maps of
those slots, v0up through ``mask_heads`` on their rois, targets at the
logits' resolution (2 x MRCNN.ROI_XFORM_RESOLUTION).

TRAIN.OHEM (fast_rcnn_heads.py:70-109; sad_tpu/train/rcnn_train.py:128-160)
in both steps: per-roi softmax-CE + smooth-L1 rank each image's sampled rois,
the TRAIN.OHEM_ROI_PER_IMG hardest keep a weight of 1 (ties to the lower
slot; padding ranks last), and the box losses are the weighted per-group
means (a group whose images have fewer live rois keeps fewer).

Refused where sad_tpu ignores the option or fails (ROADMAP.md Queue 3): an FPN
model without FPN.MULTILEVEL_RPN and MULTILEVEL_ROIS, and MRCNN.ROI_SLOTS_PER_IM
on a single-scale model (sad_tpu's single-scale step takes the whole fg prefix).

Batch (tensors on the model's device, NHWC; data/rpn_minibatch.py):
  data (B, H, W, 3) float32 normalised, or data_u8 (B, H, W, 3) uint8 +
  content_hw (B, 2);  im_hw (B, 2) the scaled content extents;
  rpn_labels {lvl: (B, H_l, W_l, A) int32}, rpn_bbox_targets /
  rpn_bbox_inside_weights / rpn_bbox_outside_weights {lvl: (B, H_l, W_l, A, 4)};
  gt_boxes (B, G, 4), gt_classes (B, G) with 0 = padding;
  for Mask R-CNN gt_mask_rasters (B, G, Hm, Wm) and gt_mask_stride (a number);
  for Keypoint R-CNN gt_keypoints (B, G, K, 3) [x, y, visibility];
  for Fast R-CNN proposal_boxes (B, P, 4) in network-input coordinates and
  proposal_valid (B, P) in place of the RPN targets.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..models import bias_mask, trainable_mask
from ..models.rcnn import flat_rois
from ..models.single_scale import SingleScaleRCNN
from ..ops.detectron_ops import ohem_keep, smooth_l1_loss_per_roi
from ..ops.image_norm import content_mask, normalize_u8_on_device
from ..ops.losses import smooth_l1_loss
from ..ops.proposals import (
    map_rois_to_fpn_levels, multilevel_roi_align, sample_proposal_labels, sampled_fg_cap,
)
from ..parallel.distributed import all_reduce_counts, all_reduce_grads, shard_rows
from ..parallel.mesh import Mesh
from .mask_keypoint import (
    keypoint_loss, keypoint_targets_on_device, mask_loss, mask_targets_on_device,
)
from .optimizer import momentum_sgd_update
from .train_step import Metrics, TrainState

_QUEUE3 = " (ROADMAP.md Queue 3)"
# R-CNN models on row bands: ROADMAP.md "Not ported"
BANDS_NOT_PORTED = ("R-CNN models on row bands (a mesh with n_model > 1) are not ported: no "
                    "sad_tpu path runs an R-CNN model under spatial_sharding (ROADMAP.md "
                    "\"Not ported\", after item 7b)")


def _rfcn_targets(sampled, r: int) -> torch.Tensor:
    """R-FCN's class-agnostic (R, 8) targets: the fg class's 4 targets in
    columns 4:8 (sad_tpu/train/rcnn_train.py:45-51)."""
    t = sampled["bbox_targets"].reshape(r, -1, 4)
    w = sampled["bbox_inside_weights"].reshape(r, -1, 4)
    fg_t = (t * w).sum(dim=1)
    return torch.cat([torch.zeros_like(fg_t), fg_t], dim=1)


def _rfcn_weights(sampled, r: int) -> torch.Tensor:
    w = sampled["bbox_inside_weights"].reshape(r, -1, 4)
    fg_w = (w.sum(dim=1) > 0).float()
    return torch.cat([torch.zeros_like(fg_w), fg_w], dim=1)


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


def box_nll(cls_score, labels, valid) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-roi softmax-CE of the box head, zero where a roi is not live
    (padding, label -1), and the live mask."""
    logp = torch.log_softmax(cls_score.float(), dim=-1)
    nll = -torch.gather(logp, 1, labels.long().clamp_min(0)[:, None])[:, 0]
    live = valid & (labels >= 0)
    return torch.where(live, nll, 0.0), live


def ohem_select(cfg, nll, live, bbox_pred, bbox_targets, inside_w, outside_w,
                n_images: int) -> torch.Tensor:
    """TRAIN.OHEM's (R,) 0 / 1 weights: each image's OHEM_ROI_PER_IMG live
    rois of highest softmax-CE + smooth-L1 (padding ranks last, ties to the
    lower slot); no gradient flows through the selection."""
    per_box = smooth_l1_loss_per_roi(bbox_pred, bbox_targets, inside_w, outside_w)
    per_total = torch.where(live, nll + per_box, -1.0).detach()
    k = min(cfg.TRAIN.OHEM_ROI_PER_IMG, per_total.numel() // n_images)
    return ohem_keep(per_total.reshape(n_images, -1), k).reshape(-1) * live.float()


def box_weights(cfg, nll, live, bbox_pred, bbox_targets, inside_w, outside_w,
                n_images: int) -> torch.Tensor:
    """The (R,) weights of the box losses' rois: the live ones, or with
    TRAIN.OHEM and ``n_images`` those ``ohem_select`` keeps."""
    if cfg.TRAIN.OHEM and n_images:
        return ohem_select(cfg, nll, live, bbox_pred, bbox_targets, inside_w, outside_w,
                           n_images)
    return live.float()


def fast_rcnn_losses(cfg, cls_score, labels, bbox_pred, bbox_targets, inside_w, outside_w,
                     valid, n_groups: int, total_groups: Optional[int] = None,
                     n_images: int = 0, counts: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                     ranks: Optional[int] = None) -> Tuple[torch.Tensor, Metrics]:
    """Box-head losses (fast_rcnn_heads.py add_fast_rcnn_losses):
    SoftmaxWithLoss as the average of per-group means over the live rois
    (rows are n_groups consecutive blocks) and SmoothL1Loss, whose
    denominator is its static dim 0, scaled by MODEL.BBOX_REG_WEIGHT_SCALE.
    With TRAIN.OHEM and ``n_images`` (the rows are that many images' blocks)
    only the rois of ``ohem_select`` count: the per-group means over them and
    their smooth-L1. Scaled by 1 / ``total_groups`` (the groups of every
    rank; ``n_groups`` by default). ``counts`` = (the count each block is
    divided by, the live rois of the whole batch): a loss group's count over
    every rank, when the blocks are parts of groups that span ranks
    (RCNNTrainStep.group_counts); by default each block's own and this
    call's live rois. ``ranks``: the data ranks whose rows share the
    smooth-L1's denominator (total_groups // n_groups by default)."""
    ranks = ranks or (total_groups or n_groups) // n_groups
    nll, live = box_nll(cls_score, labels, valid)
    live_f = live.float()
    weight = box_weights(cfg, nll, live, bbox_pred, bbox_targets, inside_w, outside_w, n_images)
    out_w = outside_w * weight[:, None] if cfg.TRAIN.OHEM and n_images else outside_w
    sum_g = (nll * weight).reshape(n_groups, -1).sum(dim=1)  # exact for weight = live_f
    cnt_g = torch.clamp_min(weight.reshape(n_groups, -1).sum(dim=1) if counts is None
                            else counts[0], 1.0)
    cls_loss = (sum_g / cnt_g).sum() / (total_groups or n_groups)
    bbox_loss = smooth_l1_loss(bbox_pred, bbox_targets, inside_w, out_w, beta=1.0,
                               scale=cfg.MODEL.BBOX_REG_WEIGHT_SCALE / ranks)
    hit = (cls_score.argmax(dim=-1) == labels) & valid
    live_n = live_f.sum() if counts is None else counts[1]
    accuracy = hit.float().sum() / torch.clamp_min(live_n, 1.0)
    return cls_loss + bbox_loss, {"loss_cls": cls_loss, "loss_bbox": bbox_loss,
                                  "accuracy_cls": accuracy}


class RCNNTrainStep:
    """``step(state, batch, lr) -> metrics``: one training step of a
    GeneralizedRCNN or a SingleScaleRCNN, which updates the model's parameters and
    ``state.velocity`` in place and returns the metrics as 0-d tensors on the
    device. Its stages are methods, so that a profiler can time each one:
    inputs -> backbone -> rpn -> proposals -> sample -> box_outputs ->
    mask_parts / keypoint_parts -> group_counts -> box_loss, mask_branch_loss /
    keypoint_branch_loss -> grads -> apply (``box_branch``, ``mask_branch`` and
    ``keypoint_branch`` run a branch's forward and loss in one call).

    The sampler's random priorities come from ``generator`` (a
    torch.Generator on the model's device), or are handed to the step as
    ``uniforms`` = two (B, P + G) tensors. ``mesh``: the step of this rank of
    a mesh (n_model = 1), ``n_groups`` the batch's G (cfg.NUM_GPUS by
    default), on its data shard's images; ``rank`` of ``world`` > 1: the
    step of that rank of the (world, 1) mesh, ``n_groups`` its share of the
    groups. Either draws the whole batch's priorities from ``generator`` and
    takes its rows, and counts each loss group over the ranks
    (``group_counts``). ``counts`` holds the last step's (G,) global counts
    by name, detached."""

    def __init__(self, cfg, model: nn.Module, n_groups: Optional[int] = None,
                 generator: Optional[torch.Generator] = None, rank: int = 0, world: int = 1,
                 mesh: Optional[Mesh] = None):
        self.single = isinstance(model, SingleScaleRCNN)
        if not self.single and not (cfg.FPN.MULTILEVEL_RPN and cfg.FPN.MULTILEVEL_ROIS):
            raise NotImplementedError(
                "an FPN R-CNN step without FPN.MULTILEVEL_RPN and FPN.MULTILEVEL_ROIS: sad_tpu "
                "ignores MULTILEVEL_ROIS and takes its single-scale branch, which fails on an "
                "FPN model, without MULTILEVEL_RPN" + _QUEUE3)
        if self.single and cfg.MODEL.MASK_ON and cfg.MRCNN.ROI_SLOTS_PER_IM > 0:
            raise NotImplementedError(
                "MRCNN.ROI_SLOTS_PER_IM on a single-scale model: sad_tpu's single-scale step "
                "ignores it and takes the whole fg prefix" + _QUEUE3)
        self.cfg = cfg
        self.model = model
        self.n_groups = n_groups or cfg.NUM_GPUS
        self.generator = generator
        self.rank, self.world = rank, world
        self.mesh = mesh
        self.counts: Dict[str, torch.Tensor] = {}
        if mesh is not None:
            if world != 1:
                raise ValueError("a step takes a world or a mesh, not both")
            if mesh.n_model > 1:
                raise NotImplementedError(BANDS_NOT_PORTED)
            self.rank, self.world = mesh.rank, mesh.world
        t_mask = trainable_mask(model, cfg.TRAIN.FREEZE_AT, cfg.TRAIN.FREEZE_CONV_BODY)
        b_mask = bias_mask(model)
        named = dict(model.named_parameters())
        self.names = [n for n in named if t_mask[n]]
        self.params = [named[n] for n in self.names]
        self.is_bias = [b_mask[n] for n in self.names]

    # each rank's metrics are its share of the batch's (summed by the caller)
    global_metrics = False

    def layout(self) -> Optional[Tuple[int, int, int]]:
        """(data index, data ranks, the batch's loss groups) of a step over
        ranks, None for one process: the mesh's, or the (world, 1) mesh's,
        whose ``n_groups`` is the rank's share."""
        if self.mesh is not None:
            return self.mesh.data_index, self.mesh.n_data, self.n_groups
        if self.world > 1:
            return self.rank, self.world, self.n_groups * self.world
        return None

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
        layout = self.layout()
        images = next(iter(logits.values())).shape[0] * (layout[1] if layout else 1)
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
        layout = self.layout()
        if uniforms is None and layout is not None:
            # the whole batch's draws, in the order one process makes them
            d, n_data, _ = layout
            shape = (boxes.shape[0] * n_data, boxes.shape[1] + batch["gt_boxes"].shape[1])
            uniforms = tuple(
                shard_rows(torch.rand(shape, generator=self.generator, device=boxes.device),
                           d, n_data) for _ in range(2))
        return sample_proposal_labels(
            boxes, valid, batch["gt_boxes"], batch["gt_classes"], t.BATCH_SIZE_PER_IM,
            t.FG_FRACTION, t.FG_THRESH, t.BG_THRESH_HI, t.BG_THRESH_LO, m.NUM_CLASSES,
            m.BBOX_REG_WEIGHTS, generator=self.generator, uniforms=uniforms)

    def _roi_levels(self, rois5: torch.Tensor) -> torch.Tensor:
        f = self.cfg.FPN
        return map_rois_to_fpn_levels(rois5[:, 1:], f.ROI_MIN_LEVEL, f.ROI_MAX_LEVEL,
                                      f.ROI_CANONICAL_SCALE, f.ROI_CANONICAL_LEVEL)

    def box_outputs(self, feats, sampled, return_res5: bool = False):
        """The box head on the sampled rois from the NHWC ``feats``:
        (cls_score, bbox_pred) and, for a single-scale model with
        ``return_res5``, the res5 RoI maps."""
        cfg = self.cfg
        rois5 = flat_rois(sampled["rois"])
        if self.single:
            return self.model.box_forward(feats, rois5, return_res5)
        roi_feats = multilevel_roi_align(
            feats, rois5, self._roi_levels(rois5), sampled["valid"].reshape(-1),
            cfg.FAST_RCNN.ROI_XFORM_RESOLUTION, cfg.FAST_RCNN.ROI_XFORM_SAMPLING_RATIO)
        return self.model.box_head(roi_feats)

    def box_targets(self, sampled) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(targets, inside weights, outside weights) of the sampled rois as
        (R, 4C) rows, or R-FCN's class-agnostic (R, 8) for an 'rfcn' model."""
        n = sampled["labels"].numel()
        if self.cfg.MODEL.TYPE == "rfcn":
            w = _rfcn_weights(sampled, n)
            return _rfcn_targets(sampled, n), w, w
        return tuple(sampled[k].reshape(n, -1) for k in (
            "bbox_targets", "bbox_inside_weights", "bbox_outside_weights"))

    def box_loss(self, sampled, cls_score, bbox_pred, counts=None) -> Tuple[torch.Tensor, Metrics]:
        """fast_rcnn_losses of the box outputs against ``box_targets``; with
        ``counts`` (``group_counts``'), an image a block, each divided by
        its loss group's global count."""
        args = (self.cfg, cls_score, sampled["labels"].reshape(-1), bbox_pred,
                *self.box_targets(sampled), sampled["valid"].reshape(-1))
        b = sampled["rois"].shape[0]
        if counts is None:
            return fast_rcnn_losses(*args, self.n_groups, n_images=b)
        return fast_rcnn_losses(*args, b, counts["groups"], n_images=b,
                                counts=(counts["box"], counts["live"]), ranks=counts["ranks"])

    def box_branch(self, feats, sampled) -> Tuple[torch.Tensor, Metrics]:
        """RoIAlign (or R-FCN's PSRoIPool) of the sampled rois from the NHWC
        ``feats``, the box head and its losses."""
        return self.box_loss(sampled, *self.box_outputs(feats, sampled))

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

    def mask_parts(self, feats, sampled, batch, prefix=None, res5=None):
        """The mask branch's forward on the leading ``mask_cap`` slots of
        every image: (logits, targets, roi labels, is_fg), the targets
        cropped from the gt rasters on the device. A single-scale model's
        v0up head runs ``mask_heads`` on those slots' rois; v0upshare takes
        ``res5``, the box branch's res5 maps of every sampled roi (or,
        without it, runs the box head's res5 on the slots); an FPN model
        RoIAligns its fg prefix."""
        cfg = self.cfg
        if self.single:
            cap = self.mask_cap()
            rois = sampled["rois"][:, :cap]
            if res5 is not None:
                b = rois.shape[0]
                fg = res5.reshape((b, -1) + tuple(res5.shape[1:]))[:, :cap]
                mlogits = self.model.mask_from_res5(fg.reshape((-1,) + tuple(res5.shape[1:])))
            else:
                mlogits = self.model.mask_heads(feats, flat_rois(rois))
            targets = mask_targets_on_device(
                batch["gt_mask_rasters"], rois, sampled["matched_gt"][:, :cap],
                mlogits.shape[1], float(batch["gt_mask_stride"]))
            return (mlogits, targets, sampled["labels"][:, :cap].reshape(-1),
                    sampled["is_fg"][:, :cap].reshape(-1))
        p, mfeats = self._branch(feats, sampled, prefix, self.mask_cap(),
                                 cfg.MRCNN.ROI_XFORM_RESOLUTION,
                                 cfg.MRCNN.ROI_XFORM_SAMPLING_RATIO)
        mlogits = self.model.mask_head(mfeats)
        targets = mask_targets_on_device(
            batch["gt_mask_rasters"], p["rois"], p["matched_gt"],
            cfg.MRCNN.RESOLUTION, float(batch["gt_mask_stride"]))
        return mlogits, targets, p["labels"].reshape(-1), p["is_fg"]

    def mask_branch_loss(self, parts, counts=None) -> torch.Tensor:
        """mask_loss of ``mask_parts``; with ``counts`` an image a block."""
        if counts is None:
            return mask_loss(self.cfg, *parts, self.n_groups)
        return mask_loss(self.cfg, *parts, counts["images"], counts["groups"],
                         counts=counts["mask"])

    def mask_branch(self, feats, sampled, batch, prefix=None, res5=None) -> torch.Tensor:
        """The mask loss on the leading ``mask_cap`` slots of every image
        (``mask_parts``, then ``mask_branch_loss``)."""
        return self.mask_branch_loss(self.mask_parts(feats, sampled, batch, prefix, res5))

    def keypoint_parts(self, feats, sampled, batch, prefix=None):
        """The keypoint branch's forward on the leading ``kps_cap`` slots of
        every image: (logits, heatmap labels, their valid flags, is_fg),
        the labels from the gt keypoints on the device."""
        cfg = self.cfg
        p, kfeats = self._branch(feats, sampled, prefix, self.kps_cap(),
                                 cfg.KRCNN.ROI_XFORM_RESOLUTION,
                                 cfg.KRCNN.ROI_XFORM_SAMPLING_RATIO)
        klogits = self.model.keypoint_heads(kfeats)
        labels, valid = keypoint_targets_on_device(batch["gt_keypoints"], p["rois"],
                                                   p["matched_gt"], klogits.shape[1])
        return klogits, labels, valid, p["is_fg"]

    def keypoint_branch_loss(self, parts, counts=None) -> torch.Tensor:
        """keypoint_loss of ``keypoint_parts``; with ``counts`` an image a
        block, each a part of a group of ``counts['per_group']`` images."""
        b = parts[0].shape[0] // self.kps_cap()
        if counts is None:
            return keypoint_loss(self.cfg, *parts, self.n_groups, n_images=b)
        return keypoint_loss(self.cfg, *parts, b, n_images=b * counts["per_group"],
                             total_groups=counts["groups"], counts=counts["kps"])

    def keypoint_branch(self, feats, sampled, batch, prefix=None) -> torch.Tensor:
        """The keypoint loss on the leading ``kps_cap`` slots of every image
        (``keypoint_parts``, then ``keypoint_branch_loss``)."""
        return self.keypoint_branch_loss(self.keypoint_parts(feats, sampled, batch, prefix))

    @torch.no_grad()
    def group_counts(self, sampled, cls_score, bbox_pred, mask=None, kps=None
                     ) -> Optional[Dict[str, Any]]:
        """What each loss group's losses divide by, counted an image at a
        time and added into the batch's G groups (``counts``, by name):
        'box' the box head's live rois (or its OHEM keeps), 'live' its live
        rois (the accuracy's), 'mask' the fg rois of ``mask`` (mask_parts),
        'kps' the visible keypoints at fg rois of ``kps`` (keypoint_parts).
        Over ranks ONE all-reduce makes them global (integers in float32:
        exact), and the result maps each local image to its group's counts
        for the losses; for one process None (each loss counts its own
        groups)."""
        cfg = self.cfg
        b = sampled["rois"].shape[0]
        labels, valid = sampled["labels"].reshape(-1), sampled["valid"].reshape(-1)
        nll, live = box_nll(cls_score, labels, valid)
        weight = box_weights(cfg, nll, live, bbox_pred, *self.box_targets(sampled), b)
        rows = {"box": weight, "live": live.float()}
        if mask is not None:
            rows["mask"] = mask[3].float()
        if kps is not None:
            rows["kps"] = (kps[2] & kps[3][:, None]).float()
        part = torch.stack([r.reshape(b, -1).sum(dim=1) for r in rows.values()])
        layout = self.layout()
        d, n_data, groups = layout or (0, 1, self.n_groups)
        gidx = (d * b + torch.arange(b, device=part.device)) // (b * n_data // groups)
        total = torch.zeros((len(rows), groups), dtype=torch.float32, device=part.device)
        total.index_add_(1, gidx, part)
        if layout is not None:
            total = all_reduce_counts(total)
        self.counts = dict(zip(rows, total))
        if layout is None:
            return None
        out = {k: v[gidx] for k, v in self.counts.items()}
        out.update(live=self.counts["live"].sum(), images=b, groups=groups, ranks=n_data,
                   per_group=b * n_data // groups)
        return out

    def losses(self, batch, uniforms=None) -> Tuple[torch.Tensor, Metrics]:
        """Forward and every loss: (total, metrics)."""
        nchw = self.backbone(self.inputs(batch))
        if not self.cfg.MODEL.FASTER_RCNN and "proposal_boxes" in batch:
            # Fast R-CNN: the RPN head and its losses are skipped entirely
            total, metrics = 0.0, {}
            boxes, valid = batch["proposal_boxes"], batch["proposal_valid"]
        else:
            logits, deltas, total, metrics = self.rpn(nchw, batch)
            boxes, valid = self.proposals(logits, deltas, batch)
        sampled = self.sample(boxes, valid, batch, uniforms)
        feats = self.model.roi_features({l: f.permute(0, 2, 3, 1) for l, f in nchw.items()})
        m = self.cfg.MODEL
        mask_on = m.MASK_ON and "gt_mask_rasters" in batch
        kps_on = m.KEYPOINTS_ON and "gt_keypoints" in batch
        mask = kps = None
        if self.single:
            # v0upshare: the mask head reads the box branch's res5 maps
            share = mask_on and self.model.mask_share_res5
            cls_score, bbox_pred, *res5 = self.box_outputs(feats, sampled, share)
            if mask_on:
                mask = self.mask_parts(feats, sampled, batch, res5=res5[0] if share else None)
        else:
            cls_score, bbox_pred = self.box_outputs(feats, sampled)
            prefix = self.fg_prefix(sampled) if mask_on or kps_on else None
            if mask_on:
                mask = self.mask_parts(feats, sampled, batch, prefix)
            if kps_on:
                kps = self.keypoint_parts(feats, sampled, batch, prefix)
        counts = self.group_counts(sampled, cls_score, bbox_pred, mask, kps)
        box_total, box_metrics = self.box_loss(sampled, cls_score, bbox_pred, counts)
        total = total + box_total
        metrics.update(box_metrics)
        aux = []
        if mask is not None:
            metrics["loss_mask"] = self.mask_branch_loss(mask, counts)
            aux.append(metrics["loss_mask"])
        if kps is not None:
            metrics["loss_kps"] = self.keypoint_branch_loss(kps, counts)
            aux.append(metrics["loss_kps"])
        if aux:
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
        """The gradients summed over the ranks (none to sum over at world
        1), in two levels on a multislice mesh."""
        return all_reduce_grads(grads, self.mesh) if self.world > 1 else grads

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
                         world: int = 1, mesh: Optional[Mesh] = None) -> RCNNTrainStep:
    """The training step of a Fast / Faster / Mask / Keypoint R-CNN or R-FCN ``model`` (ref:
    sad_tpu make_rcnn_train_step). ``n_groups`` defaults to cfg.NUM_GPUS; over
    ``world`` ranks it is the rank's own count, on a ``mesh`` the batch's,
    and loss groups may span ranks."""
    return RCNNTrainStep(cfg, model, n_groups, generator, rank, world, mesh)
