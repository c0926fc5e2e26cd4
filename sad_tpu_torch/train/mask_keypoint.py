"""Mask and Keypoint R-CNN training: targets made on the device, and the
mask and keypoint losses (ref: sad_tpu/train/mask_keypoint.py;
detectron/lib/roi_data/{mask_rcnn, keypoint_rcnn}.py, mask_rcnn_heads.py
add_mask_rcnn_losses and keypoint_rcnn_heads.py add_keypoint_losses).

The rois are sampled on the device, so the targets are cut on the device
too: each roi's matched gt raster (rasterised once per image on the host at
a fixed stride, data/rpn_minibatch.py) is RoIAlign-cropped to the mask
resolution and thresholded at 0.5. sad_tpu crops with its single-level
``roi_align`` at scale 1 / stride over a (1, Hm, Wm, G) map and picks the
matched gt's channel. Here the same arithmetic is the multilevel RoIAlign
with one level, the stride's (stride 4 = level 2), over the (B * G, Hm, Wm, 1)
rasters with the roi's batch index pointing at its image's matched raster,
so only the wanted raster is read. On the card that is the RoIAlign forward
kernel (one launch a step beside the two that carry gradients); no gradient
flows through it.

Keypoints: each roi's matched gt keypoints become one flat heatmap index
per keypoint, with a weight of 1 where the keypoint is visible and inside
the roi (keypoint_rcnn.py keypoints_to_heatmap_labels). As in sad_tpu, the
keypoint head runs on the box head's fg slots rather than on a second,
keypoint-only sample (sad_tpu/train/mask_keypoint.py:22-31): rois without a
visible keypoint carry zero weight, and a group with too few visible
keypoints contributes no keypoint loss (the reference's
finalize_keypoint_minibatch, as a predicate on the device).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.roi_align import multilevel_roi_align


def mask_targets_on_device(
    gt_mask_rasters: torch.Tensor,  # (B, G, Hm, Wm) float {0, 1} at stride `mask_stride`
    rois: torch.Tensor,  # (B, R, 4) in network-input coordinates
    matched_gt: torch.Tensor,  # (B, R) index into G
    resolution: int,
    mask_stride: float,
) -> torch.Tensor:
    """Crop each roi's matched gt raster to binary targets: (B * R, res, res)
    float32, image-major."""
    level = int(round(math.log2(float(mask_stride))))
    if 2.0 ** level != float(mask_stride):
        raise ValueError(f"gt_mask_stride {mask_stride} is not a power of two")
    b, g, hm, wm = gt_mask_rasters.shape
    r = rois.shape[1]
    with torch.no_grad():
        maps = gt_mask_rasters.reshape(b * g, hm, wm, 1).float().contiguous()
        image = torch.arange(b, device=rois.device)[:, None] * g
        which = (image + matched_gt.long().clamp(0, g - 1)).reshape(-1, 1).float()
        rois5 = torch.cat([which, rois.reshape(-1, 4).float()], dim=1)
        n = b * r
        crops = multilevel_roi_align(
            {level: maps}, rois5,
            torch.full((n,), level, dtype=torch.int32, device=rois.device),
            torch.ones((n,), dtype=torch.bool, device=rois.device), resolution, 2)
        return (crops[..., 0] >= 0.5).float()


def mask_loss(
    cfg,
    mask_logits: torch.Tensor,  # (R, M, M, C) per-class logits
    mask_targets: torch.Tensor,  # (R, M, M) binary
    roi_labels: torch.Tensor,  # (R,) class of each roi (0 bg)
    is_fg: torch.Tensor,  # (R,)
    n_groups: int,
    total_groups: Optional[int] = None,
) -> torch.Tensor:
    """Sigmoid cross-entropy on the gt-class channel at fg rois, the mean
    over fg mask elements per group of consecutive rows, averaged over the
    groups (the reference's per-GPU means scaled by 1 / NUM_GPUS and summed
    by the gradient allreduce), times MRCNN.WEIGHT_LOSS_MASK; divided by
    ``total_groups`` (the groups of every rank; ``n_groups`` by default)."""
    if cfg.MRCNN.CLS_SPECIFIC_MASK:
        idx = roi_labels.long().clamp_min(0)[:, None, None, None]
        sel = torch.gather(mask_logits, 3, idx.expand(-1, *mask_logits.shape[1:3], 1))[..., 0]
    else:
        sel = mask_logits[..., 0]
    x = sel.float()
    ge = (x >= 0).float()
    ce = -x * (mask_targets - ge) + torch.log(1.0 + torch.exp(x - 2.0 * x * ge))
    w = is_fg.float()[:, None, None]
    sum_g = (ce * w).reshape(n_groups, -1).sum(dim=1)
    count_g = torch.clamp_min(w.reshape(n_groups, -1).sum(dim=1) * sel.shape[1] * sel.shape[2],
                              1.0)
    return cfg.MRCNN.WEIGHT_LOSS_MASK * (sum_g / count_g).sum() / (total_groups or n_groups)


def keypoint_targets_on_device(
    gt_keypoints: torch.Tensor,  # (B, G, K, 3) [x, y, visibility]
    rois: torch.Tensor,  # (B, R, 4)
    matched_gt: torch.Tensor,  # (B, R) index into G
    heatmap_size: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat heatmap index labels (B * R, K) int64 and their valid flags
    (B * R, K), image-major (keypoint_rcnn.py keypoints_to_heatmap_labels)."""
    b, r = matched_gt.shape
    k = gt_keypoints.shape[2]
    with torch.no_grad():
        idx = matched_gt.long().clamp(0, gt_keypoints.shape[1] - 1)
        kp = torch.gather(gt_keypoints.float(), 1, idx[:, :, None, None].expand(b, r, k, 3))
        rois = rois.float()
        x1, y1, x2, y2 = (rois[..., i, None] for i in range(4))
        size = torch.full_like(x1, float(heatmap_size))  # tensor / tensor: IEEE division
        sx = size / torch.clamp_min(x2 - x1, 1.0)
        sy = size / torch.clamp_min(y2 - y1, 1.0)
        px = torch.floor((kp[..., 0] - x1) * sx).int()
        py = torch.floor((kp[..., 1] - y1) * sy).int()
        inside = (px >= 0) & (px < heatmap_size) & (py >= 0) & (py < heatmap_size)
        visible = (kp[..., 2] > 0) & inside
        px = px.clamp(0, heatmap_size - 1)
        py = py.clamp(0, heatmap_size - 1)
        labels = (py * heatmap_size + px).long()
        return labels.reshape(b * r, k), visible.reshape(b * r, k)


def keypoint_loss(
    cfg,
    kps_logits: torch.Tensor,  # (R, S, S, K) heatmap logits
    heat_labels: torch.Tensor,  # (R, K) flat heatmap indices
    heat_valid: torch.Tensor,  # (R, K)
    is_fg: torch.Tensor,  # (R,)
    n_groups: int,
    n_images: int = 0,
    total_groups: Optional[int] = None,
) -> torch.Tensor:
    """Softmax cross-entropy over the heatmap per visible keypoint at fg
    rois (keypoint_rcnn_heads.py:110-149): per group of consecutive rows,
    with KRCNN.NORMALIZE_BY_VISIBLE_KEYPOINTS the mean over its visible
    keypoints, else its sum over the fixed expected count of fg keypoints,
    n_images / n_groups * BATCH_SIZE_PER_IM * FG_FRACTION * K
    (keypoint_rcnn.py:105-110; ``n_images`` is the images of this batch);
    a group with no more than MIN_KEYPOINT_COUNT_FOR_VALID_MINIBATCH visible
    keypoints gives 0; the groups summed, times KRCNN.LOSS_WEIGHT, divided
    by ``total_groups`` (the groups of every rank; ``n_groups`` by
    default)."""
    kr = cfg.KRCNN
    r, s, _, k = kps_logits.shape
    flat = kps_logits.reshape(r, s * s, k).transpose(1, 2)  # (R, K, S*S)
    logp = torch.log_softmax(flat.float(), dim=-1)
    nll = -torch.gather(logp, 2, heat_labels.long()[..., None])[..., 0]
    w = (heat_valid & is_fg[:, None]).float()
    sum_g = (nll * w).reshape(n_groups, -1).sum(dim=1)
    nvis_g = w.reshape(n_groups, -1).sum(dim=1)
    if kr.NORMALIZE_BY_VISIBLE_KEYPOINTS:
        per_group = sum_g / torch.clamp_min(nvis_g, 1.0)
    else:
        if not n_images:
            raise ValueError(
                "keypoint_loss with NORMALIZE_BY_VISIBLE_KEYPOINTS=False needs n_images (the "
                "fixed denominator is per image, not per roi row)")
        ims = n_images // n_groups
        denom = float(np.float32(ims * cfg.TRAIN.BATCH_SIZE_PER_IM * cfg.TRAIN.FG_FRACTION * k))
        per_group = sum_g / torch.full_like(sum_g, denom)
    gate = nvis_g > kr.MIN_KEYPOINT_COUNT_FOR_VALID_MINIBATCH
    per_group = torch.where(gate, per_group, 0.0)
    return kr.LOSS_WEIGHT * per_group.sum() / (total_groups or n_groups)
