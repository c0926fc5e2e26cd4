"""Mask R-CNN training: mask targets made on the device, and the mask loss
(ref: sad_tpu/train/mask_keypoint.py:47-102;
detectron/lib/roi_data/mask_rcnn.py and mask_rcnn_heads.py
add_mask_rcnn_losses).

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

The keypoint targets and loss of that file are not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

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


def keypoint_targets_on_device(*args, **kwargs) -> Tuple[torch.Tensor, torch.Tensor]:
    raise NotImplementedError(
        "keypoint_targets_on_device is not ported to sad_tpu_torch yet (ROADMAP.md Queue 1 "
        "item 8)")


def keypoint_loss(*args, **kwargs) -> torch.Tensor:
    raise NotImplementedError(
        "keypoint_loss is not ported to sad_tpu_torch yet (ROADMAP.md Queue 1 item 8)")
