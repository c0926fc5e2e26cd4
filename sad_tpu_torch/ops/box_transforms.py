"""Box regression decode and encode, clipping and IoU (ref:
sad_tpu/ops/box_transforms.py; detectron/lib/utils/boxes.py and
cython_bbox.pyx), legacy "+1" pixel extents."""

from __future__ import annotations

import math

import torch

# cfg.BBOX_XFORM_CLIP = log(1000/16) (config.py:926)
BBOX_XFORM_CLIP = math.log(1000.0 / 16.0)


def bbox_transform(
    boxes: torch.Tensor,  # (..., 4) x1,y1,x2,y2 anchor/proposal boxes
    deltas: torch.Tensor,  # (..., 4) dx,dy,dw,dh
    weights=(1.0, 1.0, 1.0, 1.0),
    clip: float = BBOX_XFORM_CLIP,
) -> torch.Tensor:
    """Apply regression deltas to boxes."""
    boxes = boxes.float()
    deltas = deltas.float()
    widths = boxes[..., 2] - boxes[..., 0] + 1.0
    heights = boxes[..., 3] - boxes[..., 1] + 1.0
    ctr_x = boxes[..., 0] + 0.5 * widths
    ctr_y = boxes[..., 1] + 0.5 * heights

    wx, wy, ww, wh = weights
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = torch.clamp(deltas[..., 2] / ww, max=clip)
    dh = torch.clamp(deltas[..., 3] / wh, max=clip)

    pred_ctr_x = dx * widths + ctr_x
    pred_ctr_y = dy * heights + ctr_y
    pred_w = torch.exp(dw) * widths
    pred_h = torch.exp(dh) * heights

    # the trailing "-1" on x2/y2 is the legacy pixel convention
    return torch.stack(
        [
            pred_ctr_x - 0.5 * pred_w,
            pred_ctr_y - 0.5 * pred_h,
            pred_ctr_x + 0.5 * pred_w - 1.0,
            pred_ctr_y + 0.5 * pred_h - 1.0,
        ],
        dim=-1,
    )


def bbox_transform_inv(ex_rois: torch.Tensor, gt_rois: torch.Tensor,
                       weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Regression targets from example boxes (..., 4) to gt boxes (..., 4)
    (boxes.py bbox_transform_inv)."""
    ex_rois, gt_rois = ex_rois.float(), gt_rois.float()
    ex_w = ex_rois[..., 2] - ex_rois[..., 0] + 1.0
    ex_h = ex_rois[..., 3] - ex_rois[..., 1] + 1.0
    ex_cx = ex_rois[..., 0] + 0.5 * ex_w
    ex_cy = ex_rois[..., 1] + 0.5 * ex_h

    gt_w = gt_rois[..., 2] - gt_rois[..., 0] + 1.0
    gt_h = gt_rois[..., 3] - gt_rois[..., 1] + 1.0
    gt_cx = gt_rois[..., 0] + 0.5 * gt_w
    gt_cy = gt_rois[..., 1] + 0.5 * gt_h

    wx, wy, ww, wh = weights
    return torch.stack(
        [
            wx * (gt_cx - ex_cx) / ex_w,
            wy * (gt_cy - ex_cy) / ex_h,
            ww * torch.log(gt_w / ex_w),
            wh * torch.log(gt_h / ex_h),
        ],
        dim=-1,
    )


def bbox_overlaps(boxes: torch.Tensor, query_boxes: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU (..., N, K) of boxes (..., N, 4) and query boxes
    (..., K, 4) with the "+1" areas (cython_bbox.pyx bbox_overlaps); 0 where
    the union is not positive."""
    boxes, query_boxes = boxes.float(), query_boxes.float()
    b_area = (boxes[..., 2] - boxes[..., 0] + 1.0) * (boxes[..., 3] - boxes[..., 1] + 1.0)
    q_area = (query_boxes[..., 2] - query_boxes[..., 0] + 1.0) * (
        query_boxes[..., 3] - query_boxes[..., 1] + 1.0)
    b, q = boxes[..., :, None, :], query_boxes[..., None, :, :]
    iw = torch.clamp(torch.minimum(b[..., 2], q[..., 2]) - torch.maximum(b[..., 0], q[..., 0])
                     + 1.0, min=0.0)
    ih = torch.clamp(torch.minimum(b[..., 3], q[..., 3]) - torch.maximum(b[..., 1], q[..., 1])
                     + 1.0, min=0.0)
    inter = iw * ih
    union = b_area[..., :, None] + q_area[..., None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)


def clip_boxes(boxes: torch.Tensor, height, width) -> torch.Tensor:
    """Clip (..., 4) boxes to [0, size-1] (ref: sad_tpu/ops/box_transforms.py
    clip_boxes; boxes.py clip_tiled_boxes). ``height`` and ``width`` are
    tensors on the boxes' device that broadcast against ``boxes[..., 0]``
    (no host value is copied to the device here)."""
    hi = torch.stack([width, height, width, height], dim=-1).to(boxes.dtype) - 1.0
    return torch.minimum(torch.clamp(boxes, min=0.0), hi)
