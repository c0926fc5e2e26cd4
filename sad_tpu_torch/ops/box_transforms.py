"""Box regression decode (ref: sad_tpu/ops/box_transforms.py:20-54,
detectron/lib/utils/boxes.py bbox_transform), legacy "+1" pixel extents."""

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
