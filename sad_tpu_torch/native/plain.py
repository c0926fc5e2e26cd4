"""Numpy float32 twins of the native IoU and assignment passes, in the C++'s
operation order: areas as ``(x2 - x1 + 1) * (y2 - y1 + 1)``, the union as
``(b_area + g_area) - inter``, an overlap only where both extents are
positive, the per-gt best overlap starting at 0, the per-anchor best at -1
with a strict ``>`` (the first index wins a tie). No fused multiply-adds on
either side, so every IoU is the same float32 and the outputs are bit-equal
to ``sad_tpu_torch.native``. The tests and chip_smoke.py hold the library to
them; nothing on the training path calls them (they build the (N, K) matrix
the fused pass avoids).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_ONE = np.float32(1.0)


def _areas(b: np.ndarray) -> np.ndarray:
    return (b[:, 2] - b[:, 0] + _ONE) * (b[:, 3] - b[:, 1] + _ONE)


def bbox_overlaps_plain(boxes: np.ndarray, query: np.ndarray) -> np.ndarray:
    """(N, K) float32 IoU, as sad_bbox_overlaps."""
    b = np.ascontiguousarray(boxes, np.float32)
    q = np.ascontiguousarray(query, np.float32)
    iw = np.minimum(b[:, None, 2], q[None, :, 2]) - np.maximum(b[:, None, 0], q[None, :, 0]) + _ONE
    ih = np.minimum(b[:, None, 3], q[None, :, 3]) - np.maximum(b[:, None, 1], q[None, :, 1]) + _ONE
    inter = iw * ih
    union = _areas(b)[:, None] + _areas(q)[None, :] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = inter / union
    return np.where((iw > 0) & (ih > 0), iou, np.float32(0.0)).astype(np.float32)


def assign_overlaps_plain(anchors: np.ndarray, gt: np.ndarray
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(a2g_max, a2g_argmax, tie_mask), as sad_assign_overlaps."""
    iou = bbox_overlaps_plain(anchors, gt)
    n, k = iou.shape
    if k == 0:
        return (np.full((n,), -1.0, np.float32), np.zeros((n,), np.int64),
                np.zeros((n,), bool))
    a2g_argmax = iou.argmax(axis=1)
    a2g_max = iou[np.arange(n), a2g_argmax]
    g2a_max = iou.max(axis=0, initial=np.float32(0.0))
    tie = (iou == g2a_max[None, :]).any(axis=1)
    return a2g_max, a2g_argmax.astype(np.int64), tie
