"""Anchor generation and RetinaNet anchor->label assignment (host side, numpy).

A copy of sad_tpu/data/anchors.py without its calls into sad_tpu.native
(the optional C++ IoU and fused-assignment kernels): the port keeps the
float64 numpy path. tests/test_torch_minibatch.py holds the labels, masks
and fg counts equal to sad_tpu's and the targets within 1e-6.

Reimplements (vectorized, no Cython) the semantics of:
- detectron/lib/modeling/generate_anchors.py (cell anchor enumeration with the
  legacy rounding/+1 conventions),
- detectron/lib/roi_data/data_utils.py:39-103 (field of anchors),
- detectron/lib/roi_data/retinanet.py:198-306 (IoU label assignment), including
  its subtle ordering rules:
    * each gt's best-overlap anchors (with ties) are foregrounded first,
    * anchors over POSITIVE_OVERLAP are foregrounded,
    * num_fg is counted BEFORE the background stomp,
    * anchors under NEGATIVE_OVERLAP are then stomped to background — even if
      the tie rule marked them foreground (a real quirk of the reference),
    * dense bbox targets are written for the pre-stomp foreground set.

Anchor index ordering matches the reference head-channel layout:
a = octave * num_aspect_ratios + aspect (retinanet.py:144).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np


# --------------------------------------------------------------------------- #
# Cell anchors
# --------------------------------------------------------------------------- #


def generate_cell_anchors(
    stride: float,
    sizes: Sequence[float],
    aspect_ratios: Sequence[float],
) -> np.ndarray:
    """Anchors (x1,y1,x2,y2) centered on a stride cell, legacy conventions:
    sqrt-area sizing with rounding, +1 pixel extents (generate_anchors.py)."""
    base = np.array([0.0, 0.0, stride - 1.0, stride - 1.0])
    w = base[2] - base[0] + 1.0
    h = base[3] - base[1] + 1.0
    cx = base[0] + 0.5 * (w - 1.0)
    cy = base[1] + 0.5 * (h - 1.0)

    scales = np.asarray(sizes, dtype=np.float64) / stride
    ratios = np.asarray(aspect_ratios, dtype=np.float64)

    # ratio enumeration (rounded, legacy)
    size = w * h
    ws_r = np.round(np.sqrt(size / ratios))
    hs_r = np.round(ws_r * ratios)

    # scale enumeration applied to each ratio anchor
    out = []
    for wr, hr in zip(ws_r, hs_r):
        ws = wr * scales
        hs = hr * scales
        out.append(
            np.stack(
                [
                    cx - 0.5 * (ws - 1.0),
                    cy - 0.5 * (hs - 1.0),
                    cx + 0.5 * (ws - 1.0),
                    cy + 0.5 * (hs - 1.0),
                ],
                axis=-1,
            )
        )
    return np.concatenate(out, axis=0)


def retinanet_cell_anchors(
    level: int,
    anchor_scale: float,
    aspect_ratios: Sequence[float],
    scales_per_octave: int,
) -> np.ndarray:
    """(A, 4) cell anchors for one FPN level, ordered octave-major then aspect
    (matching the head channel layout, retinanet.py:77-95,144)."""
    stride = 2.0 ** level
    rows = []
    for octave in range(scales_per_octave):
        octave_scale = 2.0 ** (octave / float(scales_per_octave))
        for ar in aspect_ratios:
            rows.append(
                generate_cell_anchors(
                    stride, (stride * octave_scale * anchor_scale,), (ar,)
                )[0]
            )
    return np.stack(rows, axis=0)


# --------------------------------------------------------------------------- #
# Field of anchors
# --------------------------------------------------------------------------- #


def field_of_anchors(
    cell_anchors: np.ndarray,  # (A, 4)
    stride: float,
    field_h: int,
    field_w: int,
) -> np.ndarray:
    """(field_h, field_w, A, 4) anchors: cell anchors shifted to every grid
    position (data_utils.py:70-92, generalized to rectangular grids)."""
    sx = np.arange(field_w, dtype=np.float32) * stride
    sy = np.arange(field_h, dtype=np.float32) * stride
    shift_x, shift_y = np.meshgrid(sx, sy)
    shifts = np.stack([shift_x, shift_y, shift_x, shift_y], axis=-1)  # (H,W,4)
    return (
        shifts[:, :, None, :] + cell_anchors[None, None, :, :]
    ).astype(np.float32)


@dataclass(frozen=True)
class AnchorGrid:
    """Per-level anchor fields for a fixed (padded) training canvas."""

    levels: Tuple[int, ...]
    strides: Tuple[float, ...]
    field_hw: Tuple[Tuple[int, int], ...]  # per level (H_l, W_l)
    anchors: Tuple[np.ndarray, ...]  # per level (H_l, W_l, A, 4)
    num_anchors: int  # A

    def flat_anchors(self) -> np.ndarray:
        """All anchors concatenated (T, 4) in level-major, y-major, x, anchor
        order — the order assignment results are split back from. Cached
        (anchor fields are immutable)."""
        cached = getattr(self, "_flat_cache", None)
        if cached is None:
            cached = np.concatenate(
                [a.reshape(-1, 4) for a in self.anchors], axis=0
            )
            object.__setattr__(self, "_flat_cache", cached)
        return cached


def all_field_anchors(
    levels: Sequence[int],
    anchor_scale: float,
    aspect_ratios: Sequence[float],
    scales_per_octave: int,
    canvas_h: int,
    canvas_w: int,
) -> AnchorGrid:
    """Build per-level anchor fields covering a (canvas_h, canvas_w) image."""
    fields = []
    strides = []
    hw = []
    for lvl in levels:
        stride = 2.0 ** lvl
        ca = retinanet_cell_anchors(lvl, anchor_scale, aspect_ratios, scales_per_octave)
        fh = int(np.ceil(canvas_h / stride))
        fw = int(np.ceil(canvas_w / stride))
        fields.append(field_of_anchors(ca, stride, fh, fw))
        strides.append(stride)
        hw.append((fh, fw))
    return AnchorGrid(
        levels=tuple(levels),
        strides=tuple(strides),
        field_hw=tuple(hw),
        anchors=tuple(fields),
        num_anchors=fields[0].shape[2],
    )


# --------------------------------------------------------------------------- #
# Label assignment
# --------------------------------------------------------------------------- #


def _iou_matrix(anchors: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Pairwise IoU with the legacy +1 convention (cython_bbox.pyx)."""
    aw = anchors[:, 2] - anchors[:, 0] + 1.0
    ah = anchors[:, 3] - anchors[:, 1] + 1.0
    ga = (gt[:, 2] - gt[:, 0] + 1.0) * (gt[:, 3] - gt[:, 1] + 1.0)
    iw = (
        np.minimum(anchors[:, None, 2], gt[None, :, 2])
        - np.maximum(anchors[:, None, 0], gt[None, :, 0])
        + 1.0
    ).clip(min=0.0)
    ih = (
        np.minimum(anchors[:, None, 3], gt[None, :, 3])
        - np.maximum(anchors[:, None, 1], gt[None, :, 1])
        + 1.0
    ).clip(min=0.0)
    inter = iw * ih
    return inter / ((aw * ah)[:, None] + ga[None, :] - inter)


def _assignment_iou(anchors: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """IoU for label assignment, in float64 (sad_tpu's numpy path)."""
    return _iou_matrix(anchors.astype(np.float64), gt.astype(np.float64))


def _encode_boxes(ex: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """bbox_transform_inv with unit weights (boxes.py/data_utils.py:122)."""
    ew = ex[:, 2] - ex[:, 0] + 1.0
    eh = ex[:, 3] - ex[:, 1] + 1.0
    ecx = ex[:, 0] + 0.5 * ew
    ecy = ex[:, 1] + 0.5 * eh
    gw = gt[:, 2] - gt[:, 0] + 1.0
    gh = gt[:, 3] - gt[:, 1] + 1.0
    gcx = gt[:, 0] + 0.5 * gw
    gcy = gt[:, 1] + 0.5 * gh
    return np.stack(
        [(gcx - ecx) / ew, (gcy - ecy) / eh, np.log(gw / ew), np.log(gh / eh)],
        axis=-1,
    ).astype(np.float32)


def assign_retinanet_labels(
    grid: AnchorGrid,
    gt_boxes: np.ndarray,  # (G, 4) scaled to canvas coords
    gt_classes: np.ndarray,  # (G,) int, 1..C
    im_h: float,  # scaled image height (content extent on the canvas)
    im_w: float,
    positive_overlap: float = 0.5,
    negative_overlap: float = 0.4,
) -> Tuple[List[np.ndarray], List[np.ndarray], List[np.ndarray], float, float]:
    """Assign labels/targets on the anchor grid.

    Returns per-level lists:
      labels   (H_l, W_l, A) int32: -1 ignore / 0 bg / 1..C fg
      targets  (H_l, W_l, A, 4) float32 dense box-encoding targets
      fg_mask  (H_l, W_l, A) bool: positions contributing to the bbox loss
    plus scalars (num_fg, num_bg) counted with the reference's conventions
    (pre-stomp fg count — the focal/select-smooth-L1 normalizer,
    retinanet.py:244-247,301-305).

    Grid positions outside the image content extent (y >= im_h/stride or
    x >= im_w/stride) are forced to ignore in ``labels``, mirroring the
    reference's label crop ``_labels[:, :, 0:h, 0:w]`` (retinanet.py:296).
    The bbox ``fg_mask`` is NOT cropped: the reference gathers fg locations
    from the pre-crop field (``np.where(_labels > 0)`` at retinanet.py:278
    runs before the crop), so border-overhanging fg anchors do contribute to
    the bbox loss there — replicated here.
    """
    flat = grid.flat_anchors()
    total = flat.shape[0]
    labels = np.full((total,), -1, dtype=np.int32)
    targets = np.zeros((total, 4), dtype=np.float32)
    fg_pre = np.zeros((total,), dtype=bool)

    if len(gt_boxes) > 0:
        iou = _assignment_iou(flat, gt_boxes)
        a2g_argmax = iou.argmax(axis=1)
        a2g_max = iou[np.arange(total), a2g_argmax]
        g2a_max = iou.max(axis=0)
        # every anchor tied at a gt's max overlap (including ties)
        tie_mask = (iou == g2a_max[None, :]).any(axis=1)
        tie_rows = np.where(tie_mask)[0]
        labels[tie_rows] = gt_classes[a2g_argmax[tie_rows]]
        over = a2g_max >= positive_overlap
        labels[over] = gt_classes[a2g_argmax[over]]

        fg_pre = labels >= 1
        bg = a2g_max < negative_overlap
        labels[bg] = 0  # reference order: may stomp tie-rule foregrounds
        num_fg = float(fg_pre.sum())
        num_bg = float(bg.sum())
        targets[fg_pre] = _encode_boxes(flat[fg_pre], gt_boxes[a2g_argmax[fg_pre]])
    else:
        num_fg, num_bg = 0.0, float(total)
        labels[:] = 0

    # bbox-loss mask follows the *post-stomp* labels (retinanet.py:278)
    fg_mask_flat = labels >= 1

    out_labels, out_targets, out_masks = [], [], []
    start = 0
    for (fh, fw), a, stride in zip(grid.field_hw, grid.anchors, grid.strides):
        n = fh * fw * grid.num_anchors
        l = labels[start : start + n].reshape(fh, fw, grid.num_anchors)
        t = targets[start : start + n].reshape(fh, fw, grid.num_anchors, 4)
        m = fg_mask_flat[start : start + n].reshape(fh, fw, grid.num_anchors)
        start += n
        # crop-to-image: outside content extent -> ignore / no bbox loss
        h = int(im_h / stride)
        w = int(im_w / stride)
        if h < fh or w < fw:
            l = l.copy()
            l[h:, :, :] = -1
            l[:, w:, :] = -1
        out_labels.append(l.astype(np.int32))
        out_targets.append(t)
        out_masks.append(m)
    return out_labels, out_targets, out_masks, num_fg, num_bg


def reference_num_bg_metric(num_bg: float, num_fg: float, num_classes: int) -> float:
    """The reference's reported bg count metric (retinanet.py:302-304)."""
    return (num_bg + 1.0) * (num_classes - 1) + num_fg * (num_classes - 2)
