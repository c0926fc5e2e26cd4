"""RPN training targets and R-CNN training batches (host side, numpy).

A copy of sad_tpu/data/rpn_minibatch.py: ``rpn_anchor_grid``,
``assign_rpn_labels``, ``add_rpn_blobs_to_batch`` and
``RCNNMinibatchBuilder`` with the gt padding, the gt mask rasters
(rasterised with this package's utils/segms.py) and the gt keypoints; the
IoU is the float32 native kernel (``anchors._assignment_iou``), as
sad_tpu's. Not copied: precomputed proposals (``pad_proposals``, pure Fast
R-CNN; ROADMAP.md Queue 1 item 8). Added: ``build`` takes the images in memory
and, with ``device_normalize``, ships one uint8 canvas per image and its
content extent for the train step to normalise on the device, as
RetinaNetMinibatchBuilder does.

Capability-equivalent to detectron/lib/roi_data/rpn.py add_rpn_blobs +
_get_rpn_blobs (FPN path):
- anchors: 1 size per level (RPN_ANCHOR_START_SIZE * 2^(lvl-min)), all
  RPN_ASPECT_RATIOS (FPN.py/rpn_heads.py FPN wiring),
- straddle filter: anchors crossing the image border by more than
  TRAIN.RPN_STRADDLE_THRESH are excluded (-1) from assignment
  (rpn.py inds_inside; thresh < 0 keeps all),
- labels: 1 for each gt's max-overlap anchors (with ties) and IoU >=
  RPN_POSITIVE_OVERLAP; 0 for IoU < RPN_NEGATIVE_OVERLAP; else -1,
- subsample to RPN_BATCH_SIZE_PER_IM with <= RPN_FG_FRACTION foreground
  (rpn.py:195-213),
- bbox targets on fg anchors; inside weights 1 on fg; outside weights
  1/num_examples on all sampled anchors (rpn.py:216-237).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import Config
from .anchors import (
    AnchorGrid, _assignment_iou, _encode_boxes, field_of_anchors, generate_cell_anchors,
)


def rpn_anchor_grid(cfg: Config, canvas_h: int, canvas_w: int) -> AnchorGrid:
    """FPN: one size per level x RPN_ASPECT_RATIOS."""
    fields, strides, hw, levels = [], [], [], []
    if not (cfg.FPN.FPN_ON and cfg.FPN.MULTILEVEL_RPN):
        raise NotImplementedError(
            "the single-scale (C4 / R-FCN) RPN anchor grid is not ported to "
            "sad_tpu_torch yet (ROADMAP.md Queue 1 item 8)")
    lvl_range = range(cfg.FPN.RPN_MIN_LEVEL, cfg.FPN.RPN_MAX_LEVEL + 1)
    specs = [
        (
            lvl,
            2.0 ** lvl,
            [
                (cfg.FPN.RPN_ANCHOR_START_SIZE
                 * (2 ** (lvl - cfg.FPN.RPN_MIN_LEVEL)), ar)
                for ar in cfg.FPN.RPN_ASPECT_RATIOS
            ],
        )
        for lvl in lvl_range
    ]
    for lvl, stride, size_ars in specs:
        cell = np.concatenate(
            [generate_cell_anchors(stride, (s,), (ar,)) for s, ar in size_ars]
        )
        fh = int(np.ceil(canvas_h / stride))
        fw = int(np.ceil(canvas_w / stride))
        fields.append(field_of_anchors(cell, stride, fh, fw))
        strides.append(stride)
        hw.append((fh, fw))
        levels.append(lvl)
    return AnchorGrid(
        levels=tuple(levels),
        strides=tuple(strides),
        field_hw=tuple(hw),
        anchors=tuple(fields),
        num_anchors=fields[0].shape[2],
    )


def assign_rpn_labels(
    cfg: Config,
    grid: AnchorGrid,
    gt_boxes: np.ndarray,  # (G, 4) scaled
    im_h: float,
    im_w: float,
    rng: np.random.RandomState,
) -> Tuple[List[np.ndarray], List[np.ndarray], List[np.ndarray], List[np.ndarray]]:
    """Returns per-level (labels (H,W,A), targets (H,W,A,4),
    inside_w (H,W,A,4), outside_w (H,W,A,4))."""
    flat = grid.flat_anchors()
    total = flat.shape[0]
    labels = np.full((total,), -1, np.int32)
    targets = np.zeros((total, 4), np.float32)

    straddle = cfg.TRAIN.RPN_STRADDLE_THRESH
    if straddle >= 0:
        inside = (
            (flat[:, 0] >= -straddle)
            & (flat[:, 1] >= -straddle)
            & (flat[:, 2] < im_w + straddle)
            & (flat[:, 3] < im_h + straddle)
        )
    else:
        inside = np.ones((total,), bool)

    if len(gt_boxes) > 0:
        iou = _assignment_iou(flat, gt_boxes)
        iou[~inside] = -1.0
        a2g_argmax = iou.argmax(axis=1)
        a2g_max = iou[np.arange(total), a2g_argmax]
        g2a_max = iou.max(axis=0)
        ties = (iou == g2a_max[None, :]).any(axis=1) & inside
        labels[ties] = 1
        labels[(a2g_max >= cfg.TRAIN.RPN_POSITIVE_OVERLAP) & inside] = 1
        bg = (a2g_max < cfg.TRAIN.RPN_NEGATIVE_OVERLAP) & inside
        bg &= labels != 1
        labels[bg] = 0
    else:
        labels[inside] = 0

    # subsample (rpn.py:195-213)
    num_fg_cap = int(cfg.TRAIN.RPN_FG_FRACTION * cfg.TRAIN.RPN_BATCH_SIZE_PER_IM)
    fg_inds = np.where(labels == 1)[0]
    if len(fg_inds) > num_fg_cap:
        disable = rng.choice(fg_inds, len(fg_inds) - num_fg_cap, replace=False)
        labels[disable] = -1
        fg_inds = np.where(labels == 1)[0]
    num_bg_cap = cfg.TRAIN.RPN_BATCH_SIZE_PER_IM - (labels == 1).sum()
    bg_inds = np.where(labels == 0)[0]
    if len(bg_inds) > num_bg_cap:
        disable = rng.choice(bg_inds, len(bg_inds) - num_bg_cap, replace=False)
        labels[disable] = -1

    if len(gt_boxes) > 0 and len(fg_inds) > 0:
        targets[fg_inds] = _encode_boxes(flat[fg_inds], gt_boxes[a2g_argmax[fg_inds]])

    inside_w = np.zeros((total, 4), np.float32)
    inside_w[labels == 1] = 1.0
    outside_w = np.zeros((total, 4), np.float32)
    num_examples = max((labels >= 0).sum(), 1)
    outside_w[labels >= 0] = 1.0 / num_examples

    out = []
    start = 0
    for (fh, fw) in grid.field_hw:
        n = fh * fw * grid.num_anchors
        sl = slice(start, start + n)
        out.append(
            (
                labels[sl].reshape(fh, fw, grid.num_anchors),
                targets[sl].reshape(fh, fw, grid.num_anchors, 4),
                inside_w[sl].reshape(fh, fw, grid.num_anchors, 4),
                outside_w[sl].reshape(fh, fw, grid.num_anchors, 4),
            )
        )
        start += n
    return tuple(zip(*out))


class RCNNMinibatchBuilder:
    """Static-shape training batches for the Faster / Mask / Keypoint R-CNN
    path (images + RPN targets + padded gt; optional gt mask rasters and gt
    keypoints (B, max_gt, NUM_KEYPOINTS, 3) [x, y, visibility] in network
    input coordinates). The RoI sampling itself happens on the device
    (train/rcnn_train.py)."""

    def __init__(self, cfg: Config, mask_on: bool = None, mask_stride: int = 4,
                 max_gt: int = 50, device_normalize: bool = False):
        from .minibatch import canvas_shapes

        if not cfg.MODEL.FASTER_RCNN and cfg.MODEL.TYPE == "generalized_rcnn":
            raise NotImplementedError(
                "MODEL.FASTER_RCNN False: training from precomputed proposals is not "
                "ported to sad_tpu_torch yet (ROADMAP.md Queue 1 item 8)")
        self.cfg = cfg
        self.landscape, self.portrait = canvas_shapes(cfg)
        self.mask_on = cfg.MODEL.MASK_ON if mask_on is None else mask_on
        self.kps_on = cfg.MODEL.KEYPOINTS_ON
        self.mask_stride = mask_stride
        self.max_gt = max_gt
        self.device_normalize = device_normalize

    def canvas_for(self, entry: dict) -> Tuple[int, int]:
        return self.landscape if entry["width"] >= entry["height"] else self.portrait

    def build(self, entries: List[dict], seed: int = 0,
              images_bgr: Optional[List[np.ndarray]] = None,
              rows: Optional[Tuple[int, int]] = None) -> Dict:
        """``rows`` = (start, stop): build only those images of the batch (a
        rank's share), as the whole batch's build would make them: the
        scale draws are the whole batch's, and the RPN label sampling's
        generator first replays the draws of the images before ``start``."""
        from ..utils.segms import polys_to_mask, rle_to_mask
        from .minibatch import (
            compute_im_scale, load_image_bgr, prep_image, resize_bgr_u8,
        )

        cfg = self.cfg
        canvas = self.canvas_for(entries[0])
        ch, cw = canvas
        # per-image random scale index (ref: roi_data/minibatch.py:48-53)
        scale_rng = np.random.RandomState(seed ^ 0x5BD1E995)
        scale_inds = scale_rng.randint(0, len(cfg.TRAIN.SCALES), size=len(entries))
        replay = []
        if rows is not None:
            replay = [(e, np.float32(compute_im_scale(e["height"], e["width"],
                                                      cfg.TRAIN.SCALES[si], cfg.TRAIN.MAX_SIZE)))
                      for e, si in zip(entries[:rows[0]], scale_inds[:rows[0]])]
            entries, scale_inds = entries[rows[0]:rows[1]], scale_inds[rows[0]:rows[1]]
            if images_bgr is not None:
                images_bgr = images_bgr[rows[0]:rows[1]]
        n = len(entries)
        batch: Dict = {"im_hw": np.zeros((n, 2), np.float32)}
        if self.device_normalize:
            batch["data_u8"] = np.zeros((n, ch, cw, 3), np.uint8)
        else:
            batch["data"] = np.zeros((n, ch, cw, 3), np.float32)
        scales = np.zeros((n,), np.float32)
        for i, e in enumerate(entries):
            im_bgr = (images_bgr[i] if images_bgr is not None
                      else load_image_bgr(e["image"], e.get("flipped", False)))
            scale = compute_im_scale(
                e["height"], e["width"],
                cfg.TRAIN.SCALES[scale_inds[i]], cfg.TRAIN.MAX_SIZE,
            )
            if self.device_normalize:
                im = resize_bgr_u8(im_bgr, scale)
                key = "data_u8"
            else:
                im = prep_image(
                    im_bgr, scale, cfg.PIXEL_MEANS, cfg.PIXEL_DIV, cfg.PIXEL_STD
                )
                key = "data"
            h, w = im.shape[:2]
            batch[key][i, :h, :w] = im
            batch["im_hw"][i] = (h, w)  # scaled content extent (for clipping)
            scales[i] = scale
        if self.device_normalize:
            batch["content_hw"] = batch["im_hw"].copy()
        add_rpn_blobs_to_batch(cfg, batch, entries, canvas, scales, seed=seed, replay=replay)
        # repad gt arrays to a fixed max (stable shapes across batches)
        g = batch["gt_boxes"].shape[1]
        if g < self.max_gt:
            pad = self.max_gt - g
            batch["gt_boxes"] = np.pad(batch["gt_boxes"], ((0, 0), (0, pad), (0, 0)))
            batch["gt_classes"] = np.pad(batch["gt_classes"], ((0, 0), (0, pad)))
        else:
            batch["gt_boxes"] = batch["gt_boxes"][:, : self.max_gt]
            batch["gt_classes"] = batch["gt_classes"][:, : self.max_gt]

        if self.mask_on:
            from PIL import Image as _Image

            s = self.mask_stride
            hm, wm = ch // s, cw // s
            rasters = np.zeros((n, self.max_gt, hm, wm), np.float32)
            for i, e in enumerate(entries):
                keep = np.where((e["gt_classes"] > 0) & (~e["is_crowd"]))[0]
                for j, gi in enumerate(keep[: self.max_gt]):
                    seg = (e.get("segms") or [[]] * (gi + 1))[gi]
                    if isinstance(seg, dict):
                        # RLE instance: decode full-res, nearest-sample onto
                        # the stride grid
                        m = rle_to_mask(seg)
                        sh = min(hm, int(round(m.shape[0] * scales[i] / s)))
                        sw = min(wm, int(round(m.shape[1] * scales[i] / s)))
                        if sh > 0 and sw > 0:
                            rasters[i, j, :sh, :sw] = (
                                np.asarray(
                                    _Image.fromarray(m * 255).resize(
                                        (sw, sh), _Image.NEAREST
                                    )
                                )
                                > 0
                            )
                        continue
                    if not seg:
                        continue
                    scaled = [
                        (np.asarray(p, np.float64) * scales[i] / s).tolist()
                        for p in seg
                    ]
                    rasters[i, j] = polys_to_mask(scaled, hm, wm)
            batch["gt_mask_rasters"] = rasters
            batch["gt_mask_stride"] = float(s)
        if self.kps_on:
            nk = self.cfg.KRCNN.NUM_KEYPOINTS
            kps = np.zeros((n, self.max_gt, nk, 3), np.float32)
            for i, e in enumerate(entries):
                gk = e.get("gt_keypoints")
                if gk is None or not len(gk):
                    continue
                keep = np.where((e["gt_classes"] > 0) & (~e["is_crowd"]))[0]
                for j, gi in enumerate(keep[: self.max_gt]):
                    if gi < len(gk):
                        k = gk[gi][:nk].copy()
                        k[:, :2] *= scales[i]
                        kps[i, j, : len(k)] = k
            batch["gt_keypoints"] = kps
        return batch


def add_rpn_blobs_to_batch(
    cfg: Config,
    batch: Dict,
    entries: List[dict],
    canvas: Tuple[int, int],
    im_scales: np.ndarray,
    seed: int = 0,
    replay: Sequence[Tuple[dict, float]] = (),
) -> None:
    """Fill batch['rpn_labels'/'rpn_bbox_targets'/'rpn_bbox_inside_weights'/
    'rpn_bbox_outside_weights'] per FPN level, plus padded gt arrays for the
    on-device proposal-label sampling. ``replay``: the (entry, scale) of the
    batch's images before ``entries``, whose label sampling advances the
    generator first and is thrown away."""
    ch, cw = canvas
    n = len(entries)
    rng = np.random.RandomState(seed)
    grid = rpn_anchor_grid(cfg, ch, cw)
    for e, scale in replay:
        keep = (e["gt_classes"] > 0) & (~e["is_crowd"])
        assign_rpn_labels(cfg, grid, e["boxes"][keep] * scale, ch, cw, rng)
    levels = grid.levels
    A = grid.num_anchors
    batch["rpn_labels"] = {
        lvl: np.zeros((n, fh, fw, A), np.int32)
        for lvl, (fh, fw) in zip(levels, grid.field_hw)
    }
    for key in ("rpn_bbox_targets", "rpn_bbox_inside_weights", "rpn_bbox_outside_weights"):
        batch[key] = {
            lvl: np.zeros((n, fh, fw, A, 4), np.float32)
            for lvl, (fh, fw) in zip(levels, grid.field_hw)
        }
    g_max = max(max((len(e["boxes"]) for e in entries), default=1), 1)
    batch["gt_boxes"] = np.zeros((n, g_max, 4), np.float32)
    batch["gt_classes"] = np.zeros((n, g_max), np.int32)

    for i, e in enumerate(entries):
        keep = (e["gt_classes"] > 0) & (~e["is_crowd"])
        gt = e["boxes"][keep] * im_scales[i]
        cls = e["gt_classes"][keep]
        lv = assign_rpn_labels(cfg, grid, gt, ch, cw, rng)
        for j, lvl in enumerate(levels):
            batch["rpn_labels"][lvl][i] = lv[0][j]
            batch["rpn_bbox_targets"][lvl][i] = lv[1][j]
            batch["rpn_bbox_inside_weights"][lvl][i] = lv[2][j]
            batch["rpn_bbox_outside_weights"][lvl][i] = lv[3][j]
        batch["gt_boxes"][i, : len(gt)] = gt
        batch["gt_classes"][i, : len(cls)] = cls
