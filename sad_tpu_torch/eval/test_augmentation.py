"""Test-time box augmentation, box voting and soft-NMS post-processing (a
copy of sad_tpu/eval/test_augmentation.py; ref: detectron/lib/core/test.py
:195-753 (bbox TTA) and lib/utils/boxes.py:262-331 (box_voting, soft_nms
wiring)).

The card returns fixed-size candidate sets a transform; the host merges them
(UNION heuristics), then soft-NMSes or NMSes and box-votes them in numpy
through the port's g++ host kernels (``native.nms``, ``native.soft_nms``,
``native.bbox_overlaps``): they run on at most a few thousand rows an image,
host arithmetic as in the reference.

One difference of layout: the port gathers each detection's own class
channel of the masks on the card before the copy (test_engine.
gather_class_masks), so its mask stacks are (B, K, m, m), width last, and
``flip_mask_probs`` un-flips that layout. The three mask heuristics are
elementwise, so gathering first gives the numbers combining the whole stack
would.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..native import bbox_overlaps, nms as native_nms, soft_nms as native_soft_nms

_ASPECT_RATIOS_REFUSED = (
    "aspect-ratio TTA is not supported on static canvases (sad_tpu refuses it too, "
    "sad_tpu/eval/test_augmentation.py:191-194; ROADMAP.md Queue 3)")


def box_voting(
    top_dets: np.ndarray,  # (N, 5) [x1 y1 x2 y2 score] NMS survivors
    all_dets: np.ndarray,  # (M, 5) pre-NMS candidates
    thresh: float,
    scoring_method: str = "ID",
    beta: float = 1.0,
) -> np.ndarray:
    """Refine boxes by score-weighted voting of overlapping candidates
    (ref: boxes.py:262-311, arXiv:1505.01749)."""
    out = top_dets.copy()
    overlaps = bbox_overlaps(top_dets[:, :4], all_dets[:, :4])
    for k in range(len(out)):
        inds = np.where(overlaps[k] >= thresh)[0]
        if len(inds) == 0:
            continue
        boxes = all_dets[inds, :4]
        ws = all_dets[inds, 4]
        if ws.sum() <= 0:
            continue
        out[k, :4] = np.average(boxes, axis=0, weights=ws)
        if scoring_method == "ID":
            pass
        elif scoring_method == "TEMP_AVG":
            p = np.vstack((ws, 1.0 - ws))
            p_max = np.max(p, axis=0)
            x = np.log(np.maximum(p / p_max, 1e-12))
            x_exp = np.exp(x / beta)
            p_temp = x_exp / np.sum(x_exp, axis=0)
            out[k, 4] = p_temp[0].mean()
        elif scoring_method == "AVG":
            out[k, 4] = ws.mean()
        elif scoring_method == "IOU_AVG":
            out[k, 4] = np.average(ws, weights=overlaps[k, inds])
        elif scoring_method == "GENERALIZED_AVG":
            out[k, 4] = np.mean(ws ** beta) ** (1.0 / beta)
        elif scoring_method == "QUASI_SUM":
            out[k, 4] = ws.sum() / float(len(ws)) ** beta
        else:
            raise NotImplementedError(f"Unknown scoring method {scoring_method}")
    return out


def postprocess_detections(
    cfg,
    boxes: np.ndarray,  # (K, 4)
    scores: np.ndarray,  # (K,)
    classes: np.ndarray,  # (K,) 1-based
    valid: np.ndarray,  # (K,)
    num_classes: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host per-class soft-NMS (TEST.SOFT_NMS) or greedy NMS, then box
    voting (TEST.BBOX_VOTE), over merged candidate sets (ref: test.py
    box_results_with_nms_and_limit); the top TEST.DETECTIONS_PER_IM by
    score. Returns (boxes, scores, classes) of the surviving detections."""
    out_b, out_s, out_c = [], [], []
    for cls in range(1, num_classes):
        m = valid & (classes == cls)
        if not m.any():
            continue
        dets = np.concatenate([boxes[m], scores[m][:, None]], axis=1).astype(np.float32)
        if cfg.TEST.SOFT_NMS.ENABLED:
            kept_dets, keep = native_soft_nms(
                dets, sigma=cfg.TEST.SOFT_NMS.SIGMA, overlap_thresh=cfg.TEST.NMS,
                score_thresh=0.0001, method=cfg.TEST.SOFT_NMS.METHOD)
        else:
            keep = native_nms(dets, cfg.TEST.NMS)
            kept_dets = dets[keep]
        if cfg.TEST.BBOX_VOTE.ENABLED and len(kept_dets):
            kept_dets = box_voting(
                kept_dets, dets, cfg.TEST.BBOX_VOTE.VOTE_TH,
                cfg.TEST.BBOX_VOTE.SCORING_METHOD, cfg.TEST.BBOX_VOTE.SCORING_METHOD_BETA)
        out_b.append(kept_dets[:, :4])
        out_s.append(kept_dets[:, 4])
        out_c.append(np.full(len(kept_dets), cls, np.int32))
    if not out_b:
        return (np.zeros((0, 4), np.float32), np.zeros((0,), np.float32),
                np.zeros((0,), np.int32))
    b = np.concatenate(out_b)
    s = np.concatenate(out_s)
    c = np.concatenate(out_c)
    # the global DETECTIONS_PER_IM cap by score (test.py image_thresh)
    if len(s) > cfg.TEST.DETECTIONS_PER_IM:
        order = np.argsort(-s)[: cfg.TEST.DETECTIONS_PER_IM]
        b, s, c = b[order], s[order], c[order]
    return b, s, c


def bbox_aug_transforms(cfg) -> List[Dict]:
    """The augmentation set (ref: test.py im_detect_bbox_aug): the base
    pass, an optional h-flip, the extra scales (each optionally h-flipped),
    the aspect ratios (optionally h-flipped)."""
    aug = cfg.TEST.BBOX_AUG
    transforms = [{"scale": cfg.TEST.SCALES[0], "max_size": cfg.TEST.MAX_SIZE,
                   "hflip": False, "aspect_ratio": 1.0}]
    if aug.H_FLIP:
        transforms.append({"scale": cfg.TEST.SCALES[0], "max_size": cfg.TEST.MAX_SIZE,
                           "hflip": True, "aspect_ratio": 1.0})
    for s in aug.SCALES:
        transforms.append({"scale": s, "max_size": aug.MAX_SIZE, "hflip": False,
                           "aspect_ratio": 1.0})
        if aug.SCALE_H_FLIP:
            transforms.append({"scale": s, "max_size": aug.MAX_SIZE, "hflip": True,
                               "aspect_ratio": 1.0})
    for ar in aug.ASPECT_RATIOS:
        transforms.append({"scale": cfg.TEST.SCALES[0], "max_size": cfg.TEST.MAX_SIZE,
                           "hflip": False, "aspect_ratio": ar})
        if aug.ASPECT_RATIO_H_FLIP:
            transforms.append({"scale": cfg.TEST.SCALES[0], "max_size": cfg.TEST.MAX_SIZE,
                               "hflip": True, "aspect_ratio": ar})
    return transforms


def merge_aug_detections(
    per_aug: List[Dict[str, np.ndarray]],
    im_w: float,
    flipped_flags: List[bool],
) -> Dict[str, np.ndarray]:
    """UNION merge of the candidates of every transform (SCORE_HEUR /
    COORD_HEUR 'UNION', test.py:246-276): flipped boxes un-flipped, all
    concatenated."""
    boxes, scores, classes, valid = [], [], [], []
    for dets, flipped in zip(per_aug, flipped_flags):
        b = dets["boxes"].copy()
        if flipped:
            x1 = b[:, 0].copy()
            x2 = b[:, 2].copy()
            b[:, 0] = im_w - x2 - 1
            b[:, 2] = im_w - x1 - 1
        boxes.append(b)
        scores.append(dets["scores"])
        classes.append(dets["classes"])
        valid.append(dets["valid"])
    return {
        "boxes": np.concatenate(boxes),
        "scores": np.concatenate(scores),
        "classes": np.concatenate(classes),
        "valid": np.concatenate(valid),
    }


def aux_aug_transforms(aug, cfg) -> List[Dict]:
    """The mask / keypoint TTA transforms (ref: test.py im_detect_mask_aug
    :410-478, im_detect_keypoints_aug:582-665; the identity pass is the base
    inference and is not listed). Each is tagged ds / us (computed at a
    lower / higher scale than TEST.SCALES[0]) for size-dependent combining
    (test.py:616-623). Aspect-ratio transforms raise."""
    if aug.ASPECT_RATIOS:
        raise NotImplementedError(_ASPECT_RATIOS_REFUSED)
    base = cfg.TEST.SCALES[0]
    t: List[Dict] = []
    if aug.H_FLIP:
        t.append({"scale": base, "max_size": cfg.TEST.MAX_SIZE, "hflip": True,
                  "ds": False, "us": False})
    for s in aug.SCALES:
        tags = {"ds": s < base, "us": s > base}
        t.append({"scale": s, "max_size": aug.MAX_SIZE, "hflip": False, **tags})
        if aug.SCALE_H_FLIP:
            t.append({"scale": s, "max_size": aug.MAX_SIZE, "hflip": True, **tags})
    return t


def combine_soft_masks(stack: List[np.ndarray], heur: str) -> np.ndarray:
    """Per-transform soft masks combined (ref: test.py:461-478): SOFT_AVG /
    SOFT_MAX / LOGIT_AVG, elementwise."""
    a = np.stack(stack)
    if heur == "SOFT_AVG":
        return a.mean(axis=0)
    if heur == "SOFT_MAX":
        return a.max(axis=0)
    if heur == "LOGIT_AVG":
        logit = -np.log((1.0 - a) / np.maximum(a, 1e-20))
        return 1.0 / (1.0 + np.exp(-logit.mean(axis=0)))
    raise NotImplementedError(f"Heuristic {heur} not supported")


def combine_heatmaps(stack: List[np.ndarray], heur: str) -> np.ndarray:
    """Per-transform keypoint heatmaps combined (ref: test.py:644-651):
    HM_AVG / HM_MAX."""
    a = np.stack(stack)
    if heur == "HM_AVG":
        return a.mean(axis=0)
    if heur == "HM_MAX":
        return a.max(axis=0)
    raise NotImplementedError(f"Heuristic {heur} not supported")


def combine_heatmaps_size_dep(
    stack: List[np.ndarray],  # per-transform (B, R, S, S, K) heatmaps
    ds: List[bool],  # per-transform downscaled flags
    us: List[bool],  # per-transform upscaled flags
    boxes: np.ndarray,  # (B, R, 4) rois in image coords
    heur: str,
    area_th: float,
) -> np.ndarray:
    """Size-dependent heatmap combining (ref: test.py
    combine_heatmaps_size_dep:726-751): small and medium objects (area <
    KPS_AUG.AREA_TH) drop the downscaled passes, large ones the upscaled
    passes. Only two subsets exist, so each is combined once and selected a
    roi."""
    small = combine_heatmaps([h for h, d in zip(stack, ds) if not d], heur)
    large = combine_heatmaps([h for h, u in zip(stack, us) if not u], heur)
    areas = (boxes[..., 2] - boxes[..., 0] + 1) * (boxes[..., 3] - boxes[..., 1] + 1)
    sm = areas < area_th  # (B, R)
    return np.where(sm[..., None, None, None], small, large)


def flip_mask_probs(masks: np.ndarray) -> np.ndarray:
    """Un-flip h-flipped soft masks (ref: test.py:481-495) gathered to their
    class, (..., H, W) in the RoI frame as test_engine.gather_class_masks
    gives them: the width axis is the last (sad_tpu's (..., H, W, C) stack
    flips the second-to-last)."""
    return masks[..., ::-1]


def flip_heatmaps(heatmaps: np.ndarray) -> np.ndarray:
    """Un-flip h-flipped keypoint heatmaps (ref: keypoints.py flip_heatmaps):
    the width axis reversed and the left / right keypoint channels swapped.
    Layout (..., H, W, J)."""
    from ..utils.keypoints import flip_keypoint_channels

    idx = flip_keypoint_channels()
    return heatmaps[..., :, ::-1, :][..., idx]
