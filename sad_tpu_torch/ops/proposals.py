"""RPN proposal ops with static shapes, on the device (ref:
sad_tpu/ops/proposals.py; detectron/lib/ops/generate_proposals.py and
collect_and_distribute_fpn_rpn_proposals.py).

Every step has a fixed shape: top-k, masked greedy NMS, a global top-k over
the levels. Invalid slots are carried as masks and NEG_INF scores. Boxes use
the legacy +1 pixel extents. No step reads a value back to the host.

``torch.topk`` takes the place of sad_tpu's ``ops/topk.top_k``; there is no
approximate path, so RPN.EXACT_TOPK loads and is ignored. Which index a tie
at the k-th score reports may differ between the two: compare through
``valid`` and score multisets. ``sample_proposal_labels`` (training) is not
ported yet (ROADMAP.md Queue 1).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from .box_transforms import bbox_transform, clip_boxes
from .nms import NEG_INF, nms_multi
from .roi_align import multilevel_roi_align  # noqa: F401  (sad_tpu keeps it here)


def proposal_candidates(
    scores: torch.Tensor,  # (..., H, W, A) objectness (post-sigmoid)
    deltas: torch.Tensor,  # (..., H, W, A, 4)
    anchors: torch.Tensor,  # (H, W, A, 4)
    im_hw: torch.Tensor,  # (..., 2) image extent for clipping
    pre_nms_top_n: int,
    min_size: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Everything before the proposal NMS (generate_proposals.py top-k,
    decode, clip, small-box filter), for one image or, with leading batch
    dimensions, for each image. Returns (boxes (..., k, 4), top_scores
    (..., k), masked_scores (..., k) with NEG_INF on filtered candidates)."""
    lead = scores.shape[:-3]
    flat = scores.reshape(*lead, -1)
    k = min(pre_nms_top_n, flat.shape[-1])
    top_scores, inds = torch.topk(flat, k, dim=-1)
    top_anchors = anchors.reshape(-1, 4)[inds]
    top_deltas = torch.gather(deltas.reshape(*lead, -1, 4), -2,
                              inds[..., None].expand(*lead, k, 4))
    boxes = bbox_transform(top_anchors, top_deltas)
    boxes = clip_boxes(boxes, im_hw[..., 0:1], im_hw[..., 1:2])
    # filter_boxes (generate_proposals.py:171-183); min_size is in the
    # network frame, as in sad_tpu
    ws = boxes[..., 2] - boxes[..., 0] + 1.0
    hs = boxes[..., 3] - boxes[..., 1] + 1.0
    keep = (ws > min_size) & (hs > min_size)
    return boxes, top_scores, torch.where(keep, top_scores, NEG_INF)


def generate_proposals(
    scores: torch.Tensor,  # (H, W, A)
    deltas: torch.Tensor,  # (H, W, A, 4)
    anchors: torch.Tensor,  # (H, W, A, 4)
    im_hw: torch.Tensor,  # (2,)
    pre_nms_top_n: int,
    post_nms_top_n: int,
    nms_thresh: float,
    min_size: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One level, one image (generate_proposals.py:56-183). Returns (boxes
    (post_n, 4), scores (post_n,), valid (post_n,))."""
    boxes, top_scores, masked = proposal_candidates(
        scores, deltas, anchors, im_hw, pre_nms_top_n, min_size)
    idx, valid = nms_multi(boxes[None], masked[None], nms_thresh, post_nms_top_n)
    idx, valid = idx[0].long(), valid[0]
    return boxes[idx], torch.where(valid, top_scores[idx], 0.0), valid


def nms_levels_batched(
    prop_levels: Sequence[Tuple[int, torch.Tensor, torch.Tensor, torch.Tensor]],
    nms_thresh: float,
    post_nms_top_n: int,
) -> Tuple[Dict[int, torch.Tensor], Dict[int, torch.Tensor], Dict[int, torch.Tensor]]:
    """Greedy NMS of every (level x image) problem in ONE call.
    ``prop_levels`` is [(level, boxes (B,k,4), top_scores (B,k), masked
    (B,k))]; k may differ per level, and shorter levels are padded with
    NEG_INF candidates that can be neither picked nor suppress anything.
    Returns ({lvl: boxes (B, post_n, 4)}, {lvl: scores}, {lvl: valid})."""
    b = prop_levels[0][1].shape[0]
    kmax = max(bx.shape[1] for _, bx, _, _ in prop_levels)

    def padk(x, fill):
        pad = kmax - x.shape[1]
        if pad == 0:
            return x
        return torch.cat([x, x.new_full((x.shape[0], pad) + x.shape[2:], fill)], dim=1)

    all_boxes = torch.cat([padk(bx, 0.0) for _, bx, _, _ in prop_levels])
    all_top = torch.cat([padk(ts, 0.0) for _, _, ts, _ in prop_levels])
    all_masked = torch.cat([padk(ms, NEG_INF) for _, _, _, ms in prop_levels])
    keep_idx, keep_valid = nms_multi(all_boxes, all_masked, nms_thresh, post_nms_top_n)
    keep = keep_idx.long()
    kept_boxes = torch.gather(all_boxes, 1, keep[..., None].expand(-1, -1, 4))
    kept_scores = torch.where(keep_valid, torch.gather(all_top, 1, keep), 0.0)
    lv_b, lv_s, lv_v = {}, {}, {}
    for j, (lvl, *_rest) in enumerate(prop_levels):
        rows = slice(j * b, (j + 1) * b)
        lv_b[lvl], lv_s[lvl], lv_v[lvl] = kept_boxes[rows], kept_scores[rows], keep_valid[rows]
    return lv_b, lv_s, lv_v


def map_rois_to_fpn_levels(
    boxes: torch.Tensor,  # (..., 4)
    k_min: int,
    k_max: int,
    canonical_scale: int = 224,
    canonical_level: int = 4,
) -> torch.Tensor:
    """FPN paper eqn 1 (lib/modeling/FPN.py map_rois_to_fpn_levels): target
    level k = floor(k0 + log2(sqrt(area) / s0)), clipped; int32."""
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    s = torch.sqrt(torch.clamp(w * h, min=1e-6))
    k = torch.floor(canonical_level + torch.log2(s / canonical_scale + 1e-8))
    return torch.clamp(k, k_min, k_max).to(torch.int32)


def collect_and_distribute_fpn_proposals(
    level_boxes: Dict[int, torch.Tensor],  # per RPN level (..., post_n, 4)
    level_scores: Dict[int, torch.Tensor],
    level_valid: Dict[int, torch.Tensor],
    post_nms_top_n: int,
    roi_min_level: int,
    roi_max_level: int,
    canonical_scale: int = 224,
    canonical_level: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Union the per-level proposals, keep the global top-k by score, and
    compute each roi's RoI-pooling level
    (collect_and_distribute_fpn_rpn_proposals.py), for one image or, with a
    leading batch dimension, for each image. Returns (boxes (..., K, 4),
    scores (..., K), valid (..., K), roi_levels (..., K))."""
    lvls: List[int] = sorted(level_boxes)
    boxes = torch.cat([level_boxes[l] for l in lvls], dim=-2)
    scores = torch.cat([level_scores[l] for l in lvls], dim=-1)
    valid = torch.cat([level_valid[l] for l in lvls], dim=-1)
    masked = torch.where(valid, scores, NEG_INF)
    k = min(post_nms_top_n, masked.shape[-1])
    top_scores, inds = torch.topk(masked, k, dim=-1)
    out_boxes = torch.gather(boxes, -2, inds[..., None].expand(*inds.shape, 4))
    out_valid = top_scores > NEG_INF
    levels = map_rois_to_fpn_levels(out_boxes, roi_min_level, roi_max_level,
                                    canonical_scale, canonical_level)
    return out_boxes, torch.where(out_valid, top_scores, 0.0), out_valid, levels
