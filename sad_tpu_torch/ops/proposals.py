"""RPN proposal ops with static shapes, on the device (ref:
sad_tpu/ops/proposals.py; detectron/lib/ops/generate_proposals.py and
collect_and_distribute_fpn_rpn_proposals.py).

Every step has a fixed shape: top-k, masked greedy NMS, a global top-k over
the levels. Invalid slots are carried as masks and NEG_INF scores. Boxes use
the legacy +1 pixel extents. No step reads a value back to the host.

``torch.topk`` takes the place of sad_tpu's ``ops/topk.top_k``; there is no
approximate path, so RPN.EXACT_TOPK loads and is ignored. Which index a tie
at the k-th score reports may differ between the two: compare through
``valid`` and score multisets.

``sample_proposal_labels`` (training) is batched over images where sad_tpu
maps one image under ``vmap``. Its random priorities come from a
``torch.Generator`` or are handed over as two (B, P + G) tensors: JAX's
numbers cannot be drawn here, so a comparison hands JAX's own over.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .box_transforms import bbox_overlaps, bbox_transform, bbox_transform_inv, clip_boxes
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


def stack_level_problems(prop_levels):
    """The (level x image) NMS problems of ``prop_levels`` stacked level-major
    and padded to the longest level: boxes (L*B, k, 4), scores (L*B, k) and
    the masked scores the NMS ranks (NEG_INF where a candidate is padding or
    was masked)."""
    kmax = max(bx.shape[1] for _, bx, _, _ in prop_levels)

    def padk(x, fill):
        pad = kmax - x.shape[1]
        if pad == 0:
            return x
        return torch.cat([x, x.new_full((x.shape[0], pad) + x.shape[2:], fill)], dim=1)

    return (torch.cat([padk(bx, 0.0) for _, bx, _, _ in prop_levels]),
            torch.cat([padk(ts, 0.0) for _, _, ts, _ in prop_levels]),
            torch.cat([padk(ms, NEG_INF) for _, _, _, ms in prop_levels]))


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
    all_boxes, all_top, all_masked = stack_level_problems(prop_levels)
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


def sampled_fg_cap(batch_size_per_im: int, fg_fraction: float) -> int:
    """How many leading slots of ``sample_proposal_labels``' output can hold
    fg rois: kept fg rois sort first (priority 2 + u > bg 1 + u > demoted fg
    0.5) and are capped at this count, so the first ``sampled_fg_cap(...)``
    slots of an image hold every fg roi. The mask branch slices exactly this
    prefix."""
    return int(round(fg_fraction * batch_size_per_im))


def sample_proposal_labels(
    proposals: torch.Tensor,  # (B, P, 4) from the RPN
    proposal_valid: torch.Tensor,  # (B, P)
    gt_boxes: torch.Tensor,  # (B, G, 4) padded with zeros
    gt_classes: torch.Tensor,  # (B, G) 0 = padding
    batch_size_per_im: int,
    fg_fraction: float,
    fg_thresh: float,
    bg_thresh_hi: float,
    bg_thresh_lo: float,
    num_classes: int,
    bbox_reg_weights=(10.0, 10.0, 5.0, 5.0),
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """Sample fg/bg rois of every image and build the Fast R-CNN targets
    (ref: sad_tpu/ops/proposals.py sample_proposal_labels;
    lib/roi_data/fast_rcnn.py _sample_rois), with static shapes:

    - the gt boxes are appended to the proposals (Detectron trains on their
      union);
    - fg: IoU >= fg_thresh; bg: IoU in [lo, hi); a fixed batch_size_per_im
      slots an image are filled by random priority, fg first and capped at
      ``sampled_fg_cap``, then bg; what is left over is a pad slot (label -1,
      zero weights, ``valid`` false);
    - ``uniforms`` = (u_fg, u_bg), each (B, P + G) in [0, 1), are the
      priorities' random parts; without them they are drawn from
      ``generator`` on the proposals' device.

    Every sort is stable, as ``jnp.argsort`` is: ties at priority 0 and 0.5
    are common. Which boxes the pad slots hold is of no consequence.
    Returns rois (B, S, 4), matched_gt (B, S), labels (B, S), bbox_targets,
    bbox_inside_weights, bbox_outside_weights (B, S, 4 * num_classes), valid
    and is_fg (B, S), S = batch_size_per_im."""
    all_boxes = torch.cat([proposals.float(), gt_boxes.float()], dim=1)
    all_valid = torch.cat([proposal_valid.bool(), gt_classes > 0], dim=1)
    b, p = all_valid.shape
    s = int(batch_size_per_im)
    if p < s:
        raise ValueError(f"sample_proposal_labels: {p} candidates an image cannot fill "
                         f"{s} slots")
    dev = all_boxes.device

    iou = bbox_overlaps(all_boxes, gt_boxes)  # (B, P+G, G)
    iou = torch.where((gt_classes > 0)[:, None, :], iou, -1.0)
    max_iou, argmax_gt = iou.max(dim=2)

    is_fg = (max_iou >= fg_thresh) & all_valid
    is_bg = (max_iou < bg_thresh_hi) & (max_iou >= bg_thresh_lo) & all_valid

    fg_cap = sampled_fg_cap(s, fg_fraction)
    if uniforms is None:
        u_fg = torch.rand((b, p), generator=generator, device=dev)
        u_bg = torch.rand((b, p), generator=generator, device=dev)
    else:
        u_fg, u_bg = (u.to(dev, torch.float32) for u in uniforms)
    pri = torch.where(is_fg, 2.0 + u_fg, 0.0)
    pri = torch.where(is_bg, 1.0 + u_bg, pri)
    # cap the fg count: the extra fg of lowest priority fall to just under the
    # bg range, so that bg fills the rest
    inf = torch.full_like(pri, float("inf"))
    fg_rank = torch.argsort(
        torch.argsort(torch.where(is_fg, -pri, inf), dim=1, stable=True), dim=1, stable=True)
    pri = torch.where(is_fg & (fg_rank >= fg_cap), 0.5, pri)

    sel = torch.argsort(-pri, dim=1, stable=True)[:, :s]
    sel_valid = torch.gather(pri, 1, sel) > 0.5  # demoted fg and invalid dropped
    sel_boxes = torch.gather(all_boxes, 1, sel[..., None].expand(b, s, 4))
    sel_gt = torch.gather(argmax_gt, 1, sel)
    sel_fg = torch.gather(is_fg, 1, sel) & (torch.gather(fg_rank, 1, sel) < fg_cap)
    gt_cls = torch.gather(gt_classes, 1, sel_gt)
    labels = torch.where(sel_fg & sel_valid, gt_cls, torch.zeros_like(gt_cls))

    matched = torch.gather(gt_boxes.float(), 1, sel_gt[..., None].expand(b, s, 4))
    targets = bbox_transform_inv(sel_boxes, matched, bbox_reg_weights)
    # class-specific 4C layout with inside / outside weights
    # (roi_data/fast_rcnn.py _expand_bbox_targets)
    one_hot = F.one_hot(labels.long().clamp_min(0), num_classes).float()
    w = (one_hot * sel_fg[..., None].float())[..., None]  # (B, S, C, 1)
    dense_targets = (w * targets[:, :, None, :]).reshape(b, s, 4 * num_classes)
    weights = w.expand(b, s, num_classes, 4).reshape(b, s, 4 * num_classes)
    return {
        "rois": sel_boxes,
        "matched_gt": sel_gt,
        "labels": torch.where(sel_valid, labels, torch.full_like(labels, -1)),
        "bbox_targets": dense_targets,
        "bbox_inside_weights": weights,
        "bbox_outside_weights": weights,
        "valid": sel_valid,
        "is_fg": sel_fg,
    }
