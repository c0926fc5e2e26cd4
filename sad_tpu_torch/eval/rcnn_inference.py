"""Faster / Mask / Keypoint R-CNN inference decode, batched and on the device (ref:
sad_tpu/eval/rcnn_inference.py; detectron/lib/core/test.py im_detect_bbox +
box_results_with_nms_and_limit, test.py:52-193).

Softmax class scores, per-class delta decode with MODEL.BBOX_REG_WEIGHTS,
score threshold, class-wise greedy NMS (one call for the whole batch), top
DETECTIONS_PER_IM; with MODEL.MASK_ON the mask head and with
MODEL.KEYPOINTS_ON the keypoint head then run on the kept boxes (the
reference's cascaded inference). Every shape is static and no step reads a
value back to the host; the keypoint heatmaps are decoded on the host
(eval/test_engine.py, utils/keypoints.heatmaps_to_keypoints).

Not ported yet (ROADMAP.md Queue 1): precomputed proposals
(MODEL.FASTER_RCNN False), the single-scale (C4) cascaded mask branch, and
``make_aux_on_boxes_fn`` (the heads on fixed boxes that test-time
augmentation re-runs). They raise NotImplementedError.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ..models.rcnn import flat_rois
from ..ops.box_transforms import bbox_transform, clip_boxes
from ..ops.nms import NEG_INF, batched_nms_multi
from ..ops.proposals import map_rois_to_fpn_levels, multilevel_roi_align
from .inference import device_normalize, gather_detections


def decode_rcnn_candidates(cfg, rois, roi_valid, cls_prob, bbox_pred, im_hw, im_scale):
    """The class-wise NMS candidates of a batch, one per (roi, foreground
    class): boxes (B, R*fg, 4) in original-image coords and clipped to it,
    scores (B, R*fg), classes (B, R*fg) 0-based, valid (B, R*fg); cut to the
    TEST.NMS_CAND_TOPK best valid ones when that is set."""
    b, r, num_classes = cls_prob.shape
    fg = num_classes - 1
    if cfg.MODEL.CLS_AGNOSTIC_BBOX_REG:
        deltas = bbox_pred[:, :, None, 4:8].expand(b, r, fg, 4)
    else:
        deltas = bbox_pred.reshape(b, r, num_classes, 4)[:, :, 1:, :]
    boxes = rois[:, :, None, :].expand(b, r, fg, 4)
    if cfg.TEST.BBOX_REG:
        boxes = bbox_transform(boxes, deltas, cfg.MODEL.BBOX_REG_WEIGHTS)
    boxes = boxes.reshape(b, r * fg, 4) / im_scale.float()[:, None, None]
    im_hw = im_hw.float()
    boxes = clip_boxes(boxes, im_hw[:, 0:1], im_hw[:, 1:2])
    scores = cls_prob[:, :, 1:].reshape(b, r * fg)
    classes = torch.arange(fg, device=scores.device).expand(b, r, fg).reshape(b, r * fg)
    valid = roi_valid[:, :, None].expand(b, r, fg).reshape(b, r * fg) & (
        scores > cfg.TEST.SCORE_THRESH)
    cand_k = cfg.TEST.NMS_CAND_TOPK
    if cand_k and cand_k < boxes.shape[1]:
        # exact top-k cut before the NMS: invalid slots carry NEG_INF, so
        # whenever <= cand_k candidates clear SCORE_THRESH the kept set is
        # that of the full NMS
        _, sel = torch.topk(torch.where(valid, scores, NEG_INF), cand_k, dim=1)
        boxes = torch.gather(boxes, 1, sel[..., None].expand(b, cand_k, 4))
        scores, classes, valid = (torch.gather(t, 1, sel) for t in (scores, classes, valid))
    return boxes, scores, classes, valid


def decode_rcnn_detections(
    cfg,
    rois: torch.Tensor,  # (B, R, 4) in network-input coords
    roi_valid: torch.Tensor,  # (B, R)
    cls_prob: torch.Tensor,  # (B, R, C)
    bbox_pred: torch.Tensor,  # (B, R, 4C) or (B, R, 8) class-agnostic
    im_hw: torch.Tensor,  # (B, 2) original sizes
    im_scale: torch.Tensor,  # (B,)
) -> Dict[str, torch.Tensor]:
    """(B, DETECTIONS_PER_IM) 'boxes', 'scores', 'classes' (1-based), 'valid';
    slots that are not valid hold zeros."""
    cands = decode_rcnn_candidates(cfg, rois, roi_valid, cls_prob, bbox_pred, im_hw, im_scale)
    keep_idx, keep_valid = batched_nms_multi(*cands, cfg.TEST.NMS, cfg.TEST.DETECTIONS_PER_IM)
    return rcnn_gather_detections(cands, keep_idx, keep_valid)


def rcnn_gather_detections(cands, keep_idx, keep_valid) -> Dict[str, torch.Tensor]:
    """``gather_detections`` with the boxes of invalid slots zeroed too: an
    invalid slot would otherwise show whatever candidate index 0 holds
    (sad_tpu/eval/rcnn_inference.py:89-92)."""
    dets = gather_detections(cands, keep_idx, keep_valid)
    dets["boxes"] = torch.where(keep_valid[..., None], dets["boxes"], 0.0)
    return dets


def kept_box_rois(cfg, boxes, im_scale):
    """The kept (B, K, 4) detection boxes back in network-input coordinates,
    as (B*K, 5) image-major rois and their (B*K,) RoI levels."""
    net_boxes = boxes * im_scale.float()[:, None, None]
    lvls = map_rois_to_fpn_levels(
        net_boxes, cfg.FPN.ROI_MIN_LEVEL, cfg.FPN.ROI_MAX_LEVEL,
        cfg.FPN.ROI_CANONICAL_SCALE, cfg.FPN.ROI_CANONICAL_LEVEL)
    return flat_rois(net_boxes), lvls.reshape(-1)


def mask_roi_features(cfg, model, features, boxes, valid, im_scale) -> torch.Tensor:
    """RoIAlign of the kept (B, K, 4) detection boxes for the mask head, from
    the model's NHWC ``features``: (B*K, res, res, C)."""
    rois5, lvls = kept_box_rois(cfg, boxes, im_scale)
    return multilevel_roi_align(
        model.roi_features(features), rois5, lvls, valid.reshape(-1),
        cfg.MRCNN.ROI_XFORM_RESOLUTION, cfg.MRCNN.ROI_XFORM_SAMPLING_RATIO)


def keypoint_roi_features(cfg, model, features, boxes, valid, im_scale) -> torch.Tensor:
    """RoIAlign of the kept (B, K, 4) detection boxes for the keypoint head
    (KRCNN.ROI_XFORM_RESOLUTION): (B*K, res, res, C)."""
    rois5, lvls = kept_box_rois(cfg, boxes, im_scale)
    return multilevel_roi_align(
        model.roi_features(features), rois5, lvls, valid.reshape(-1),
        cfg.KRCNN.ROI_XFORM_RESOLUTION, cfg.KRCNN.ROI_XFORM_SAMPLING_RATIO)


def make_rcnn_inference_fn(cfg, model) -> Callable:
    """Faster R-CNN end to end: images -> detections, plus 'mask_prob' (B, K,
    m, m, C) on the kept boxes with MODEL.MASK_ON and 'kps_heatmaps' (B, K,
    S, S, NUM_KEYPOINTS) float32 logits with MODEL.KEYPOINTS_ON.

    fn(images (B,H,W,3), im_hw (B,2), im_scale (B,), content_hw=None) ->
    dict. All tensors on the model's device; uint8 canvases are normalised
    on the device (content_hw required then)."""
    if not cfg.MODEL.FASTER_RCNN:
        raise NotImplementedError(
            "MODEL.FASTER_RCNN False (Fast R-CNN on precomputed proposals) is not ported "
            "to sad_tpu_torch yet (ROADMAP.md Queue 1)")
    if not cfg.FPN.FPN_ON:
        raise NotImplementedError(
            "single-scale (C4) R-CNN inference, with its cascaded mask branch, is not "
            "ported to sad_tpu_torch yet (ROADMAP.md Queue 1)")

    @torch.inference_mode()
    def infer(images, im_hw, im_scale, content_hw=None):
        images = device_normalize(cfg, images, content_hw)
        out = model(images, im_hw)
        dets = decode_rcnn_detections(cfg, out["rois"], out["roi_valid"], out["cls_prob"],
                                      out["bbox_pred"], im_hw, im_scale)
        b, k = dets["boxes"].shape[:2]
        if cfg.MODEL.MASK_ON:
            logits = model.mask_heads(mask_roi_features(
                cfg, model, out["features"], dets["boxes"], dets["valid"], im_scale))
            dets["mask_prob"] = torch.sigmoid(logits).reshape((b, k) + logits.shape[1:])
        if cfg.MODEL.KEYPOINTS_ON:
            hm = model.keypoint_heads(keypoint_roi_features(
                cfg, model, out["features"], dets["boxes"], dets["valid"], im_scale))
            dets["kps_heatmaps"] = hm.reshape((b, k) + hm.shape[1:])
        return dets

    return infer


def make_aux_on_boxes_fn(cfg, model) -> Callable:
    """The mask / keypoint heads on fixed boxes (the passes that mask and
    keypoint test-time augmentation re-run): not ported yet."""
    raise NotImplementedError(
        "make_aux_on_boxes_fn (mask/keypoint heads on fixed boxes, for test-time "
        "augmentation) is not ported to sad_tpu_torch yet (ROADMAP.md Queue 1)")
