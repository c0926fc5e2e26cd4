"""Fast / Faster / Mask / Keypoint R-CNN inference decode, batched and on the device (ref:
sad_tpu/eval/rcnn_inference.py; detectron/lib/core/test.py im_detect_bbox +
box_results_with_nms_and_limit, test.py:52-193).

Softmax class scores, per-class delta decode with MODEL.BBOX_REG_WEIGHTS,
score threshold, class-wise greedy NMS (one call for the whole batch), top
DETECTIONS_PER_IM; with MODEL.MASK_ON the mask head and with
MODEL.KEYPOINTS_ON the keypoint head then run on the kept boxes (the
reference's cascaded inference). Every shape is static and no step reads a
value back to the host; the keypoint heatmaps are decoded on the host
(eval/test_engine.py, utils/keypoints.heatmaps_to_keypoints).

With MODEL.FASTER_RCNN False (Fast R-CNN on precomputed proposals, ref:
test.py im_detect_bbox's ``boxes`` input) the RPN is skipped: the box head
runs on the (B, P, 4) proposals handed in. ``make_aux_on_boxes_fn`` runs
the mask and keypoint heads on fixed boxes, the passes that mask and
keypoint test-time augmentation re-run (test.py:410-478, 582-665).

Single-scale models (models/single_scale.SingleScaleRCNN: C4, VGG, R-FCN;
sad_tpu/eval/rcnn_inference.py:190-207): the box path of the model's
forward; with MODEL.MASK_ON the cascaded mask branch re-runs RoIAlign at
MRCNN.ROI_XFORM_RESOLUTION and res5 (the box head's for v0upshare, its own
for v0up) on the kept boxes, every slot pooled as sad_tpu pools it. Fast
R-CNN runs ``box_forward`` on the proposals. KEYPOINTS_ON on a single-scale
model is refused (models/model_builder.check_single_scale; ROADMAP.md
Queue 3); so is R-FCN without MODEL.CLS_AGNOSTIC_BBOX_REG, whose (R, 8) box
outputs the class-specific decode cannot read.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ..models.model_builder import check_single_scale
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


def net_box_rois(cfg, net_boxes):
    """(B, K, 4) boxes in network-input coordinates as (B*K, 5) image-major
    rois and their (B*K,) RoI levels."""
    lvls = map_rois_to_fpn_levels(
        net_boxes, cfg.FPN.ROI_MIN_LEVEL, cfg.FPN.ROI_MAX_LEVEL,
        cfg.FPN.ROI_CANONICAL_SCALE, cfg.FPN.ROI_CANONICAL_LEVEL)
    return flat_rois(net_boxes), lvls.reshape(-1)


def kept_box_rois(cfg, boxes, im_scale):
    """The kept (B, K, 4) detection boxes back in network-input coordinates,
    as (B*K, 5) image-major rois and their (B*K,) RoI levels."""
    return net_box_rois(cfg, boxes * im_scale.float()[:, None, None])


def _aux_roi_features(cfg, model, features, rois5, lvls, valid, head):
    """RoIAlign for the mask head (``head`` 'mask', MRCNN's resolution) or
    the keypoint head ('kps', KRCNN's): (B*K, res, res, C)."""
    c = cfg.MRCNN if head == "mask" else cfg.KRCNN
    return multilevel_roi_align(model.roi_features(features), rois5, lvls, valid.reshape(-1),
                                c.ROI_XFORM_RESOLUTION, c.ROI_XFORM_SAMPLING_RATIO)


def mask_roi_features(cfg, model, features, boxes, valid, im_scale) -> torch.Tensor:
    """RoIAlign of the kept (B, K, 4) detection boxes for the mask head, from
    the model's NHWC ``features``: (B*K, res, res, C)."""
    return _aux_roi_features(cfg, model, features, *kept_box_rois(cfg, boxes, im_scale), valid,
                             "mask")


def keypoint_roi_features(cfg, model, features, boxes, valid, im_scale) -> torch.Tensor:
    """RoIAlign of the kept (B, K, 4) detection boxes for the keypoint head
    (KRCNN.ROI_XFORM_RESOLUTION): (B*K, res, res, C)."""
    return _aux_roi_features(cfg, model, features, *kept_box_rois(cfg, boxes, im_scale), valid,
                             "kps")


def _aux_heads(cfg, model, features, rois5, lvls, valid, b: int, k: int) -> Dict:
    """The mask head ('mask_prob' (B, K, m, m, C)) and the keypoint head
    ('kps_heatmaps' (B, K, S, S, J) float32 logits) that are on, over the
    (B*K, 5) rois; a single-scale model's cascaded mask branch pools every
    roi."""
    out = {}
    if cfg.MODEL.MASK_ON:
        if single_scale(cfg):
            logits = model.mask_heads(features, rois5)
        else:
            logits = model.mask_heads(
                _aux_roi_features(cfg, model, features, rois5, lvls, valid, "mask"))
        out["mask_prob"] = torch.sigmoid(logits).reshape((b, k) + logits.shape[1:])
    if cfg.MODEL.KEYPOINTS_ON:
        hm = model.keypoint_heads(
            _aux_roi_features(cfg, model, features, rois5, lvls, valid, "kps"))
        out["kps_heatmaps"] = hm.reshape((b, k) + hm.shape[1:])
    return out


def single_scale(cfg) -> bool:
    """A SingleScaleRCNN's config: no FPN, or R-FCN."""
    return not cfg.FPN.FPN_ON or cfg.MODEL.TYPE == "rfcn"


def _check_serving(cfg) -> None:
    """Refuse, before any work, what the single-scale serving path does not
    serve."""
    if not single_scale(cfg):
        return
    check_single_scale(cfg)
    if cfg.MODEL.TYPE == "rfcn" and not cfg.MODEL.CLS_AGNOSTIC_BBOX_REG:
        raise ValueError("R-FCN's box outputs are class-agnostic (R, 8): set "
                         "MODEL.CLS_AGNOSTIC_BBOX_REG True")


def fast_rcnn_outputs(cfg, model, images, proposals, prop_valid) -> Dict[str, torch.Tensor]:
    """Fast R-CNN's box head on precomputed (B, P, 4) proposals in
    network-input coordinates (sad_tpu/eval/rcnn_inference.py:127-178):
    backbone, RoI levels, RoIAlign, box head, softmax (a single-scale model:
    ``box_forward`` on every proposal); the dict of ``GeneralizedRCNN.forward``
    without the RPN's scores."""
    feats = model.backbone(images)
    b, r = proposals.shape[:2]
    if single_scale(cfg):
        lvls = torch.full((b, r), model.level, dtype=torch.int32, device=proposals.device)
        cls_score, bbox_pred = model.box_forward(feats, flat_rois(proposals))
    else:
        f = cfg.FPN
        lvls = map_rois_to_fpn_levels(proposals, f.ROI_MIN_LEVEL, f.ROI_MAX_LEVEL,
                                      f.ROI_CANONICAL_SCALE, f.ROI_CANONICAL_LEVEL)
        cls_score, bbox_pred = model.box_head(
            model.box_roi_features(feats, proposals, lvls, prop_valid))
    cls_score = cls_score.reshape(b, r, -1)
    return {"rois": proposals, "roi_valid": prop_valid, "roi_levels": lvls,
            "cls_score": cls_score, "cls_prob": torch.softmax(cls_score, dim=-1),
            "bbox_pred": bbox_pred.reshape(b, r, -1), "features": feats}


def make_rcnn_inference_fn(cfg, model, aux_heads: bool = True) -> Callable:
    """Faster R-CNN end to end: images -> detections, plus 'mask_prob' (B, K,
    m, m, C) on the kept boxes with MODEL.MASK_ON and 'kps_heatmaps' (B, K,
    S, S, NUM_KEYPOINTS) float32 logits with MODEL.KEYPOINTS_ON.

    fn(images (B,H,W,3), im_hw (B,2), im_scale (B,), content_hw=None,
    proposals=None, prop_valid=None) -> dict. All tensors on the model's
    device; uint8 canvases are normalised on the device (content_hw required
    then). With MODEL.FASTER_RCNN False (Fast R-CNN) ``proposals`` (B, P, 4)
    in network-input coordinates and ``prop_valid`` (B, P) are required and
    take the RPN's place. With ``aux_heads`` False the mask and keypoint
    heads do not run: the box passes of test-time augmentation, whose
    heads run on the merged boxes instead."""
    _check_serving(cfg)
    # sad_tpu serves Fast R-CNN for MODEL.TYPE generalized_rcnn only
    precomputed = not cfg.MODEL.FASTER_RCNN and cfg.MODEL.TYPE == "generalized_rcnn"

    @torch.inference_mode()
    def infer(images, im_hw, im_scale, content_hw=None, proposals=None, prop_valid=None):
        images = device_normalize(cfg, images, content_hw)
        if precomputed:
            if proposals is None or prop_valid is None:
                raise ValueError(
                    "MODEL.FASTER_RCNN=False (pure Fast R-CNN) needs precomputed proposals: "
                    "pass proposals/prop_valid (set TEST.PROPOSAL_FILES)")
            out = fast_rcnn_outputs(cfg, model, images, proposals, prop_valid)
        else:
            out = model(images, im_hw)
        dets = decode_rcnn_detections(cfg, out["rois"], out["roi_valid"], out["cls_prob"],
                                      out["bbox_pred"], im_hw, im_scale)
        if aux_heads:
            b, k = dets["boxes"].shape[:2]
            dets.update(_aux_heads(cfg, model, out["features"],
                                   *kept_box_rois(cfg, dets["boxes"], im_scale), dets["valid"],
                                   b, k))
        return dets

    return infer


def make_aux_on_boxes_fn(cfg, model) -> Callable:
    """The mask / keypoint heads on fixed boxes: the cascaded passes that
    mask and keypoint test-time augmentation re-run on transformed images
    (sad_tpu/eval/rcnn_inference.py:262-332; a single-scale model runs its
    cascaded mask branch on every slot).

    aux(images, net_boxes (B, K, 4) in network-input coordinates, valid
    (B, K), content_hw=None) -> {'mask_prob': (B, K, m, m, C),
    'kps_heatmaps': (B, K, S, S, J)}, each under its MODEL switch."""
    _check_serving(cfg)

    @torch.inference_mode()
    def aux(images, net_boxes, valid, content_hw=None):
        images = device_normalize(cfg, images, content_hw)
        b, k = net_boxes.shape[:2]
        return _aux_heads(cfg, model, model.backbone(images), *net_box_rois(cfg, net_boxes),
                          valid, b, k)

    return aux
