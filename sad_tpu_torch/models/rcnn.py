"""Faster/Mask R-CNN on an FPN backbone (ref: sad_tpu/models/rcnn.py;
detectron/lib/modeling/{rpn_heads, fast_rcnn_heads, mask_rcnn_heads}.py and
the generalized_rcnn builder, model_builder.py:74-92).

Proposals are made on the device with static shapes (ops/proposals.py) and
every RoI stage is a fixed-R batched tensor program. Module and parameter
names are those of the Flax tree (``rpn.conv_rpn_fpn2``, ``box_head.fc6``,
``mask_head._[mask]_fcn1``, ``mask_head.conv5_mask``), themselves the
reference's blob names, so sad_tpu_torch/convert.py maps a path by joining
with '.'.

Layouts: convolutions run NCHW inside; what the public methods take and
return is NHWC, as in sad_tpu: images (B, H, W, 3), feature maps
(B, H_l, W_l, C) (views of the NCHW maps, contiguous when those are
channels-last), roi features (R, res, res, C). The box head flattens the
(R, res, res, C) RoIAlign output as it is, (y, x, c) order, which is the
order of fc6's converted columns.

The keypoint head is not ported yet (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..data.anchors import field_of_anchors, rpn_cell_anchors
from ..ops.proposals import (
    collect_and_distribute_fpn_proposals, multilevel_roi_align, nms_levels_batched,
    proposal_candidates,
)
from .arch import arch_from_config
from .fpn import FPNRetinaNetBackbone
from .resnet import conv
from .retinanet import _nhwc_f32


@functools.lru_cache(maxsize=None)
def rpn_anchor_field_on(device: torch.device, level: int, min_level: int, start_size: float,
                        aspect_ratios: Tuple[float, ...], h: int, w: int) -> torch.Tensor:
    """(h, w, A, 4) float32 RPN anchors of one FPN level on ``device``,
    copied from the host once per process and level size: a pageable
    host-to-device copy in every forward would make the host wait for the
    backbone to finish."""
    cell = rpn_cell_anchors(level, min_level, start_size, aspect_ratios)
    field = field_of_anchors(cell, 2.0 ** level, h, w)
    with torch.inference_mode(False):
        return torch.as_tensor(field, dtype=torch.float32, device=device)


class Linear(nn.Linear):
    """nn.Linear in the dtype of its input: weight and bias are cast to it,
    as a Flax Dense with float32 params and a bf16 dtype casts its kernel."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d in the dtype of its input."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                                  self.stride, self.padding)


class RPNHead(nn.Module):
    """FPN RPN head: one 3x3 conv and the objectness / delta 1x1 convs, one
    set of weights for every level (rpn_heads.py add_fpn_rpn_outputs)."""

    def __init__(self, dim: int, num_anchors: int, k_min: int):
        super().__init__()
        self.names = (f"conv_rpn_fpn{k_min}", f"rpn_cls_logits_fpn{k_min}",
                      f"rpn_bbox_pred_fpn{k_min}")
        self.add_module(self.names[0], conv(dim, dim, 3, bias=True))
        self.add_module(self.names[1], conv(dim, num_anchors, 1, bias=True))
        self.add_module(self.names[2], conv(dim, 4 * num_anchors, 1, bias=True))

    def forward(self, features: Dict[int, torch.Tensor]):
        """{level: (B, C, H, W)} -> float32 NHWC logits {level: (B, H, W, A)}
        and deltas {level: (B, H, W, 4A)}."""
        shared, cls, bbox = (getattr(self, n) for n in self.names)
        logits, deltas = {}, {}
        for lvl, x in features.items():
            h = F.relu(shared(x))
            logits[lvl] = _nhwc_f32(cls(h))
            deltas[lvl] = _nhwc_f32(bbox(h))
        return logits, deltas


class FastRCNNBoxHead(nn.Module):
    """2-FC box head and the cls / bbox outputs (fast_rcnn_heads.py
    add_roi_2mlp_head + add_fast_rcnn_outputs)."""

    def __init__(self, dim_in: int, mlp_dim: int, num_classes: int,
                 cls_agnostic_bbox: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc6 = Linear(dim_in, mlp_dim)
        self.fc7 = Linear(mlp_dim, mlp_dim)
        self.cls_score = Linear(mlp_dim, num_classes)
        self.bbox_pred = Linear(mlp_dim, 8 if cls_agnostic_bbox else 4 * num_classes)

    def forward(self, roi_feats: torch.Tensor):  # (R, res, res, C)
        x = roi_feats.reshape(roi_feats.shape[0], -1).to(self.dtype)
        x = F.relu(self.fc6(x))
        x = F.relu(self.fc7(x))
        return self.cls_score(x).float(), self.bbox_pred(x).float()


class MaskHead(nn.Module):
    """Mask head family (mask_rcnn_heads.py): num_convs 3x3 convs (4 for
    v1up4convs, 2 for v1up2convs, 0 for v1up), a 2x deconv, then per-class
    1x1 logits; or, with use_fc_output, a dense layer that emits the mask
    grid (MRCNN.USE_FC_OUTPUT)."""

    def __init__(self, dim_in: int, dim: int, num_classes: int, cls_specific: bool = True,
                 num_convs: int = 4, use_fc_output: bool = False, resolution: int = 28,
                 roi_resolution: int = 14, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.convs = [f"_[mask]_fcn{i + 1}" for i in range(num_convs)]
        cin = dim_in
        for name in self.convs:
            self.add_module(name, conv(cin, dim, 3, bias=True))
            cin = dim
        self.out_dim = num_classes if cls_specific else 1
        self.use_fc_output = use_fc_output
        self.resolution = resolution
        if use_fc_output:
            self.mask_fcn_logits = Linear(cin * roi_resolution * roi_resolution,
                                          self.out_dim * resolution * resolution)
        else:
            self.conv5_mask = ConvTranspose2d(cin, dim, 2, stride=2)
            self.mask_fcn_logits = conv(dim, self.out_dim, 1, bias=True)

    def forward(self, roi_feats: torch.Tensor) -> torch.Tensor:
        """(R, res, res, C) -> float32 logits (R, m, m, out_dim)."""
        x = roi_feats.to(self.dtype).permute(0, 3, 1, 2)
        for name in self.convs:
            x = F.relu(getattr(self, name)(x))
        if self.use_fc_output:
            r, m = x.shape[0], self.resolution
            flat = x.permute(0, 2, 3, 1).reshape(r, -1)  # Flax flattens NHWC
            return self.mask_fcn_logits(flat).reshape(r, m, m, self.out_dim).float()
        x = F.relu(self.conv5_mask(x))
        return _nhwc_f32(self.mask_fcn_logits(x))


class KeypointHead(nn.Module):
    """The keypoint head (sad_tpu/models/rcnn.py KeypointHead;
    keypoint_rcnn_heads.py): not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "KeypointHead is not ported to sad_tpu_torch yet (ROADMAP.md Queue 1)")


def mask_num_convs(head_name: str) -> int:
    """MRCNN.ROI_MASK_HEAD -> number of 3x3 convs (sad_tpu/models/rcnn.py:239-241)."""
    if "v1up" not in head_name:
        return 4
    return 4 if "4convs" in head_name else (2 if "2convs" in head_name else 0)


class GeneralizedRCNN(nn.Module):
    """FPN backbone + RPN + box and mask RoI heads.

    forward(images, im_hw) runs backbone, RPN, proposal generation and the
    box head with the TEST settings: the Faster R-CNN inference path. The
    mask head runs through ``mask_heads`` on chosen rois, as the reference's
    cascaded inference does.
    """

    def __init__(self, cfg):
        super().__init__()
        if cfg.MODEL.KEYPOINTS_ON:
            raise NotImplementedError(
                "MODEL.KEYPOINTS_ON: the keypoint head is not ported to sad_tpu_torch "
                "yet (ROADMAP.md Queue 1)")
        self.cfg = cfg
        self.arch = a = arch_from_config(cfg)
        dtype = getattr(torch, a.compute_dtype)
        self.fpn = FPNRetinaNetBackbone(a)
        self.rpn = RPNHead(a.fpn_dim, len(cfg.FPN.RPN_ASPECT_RATIOS), cfg.FPN.RPN_MIN_LEVEL)
        res = cfg.FAST_RCNN.ROI_XFORM_RESOLUTION
        self.box_head = FastRCNNBoxHead(
            a.fpn_dim * res * res, cfg.FAST_RCNN.MLP_HEAD_DIM, cfg.MODEL.NUM_CLASSES,
            cfg.MODEL.CLS_AGNOSTIC_BBOX_REG, dtype)
        if cfg.MODEL.MASK_ON:
            self.mask_head = MaskHead(
                a.fpn_dim, cfg.MRCNN.DIM_REDUCED, cfg.MODEL.NUM_CLASSES,
                cfg.MRCNN.CLS_SPECIFIC_MASK, mask_num_convs(cfg.MRCNN.ROI_MASK_HEAD),
                cfg.MRCNN.USE_FC_OUTPUT, cfg.MRCNN.RESOLUTION,
                cfg.MRCNN.ROI_XFORM_RESOLUTION, dtype)

    def _features(self, images: torch.Tensor) -> Dict[int, torch.Tensor]:
        return self.fpn(images.permute(0, 3, 1, 2))  # NHWC images, as sad_tpu takes them

    def roi_features(self, feats: Dict[int, torch.Tensor]) -> Dict[int, torch.Tensor]:
        """The RoI levels of ``feats`` (FPN.ROI_MIN_LEVEL..ROI_MAX_LEVEL)."""
        cfg = self.cfg
        return {l: feats[l] for l in range(cfg.FPN.ROI_MIN_LEVEL, cfg.FPN.ROI_MAX_LEVEL + 1)
                if l in feats}

    def backbone(self, images: torch.Tensor) -> Dict[int, torch.Tensor]:
        """{level: (B, H_l, W_l, C)} feature maps of (B, H, W, 3) images."""
        return {l: f.permute(0, 2, 3, 1) for l, f in self._features(images).items()}

    def rpn_outputs(self, feats: Dict[int, torch.Tensor]):
        """The RPN head over the RPN levels of NCHW ``feats``: float32 NHWC
        objectness logits and box deltas per level."""
        cfg = self.cfg
        rpn_levels = range(cfg.FPN.RPN_MIN_LEVEL, cfg.FPN.RPN_MAX_LEVEL + 1)
        return self.rpn({l: feats[l] for l in rpn_levels if l in feats})

    def rpn_candidates(self, logits, deltas, im_hw: torch.Tensor, train: bool = False):
        """Per level, every image's RPN_PRE_NMS_TOP_N candidates (the TEST
        settings, or with ``train`` the TRAIN ones):
        [(level, boxes (B, k, 4), top_scores (B, k), masked (B, k))]."""
        cfg = self.cfg
        mode = cfg.TRAIN if train else cfg.TEST
        im_hw = im_hw.float()
        na = len(cfg.FPN.RPN_ASPECT_RATIOS)
        prop_levels = []
        for lvl, lg in logits.items():
            b, h, w, _ = lg.shape
            anchors = rpn_anchor_field_on(
                lg.device, lvl, cfg.FPN.RPN_MIN_LEVEL, float(cfg.FPN.RPN_ANCHOR_START_SIZE),
                tuple(cfg.FPN.RPN_ASPECT_RATIOS), h, w)
            bx, ts, ms = proposal_candidates(
                torch.sigmoid(lg), deltas[lvl].reshape(b, h, w, na, 4), anchors, im_hw,
                mode.RPN_PRE_NMS_TOP_N, float(mode.RPN_MIN_SIZE))
            prop_levels.append((lvl, bx, ts, ms))
        return prop_levels

    def collect(self, lv_b, lv_s, lv_v, train: bool = False):
        """The global top RPN_POST_NMS_TOP_N of the per-level NMS results
        and each roi's RoI level."""
        cfg = self.cfg
        mode = cfg.TRAIN if train else cfg.TEST
        return collect_and_distribute_fpn_proposals(
            lv_b, lv_s, lv_v, mode.RPN_POST_NMS_TOP_N,
            cfg.FPN.ROI_MIN_LEVEL, cfg.FPN.ROI_MAX_LEVEL,
            cfg.FPN.ROI_CANONICAL_SCALE, cfg.FPN.ROI_CANONICAL_LEVEL)

    def proposals_from_rpn(self, logits, deltas, im_hw: torch.Tensor, train: bool = False):
        """Candidates per (level, image) from the RPN outputs, ONE NMS call
        over all of them, then the global top-k and the RoI levels. Returns
        (boxes (B, R, 4), scores (B, R), valid (B, R), levels (B, R))."""
        mode = self.cfg.TRAIN if train else self.cfg.TEST
        prop_levels = self.rpn_candidates(logits, deltas, im_hw, train)
        return self.collect(*nms_levels_batched(
            prop_levels, mode.RPN_NMS_THRESH, mode.RPN_POST_NMS_TOP_N), train)

    def proposals(self, feats: Dict[int, torch.Tensor], im_hw: torch.Tensor):
        """The RPN over NCHW ``feats`` and ``proposals_from_rpn`` with the
        TEST settings."""
        return self.proposals_from_rpn(*self.rpn_outputs(feats), im_hw)

    def box_roi_features(self, feats: Dict[int, torch.Tensor], boxes, roi_lvls, valid):
        """RoIAlign of (B, R, 4) per-image boxes for the box head, from the
        NHWC ``feats``: (B*R, res, res, C)."""
        cfg = self.cfg
        return multilevel_roi_align(
            self.roi_features(feats), flat_rois(boxes), roi_lvls.reshape(-1), valid.reshape(-1),
            cfg.FAST_RCNN.ROI_XFORM_RESOLUTION, cfg.FAST_RCNN.ROI_XFORM_SAMPLING_RATIO)

    def forward(self, images: torch.Tensor, im_hw: torch.Tensor) -> Dict[str, torch.Tensor]:
        """images (B, H, W, 3); im_hw (B, 2). Per-image proposals and
        box-head outputs with static shapes."""
        nchw = self._features(images)
        boxes, scores, valid, roi_lvls = self.proposals(nchw, im_hw)
        feats = {l: f.permute(0, 2, 3, 1) for l, f in nchw.items()}
        b, r = boxes.shape[:2]
        cls_score, bbox_pred = self.box_head(self.box_roi_features(feats, boxes, roi_lvls, valid))
        cls_score = cls_score.reshape(b, r, -1)
        return {
            "rois": boxes,  # (B, R, 4)
            "roi_scores": scores,
            "roi_valid": valid,
            "roi_levels": roi_lvls,
            "cls_score": cls_score,
            "cls_prob": torch.softmax(cls_score, dim=-1),
            "bbox_pred": bbox_pred.reshape(b, r, -1),
            "features": feats,
        }

    def mask_heads(self, roi_feats: torch.Tensor) -> torch.Tensor:
        return self.mask_head(roi_feats)


def flat_rois(boxes: torch.Tensor) -> torch.Tensor:
    """(B, K, 4) per-image boxes -> (B*K, 5) image-major rois
    [batch, x1, y1, x2, y2]."""
    b, k = boxes.shape[:2]
    batch_col = torch.arange(b, dtype=boxes.dtype, device=boxes.device)[:, None, None]
    return torch.cat([batch_col.expand(b, k, 1), boxes], dim=2).reshape(b * k, 5)
