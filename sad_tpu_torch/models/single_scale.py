"""The single-scale (non-FPN) R-CNN family: Faster / Mask R-CNN on a ResNet
conv4 body (C4) with the res5 RoI head, Faster R-CNN on the VGG bodies, and
R-FCN (ref: sad_tpu/models/single_scale.py; detectron/lib/modeling/
rpn_heads.py:55-123 add_single_scale_rpn_outputs, ResNet.py
add_ResNet_roi_conv5_head, VGG16.py add_VGG16_roi_fc_head,
mask_rcnn_heads.py:173-240 v0upshare / v0up, rfcn_heads.py).

One feature map at RPN.STRIDE (16), keyed by its level log2(RPN.STRIDE) = 4
so that the R-CNN plumbing of the FPN models (proposals, RoIAlign, the train
step's stages) takes it as a one-level pyramid. The RPN has RPN.SIZES x
RPN.ASPECT_RATIOS anchors a cell and one NMS call over the batch's images,
whose RPN_POST_NMS_TOP_N picks are the rois (no collect step). RoIAlign is
ops/detectron_ops.roi_align: every roi, valid or not, as sad_tpu pools it.

Module and parameter names are those of sad_tpu's Flax tree (``body``,
``rpn.conv_rpn``, ``res5_head.Bottleneck_0.res5_0_branch2a``, ``mask_res5``,
``mask_out.conv5_mask``, ``rfcn.rfcn_cls``, ``fc6``, ``cls_score``), so
sad_tpu_torch/convert.py maps a path by joining with '.'. Convolutions run
NCHW; the public methods take and return NHWC as sad_tpu does: images
(B, H, W, 3), the feature map {4: (B, H/16, W/16, C)}, roi features (R, res,
res, C). The res5 RoI maps that the v0upshare mask branch reuses stay NCHW
(R, 2048, res/2, res/2). fc6 flattens the (R, res, res, C) RoIAlign output
in its (y, x, c) order, the order of sad_tpu's Dense kernel rows.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data.anchors import field_of_anchors, generate_cell_anchors
from ..ops.detectron_ops import ps_roi_pool, roi_align
from ..ops.proposals import nms_levels_batched, proposal_candidates
from .arch import arch_from_config
from .rcnn import ConvTranspose2d, Linear, flat_rois
from .resnet import Bottleneck, ResNetBody, conv
from .retinanet import _nhwc_f32
from .vgg import VGG16Body, VGGCNNM1024Body

RPN_DIM = 512  # conv_rpn's width, fixed in sad_tpu's SingleScaleRCNN
PS_GRID = 7  # R-FCN's k (RFCN.PS_GRID_SIZE)
RFCN_DIM = 1024  # conv_new_1's width


def single_scale_cell_anchors(stride: float, sizes, aspect_ratios) -> np.ndarray:
    """(A, 4) cell anchors: every RPN.SIZES x RPN.ASPECT_RATIOS, size-major
    (sad_tpu/models/single_scale.py:345-351)."""
    return np.concatenate([generate_cell_anchors(stride, (s,), (ar,))
                           for s in sizes for ar in aspect_ratios])


@functools.lru_cache(maxsize=None)
def single_scale_anchor_field_on(device: torch.device, stride: float, sizes: Tuple[float, ...],
                                 aspect_ratios: Tuple[float, ...], h: int, w: int
                                 ) -> torch.Tensor:
    """(h, w, A, 4) float32 anchors on ``device``, copied once per process
    and map size (see models/rcnn.rpn_anchor_field_on)."""
    field = field_of_anchors(single_scale_cell_anchors(stride, sizes, aspect_ratios),
                             stride, h, w)
    with torch.inference_mode(False):
        return torch.as_tensor(field, dtype=torch.float32, device=device)


class SingleScaleRPNHead(nn.Module):
    """conv_rpn 3x3 + ReLU, then the objectness and delta 1x1 convs
    (rpn_heads.py:55-123)."""

    def __init__(self, dim_in: int, dim: int, num_anchors: int):
        super().__init__()
        self.names = ("conv_rpn", "rpn_cls_logits", "rpn_bbox_pred")
        self.conv_rpn = conv(dim_in, dim, 3, bias=True)
        self.rpn_cls_logits = conv(dim, num_anchors, 1, bias=True)
        self.rpn_bbox_pred = conv(dim, 4 * num_anchors, 1, bias=True)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, C, H, W) -> float32 NHWC logits (B, H, W, A), deltas (B, H, W, 4A)."""
        h = F.relu(self.conv_rpn(x))
        return _nhwc_f32(self.rpn_cls_logits(h)), _nhwc_f32(self.rpn_bbox_pred(h))


class RFCNHead(nn.Module):
    """conv_new_1 to 1024 + ReLU, the position-sensitive score maps rfcn_cls
    (k^2 x NUM_CLASSES) and rfcn_bbox (k^2 x 8), PSRoIPool at 1/16 and the
    vote: the mean over the k x k bins. bbox_pred is class-agnostic
    (R, 8) = [bg 4, fg 4]."""

    def __init__(self, dim_in: int, num_classes: int, ps_grid: int = PS_GRID,
                 dim_reduce: int = RFCN_DIM):
        super().__init__()
        self.num_classes, self.k = num_classes, ps_grid
        self.conv_new_1 = conv(dim_in, dim_reduce, 1, bias=True)
        self.rfcn_cls = conv(dim_reduce, ps_grid * ps_grid * num_classes, 1, bias=True)
        self.rfcn_bbox = conv(dim_reduce, ps_grid * ps_grid * 8, 1, bias=True)

    def score_maps(self, feat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, C, H, W) -> float32 NHWC class and box score maps."""
        x = F.relu(self.conv_new_1(feat))
        return _nhwc_f32(self.rfcn_cls(x)), _nhwc_f32(self.rfcn_bbox(x))

    def vote(self, cls_maps, bbox_maps, rois5) -> Tuple[torch.Tensor, torch.Tensor]:
        """PSRoIPool of the (R, 5) rois and the mean over the bins:
        (cls_score (R, C), bbox_pred (R, 8)), float32."""
        cls = ps_roi_pool(cls_maps, rois5, 1.0 / 16.0, self.k, self.num_classes)
        box = ps_roi_pool(bbox_maps, rois5, 1.0 / 16.0, self.k, 8)
        return cls.mean(dim=(1, 2)), box.mean(dim=(1, 2))

    def forward(self, feat: torch.Tensor, rois5: torch.Tensor):
        return self.vote(*self.score_maps(feat), rois5)


class ResNetRoIConv5Head(nn.Module):
    """res5 on the RoI features, its first block at stride res // 7, and the
    global average pool (ResNet.py add_ResNet_roi_conv5_head): the C4 box
    head. Bottleneck_0..2 with the prefix res5_{i}, FOLD_AFFINE as the body."""

    def __init__(self, arch, resolution: int):
        super().__init__()
        a = arch
        dims = a.stage_dims()
        inner = int(a.num_groups * a.width_per_group * a.channel_ratio) * 8
        stride = max(resolution // 7, 1)
        n = a.block_counts[-1] if len(a.block_counts) == 4 else 3
        self.blocks = [f"Bottleneck_{i}" for i in range(n)]
        for i, name in enumerate(self.blocks):
            self.add_module(name, Bottleneck(
                f"res5_{i}", dims[2] if i == 0 else dims[3], dims[3], inner,
                stride if i == 0 else 1, a.num_groups, 1, a.stride_1x1, a.fold_affine))
        self.dtype = getattr(torch, a.compute_dtype)

    def forward(self, roi_feats: torch.Tensor, return_spatial: bool = False):
        """(R, res, res, C) -> pooled (R, 2048) in the compute dtype, and
        with ``return_spatial`` the (R, 2048, res', res') NCHW res5 maps."""
        x = roi_feats.to(self.dtype).permute(0, 3, 1, 2)
        for name in self.blocks:
            x = getattr(self, name)(x)
        pooled = x.mean(dim=(2, 3))
        return (pooled, x) if return_spatial else pooled


class MaskV0UpOutput(nn.Module):
    """The v0up / v0upshare mask output on res5 RoI maps: the 2x2 / 2
    ``conv5_mask`` deconv + ReLU, then the 1x1 ``mask_fcn_logits``
    (mask_rcnn_heads.py:46-90, 173-240)."""

    def __init__(self, dim_in: int, dim_reduced: int, num_classes: int,
                 cls_specific: bool = True):
        super().__init__()
        self.conv5_mask = ConvTranspose2d(dim_in, dim_reduced, 2, stride=2)
        self.mask_fcn_logits = conv(dim_reduced, num_classes if cls_specific else 1, 1,
                                    bias=True)

    def forward(self, res5: torch.Tensor) -> torch.Tensor:
        """(R, 2048, r, r) NCHW -> float32 logits (R, 2r, 2r, out_dim)."""
        return _nhwc_f32(self.mask_fcn_logits(F.relu(self.conv5_mask(res5))))


def single_scale_body(cfg):
    """(body module, its output channels) for MODEL.CONV_BODY."""
    body = cfg.MODEL.CONV_BODY or ""
    dtype = getattr(torch, cfg.COMPUTE_DTYPE)
    if "VGG_CNN_M_1024" in body:
        return VGGCNNM1024Body(dtype), VGGCNNM1024Body.dim_out
    if "VGG16" in body:
        return VGG16Body(dtype), VGG16Body.dim_out
    a = arch_from_config(cfg)
    return ResNetBody(a), a.stage_dims()[2]  # the trunk is res4


class SingleScaleRCNN(nn.Module):
    """Non-FPN Faster R-CNN / Mask R-CNN (C4) / R-FCN at stride RPN.STRIDE.

    forward(images, im_hw) is the serving path up to the box outputs, with
    the TEST settings; the mask branch runs through ``mask_heads`` on chosen
    rois (the reference's cascaded inference) or, in v0upshare training,
    through ``mask_from_res5`` on the box branch's res5 maps."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        body = cfg.MODEL.CONV_BODY or ""
        self.arch = None if "VGG" in body else arch_from_config(cfg)
        self.level = int(round(math.log2(cfg.RPN.STRIDE)))
        self.body, dim = single_scale_body(cfg)
        self.num_anchors = len(cfg.RPN.SIZES) * len(cfg.RPN.ASPECT_RATIOS)
        self.rpn = SingleScaleRPNHead(dim, RPN_DIM, self.num_anchors)
        nc = cfg.MODEL.NUM_CLASSES
        self.is_rfcn = cfg.MODEL.TYPE == "rfcn"
        self.has_res5 = not self.is_rfcn and "ResNet" in cfg.FAST_RCNN.ROI_BOX_HEAD
        self.mask_share_res5 = False
        if self.is_rfcn:
            self.rfcn = RFCNHead(dim, nc)
            return
        if self.has_res5:
            self.res5_head = ResNetRoIConv5Head(self.arch, cfg.FAST_RCNN.ROI_XFORM_RESOLUTION)
            head_dim = self.arch.stage_dims()[3]
        else:
            res = cfg.FAST_RCNN.ROI_XFORM_RESOLUTION
            self.fc6 = Linear(dim * res * res, 4096)
            self.fc7 = Linear(4096, 4096)
            head_dim = 4096
        self.cls_score = Linear(head_dim, nc)
        self.bbox_pred = Linear(head_dim, 4 * nc)  # 4C whatever CLS_AGNOSTIC_BBOX_REG says
        if cfg.MODEL.MASK_ON:
            self.mask_share_res5 = "v0upshare" in cfg.MRCNN.ROI_MASK_HEAD
            if self.mask_share_res5:
                if cfg.MRCNN.ROI_XFORM_RESOLUTION != cfg.FAST_RCNN.ROI_XFORM_RESOLUTION:
                    raise ValueError("v0upshare requires matching box / mask RoI resolutions")
            else:
                self.mask_res5 = ResNetRoIConv5Head(self.arch, cfg.MRCNN.ROI_XFORM_RESOLUTION)
            self.mask_out = MaskV0UpOutput(self.arch.stage_dims()[3], cfg.MRCNN.DIM_REDUCED,
                                           nc, cfg.MRCNN.CLS_SPECIFIC_MASK)

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.COMPUTE_DTYPE)

    # ---- trunk and RPN

    def _features(self, images: torch.Tensor) -> Dict[int, torch.Tensor]:
        """{level: (B, C, H/16, W/16)} of (B, H, W, 3) images."""
        out = self.body(images.permute(0, 3, 1, 2))
        if isinstance(out, dict):  # ResNet: the res4 output (stride 16)
            out = out[next(k for k in out if k.startswith("res4"))]
        return {self.level: out}

    def backbone(self, images: torch.Tensor) -> Dict[int, torch.Tensor]:
        """{level: (B, H/16, W/16, C)} NHWC views of the trunk's map."""
        return {l: f.permute(0, 2, 3, 1) for l, f in self._features(images).items()}

    def roi_features(self, feats: Dict[int, torch.Tensor]) -> Dict[int, torch.Tensor]:
        return feats

    def rpn_outputs(self, feats: Dict[int, torch.Tensor]):
        """The RPN head over the NCHW map: ({level: logits}, {level: deltas})."""
        logits, deltas = self.rpn(feats[self.level])
        return {self.level: logits}, {self.level: deltas}

    def rpn_candidates(self, logits, deltas, im_hw: torch.Tensor, train: bool = False):
        """Every image's RPN_PRE_NMS_TOP_N candidates of the TEST (or, with
        ``train``, the TRAIN) settings: [(level, boxes, top_scores, masked)]."""
        cfg = self.cfg
        mode = cfg.TRAIN if train else cfg.TEST
        lg, d = logits[self.level], deltas[self.level]
        b, h, w, na = lg.shape
        anchors = single_scale_anchor_field_on(
            lg.device, float(cfg.RPN.STRIDE), tuple(float(s) for s in cfg.RPN.SIZES),
            tuple(cfg.RPN.ASPECT_RATIOS), h, w)
        bx, ts, ms = proposal_candidates(torch.sigmoid(lg), d.reshape(b, h, w, na, 4), anchors,
                                         im_hw.float(), mode.RPN_PRE_NMS_TOP_N,
                                         float(mode.RPN_MIN_SIZE))
        return [(self.level, bx, ts, ms)]

    def collect(self, lv_b, lv_s, lv_v, train: bool = False):
        """The one level's NMS picks as the rois, and their level."""
        boxes, valid = lv_b[self.level], lv_v[self.level]
        levels = torch.full(valid.shape, self.level, dtype=torch.int32, device=valid.device)
        return boxes, lv_s[self.level], valid, levels

    def proposals_from_rpn(self, logits, deltas, im_hw: torch.Tensor, train: bool = False):
        """(boxes (B, R, 4), scores (B, R), valid (B, R), levels (B, R))."""
        mode = self.cfg.TRAIN if train else self.cfg.TEST
        return self.collect(*nms_levels_batched(
            self.rpn_candidates(logits, deltas, im_hw, train), mode.RPN_NMS_THRESH,
            mode.RPN_POST_NMS_TOP_N))

    def proposals(self, feats: Dict[int, torch.Tensor], im_hw: torch.Tensor):
        return self.proposals_from_rpn(*self.rpn_outputs(feats), im_hw)

    # ---- RoI heads

    def pool(self, feats: Dict[int, torch.Tensor], rois5: torch.Tensor, res: int, sr: int
             ) -> torch.Tensor:
        """RoIAlign of every (R, 5) roi from the NHWC map: (R, res, res, C)."""
        return roi_align(feats[self.level], rois5, 1.0 / float(self.cfg.RPN.STRIDE), res, sr)

    def box_head(self, pooled: torch.Tensor, return_res5: bool = False):
        """The res5 head or fc6 / fc7 on (R, res, res, C) roi features, then
        the outputs: float32 (cls_score (R, C), bbox_pred (R, 4C)) and with
        ``return_res5`` the res5 maps."""
        res5 = None
        if self.has_res5:
            x = self.res5_head(pooled, return_spatial=return_res5)
            if return_res5:
                x, res5 = x
        else:
            x = pooled.reshape(pooled.shape[0], -1).to(self.dtype)
            x = F.relu(self.fc6(x))
            x = F.relu(self.fc7(x))
        out = (self.cls_score(x).float(), self.bbox_pred(x).float())
        return out + (res5,) if return_res5 else out

    def box_forward(self, feats: Dict[int, torch.Tensor], rois5: torch.Tensor,
                    return_res5: bool = False):
        """RoI transform + box head on (R, 5) rois -> (cls_score, bbox_pred)
        and, with ``return_res5``, the res5 RoI maps for v0upshare."""
        if self.is_rfcn:
            return self.rfcn(feats[self.level].permute(0, 3, 1, 2), rois5)
        f = self.cfg.FAST_RCNN
        pooled = self.pool(feats, rois5, f.ROI_XFORM_RESOLUTION, f.ROI_XFORM_SAMPLING_RATIO)
        return self.box_head(pooled, return_res5)

    def mask_res5_maps(self, pooled: torch.Tensor) -> torch.Tensor:
        """The res5 maps of mask RoI features: the box head's stage for
        v0upshare, the mask branch's own for v0up."""
        res5 = self.res5_head if self.mask_share_res5 else self.mask_res5
        return res5(pooled, return_spatial=True)[1]

    def mask_heads(self, feats: Dict[int, torch.Tensor], rois5: torch.Tensor) -> torch.Tensor:
        """The cascaded mask path on (R, 5) rois: RoIAlign at MRCNN's
        resolution, res5, deconv + logits: float32 (R, m, m, out_dim)."""
        m = self.cfg.MRCNN
        pooled = self.pool(feats, rois5, m.ROI_XFORM_RESOLUTION, m.ROI_XFORM_SAMPLING_RATIO)
        return self.mask_out(self.mask_res5_maps(pooled))

    def mask_from_res5(self, res5: torch.Tensor) -> torch.Tensor:
        """v0upshare training: mask logits from the box branch's res5 maps."""
        return self.mask_out(res5)

    def forward(self, images: torch.Tensor, im_hw: torch.Tensor) -> Dict[str, torch.Tensor]:
        """images (B, H, W, 3); im_hw (B, 2). Proposals and box outputs with
        static shapes, the dict of GeneralizedRCNN.forward."""
        nchw = self._features(images)
        boxes, scores, valid, levels = self.proposals(nchw, im_hw)
        feats = {l: f.permute(0, 2, 3, 1) for l, f in nchw.items()}
        b, r = boxes.shape[:2]
        cls_score, bbox_pred = self.box_forward(feats, flat_rois(boxes))
        cls_score = cls_score.reshape(b, r, -1)
        return {
            "rois": boxes, "roi_scores": scores, "roi_valid": valid, "roi_levels": levels,
            "cls_score": cls_score, "cls_prob": torch.softmax(cls_score, dim=-1),
            "bbox_pred": bbox_pred.reshape(b, r, -1), "features": feats,
        }
