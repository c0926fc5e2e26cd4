"""RetinaNet heads on an FPN backbone (ref: sad_tpu/models/retinanet.py;
detectron/lib/modeling/retinanet_heads.py:63-245).

- The cls/bbox towers are ONE set of modules applied to every level (the
  reference's ConvShared weight sharing).
- Prior-probability bias init on the cls logits (retinanet_heads.py:29-60).
- Outputs are float32 dicts keyed by level, each map NHWC (N, H, W, A*K):
  the port permutes from NCHW at the head's output, so the channel order
  c = a*K + k and the flattening in decode are those of the JAX model.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .arch import ModelArch
from .fpn import FPNRetinaNetBackbone
from .resnet import conv


def cls_bias_init(arch: ModelArch) -> torch.Tensor:
    """Bias so initial predictions are ~background (focal loss paper)."""
    prior = arch.prior_prob
    if arch.softmax:
        # class 0 (background) gets log((C-1)(1-p)/p), others 0
        per_anchor = torch.zeros(arch.cls_pred_dim)
        per_anchor[0] = math.log((arch.num_classes - 1) * (1 - prior) / prior)
        return per_anchor.repeat(arch.num_anchors)
    return torch.full((arch.cls_pred_dim * arch.num_anchors,),
                      -math.log((1 - prior) / prior))


class RetinaNetHead(nn.Module):
    """Shared cls/bbox towers applied per level."""

    def __init__(self, arch: ModelArch):
        super().__init__()
        a = arch
        self.arch = a
        k = a.min_level
        self.cls_tower = [f"retnet_cls_conv_n{i}_fpn{k}" for i in range(a.num_convs)]
        self.bbox_tower = (
            [] if a.share_cls_bbox_tower
            else [f"retnet_bbox_conv_n{i}_fpn{k}" for i in range(a.num_convs)]
        )
        for name in self.cls_tower + self.bbox_tower:
            self.add_module(name, conv(a.fpn_dim, a.fpn_dim, 3, bias=True))
        self.cls_pred = f"retnet_cls_pred_fpn{k}"
        self.bbox_pred = f"retnet_bbox_pred_fpn{k}"
        self.add_module(self.cls_pred,
                        conv(a.fpn_dim, a.cls_pred_dim * a.num_anchors, 3, bias=True))
        self.add_module(self.bbox_pred,
                        conv(a.fpn_dim, a.bbox_regr_dim * a.num_anchors, 3, bias=True))

    def _run(self, x, tower, pred):
        for name in tower:
            x = F.relu(getattr(self, name)(x))
        return getattr(self, pred)(x), x

    def forward(self, features: Dict[int, torch.Tensor]
                ) -> Tuple[Dict[int, torch.Tensor], Dict[int, torch.Tensor]]:
        cls_out, box_out = {}, {}
        for lvl in self.arch.levels:
            x = features[lvl]
            logits, c = self._run(x, self.cls_tower, self.cls_pred)
            b = c if self.arch.share_cls_bbox_tower else x
            deltas, _ = self._run(b, self.bbox_tower, self.bbox_pred)
            # NCHW -> NHWC float32
            cls_out[lvl] = logits.permute(0, 2, 3, 1).float()
            box_out[lvl] = deltas.permute(0, 2, 3, 1).float()
        return cls_out, box_out


class RetinaNet(nn.Module):
    """FPN backbone + RetinaNet head.

    forward(images NHWC) returns
      'cls_logits': {level: (N, H_l, W_l, A*cls_pred_dim) float32}
      'bbox_pred':  {level: (N, H_l, W_l, A*bbox_regr_dim) float32}
      'cls_prob':   {level: sigmoid / per-anchor softmax probs}
    """

    def __init__(self, arch: ModelArch):
        super().__init__()
        self.arch = arch
        self.fpn = FPNRetinaNetBackbone(arch)
        self.head = RetinaNetHead(arch)

    def forward(self, images: torch.Tensor):
        a = self.arch
        # NHWC images, as sad_tpu takes them
        feats = self.fpn(images.permute(0, 3, 1, 2))
        cls_out, box_out = self.head(feats)
        probs = {}
        for lvl, logits in cls_out.items():
            if a.softmax:
                n, h, w, _ = logits.shape
                grouped = logits.reshape(n, h, w, a.num_anchors, a.cls_pred_dim)
                probs[lvl] = torch.softmax(grouped, dim=-1).reshape(logits.shape)
            else:
                probs[lvl] = torch.sigmoid(logits)
        return {"cls_logits": cls_out, "bbox_pred": box_out, "cls_prob": probs}
