"""RetinaNet heads on an FPN backbone (ref: sad_tpu/models/retinanet.py;
detectron/lib/modeling/retinanet_heads.py:63-245).

- The cls/bbox towers are ONE set of modules applied to every level (the
  reference's ConvShared weight sharing).
- Prior-probability bias init on the cls logits (retinanet_heads.py:29-60).
- Outputs are float32 dicts keyed by level, each map NHWC (N, H, W, A*K)
  and contiguous, made in one copy from the head's NCHW output: the channel
  order c = a*K + k and the flattening in decode and in the losses are
  those of the JAX model, and the loss kernels read (rows, K) rows.
- The probs are computed from the float32 logits (sad_tpu/models/
  retinanet.py:95,130), not in the compute dtype.
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


def _nhwc_f32(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> contiguous NHWC float32, one copy (none when it already is)."""
    return x.permute(0, 2, 3, 1).to(torch.float32, memory_format=torch.contiguous_format)


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

    def forward(self, features: Dict[int, torch.Tensor], bbox: bool = True
                ) -> Tuple[Dict[int, torch.Tensor], Dict[int, torch.Tensor]]:
        """Per-level cls logits and, with ``bbox``, box deltas (the box
        tower does not run without it)."""
        cls_out, box_out = {}, {}
        for lvl in self.arch.levels:
            x = features[lvl]
            logits, c = self._run(x, self.cls_tower, self.cls_pred)
            cls_out[lvl] = _nhwc_f32(logits)
            if bbox:
                b = c if self.arch.share_cls_bbox_tower else x
                deltas, _ = self._run(b, self.bbox_tower, self.bbox_pred)
                box_out[lvl] = _nhwc_f32(deltas)
        return cls_out, box_out


ALL_OUTPUTS = ("cls_logits", "bbox_pred", "cls_prob")


class RetinaNet(nn.Module):
    """FPN backbone + RetinaNet head.

    forward(images NHWC, outputs=ALL_OUTPUTS) returns the requested entries of
      'cls_logits': {level: (N, H_l, W_l, A*cls_pred_dim) float32}
      'bbox_pred':  {level: (N, H_l, W_l, A*bbox_regr_dim) float32}
      'cls_prob':   {level: sigmoid / per-anchor softmax probs}
    Work for an output nobody asked for is not done: the frozen teacher of
    the SAD step asks for 'cls_prob' only, the student for the logits and
    box deltas (under jit sad_tpu gets the same from dead-code elimination).
    """

    def __init__(self, arch: ModelArch):
        super().__init__()
        self.arch = arch
        self.fpn = FPNRetinaNetBackbone(arch)
        self.head = RetinaNetHead(arch)

    def forward(self, images: torch.Tensor, outputs=ALL_OUTPUTS):
        a = self.arch
        unknown = set(outputs) - set(ALL_OUTPUTS)
        if unknown:
            raise ValueError(f"unknown RetinaNet outputs {sorted(unknown)}")
        # NHWC images, as sad_tpu takes them
        feats = self.fpn(images.permute(0, 3, 1, 2))
        cls_out, box_out = self.head(feats, bbox="bbox_pred" in outputs)
        out = {"cls_logits": cls_out, "bbox_pred": box_out}
        if "cls_prob" in outputs:
            probs = {}
            for lvl, logits in cls_out.items():
                if a.softmax:
                    n, h, w, _ = logits.shape
                    grouped = logits.reshape(n, h, w, a.num_anchors, a.cls_pred_dim)
                    probs[lvl] = torch.softmax(grouped, dim=-1).reshape(logits.shape)
                else:
                    probs[lvl] = torch.sigmoid(logits)
            out["cls_prob"] = probs
        return {k: out[k] for k in outputs}
