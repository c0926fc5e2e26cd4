"""Feature Pyramid Network on a ResNet trunk, RetinaNet flavour (P3..P7)
(ref: sad_tpu/models/fpn.py; detectron/lib/modeling/FPN.py:116-249).

- 1x1 laterals on res3/res4/res5, nearest 2x top-down, 3x3 post-hoc convs;
- P6 = 3x3/2 conv on the *raw res5 feature* (not P5) and P7 = 3x3/2 conv on
  relu(P6) (FPN.EXTRA_CONV_LEVELS, FPN.py:202-222);
- otherwise P6 = stride-2 subsample of P5 (the max-pool branch, FPN.py:192-198).

Module names are the reference blob names, as in the Flax tree.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from .arch import ModelArch
from .resnet import ResNetBody, conv


class FPNRetinaNetBackbone(nn.Module):
    """ResNet body + FPN; returns {level: (N, fpn_dim, H_l, W_l)}."""

    def __init__(self, arch: ModelArch):
        super().__init__()
        a = arch
        self.arch = a
        self.body = ResNetBody(a)
        stage_names = ResNetBody.stage_blob_names(a)
        stage_dims = dict(zip(stage_names, a.stage_dims()))
        n_stages = 4 - (max(a.min_level, 2) - 2)
        # coarsest first: ['res5_..', 'res4_..', 'res3_..'] (FPN.py:129-137)
        self.laterals = stage_names[::-1][:n_stages]
        self.res5 = stage_names[-1]

        top = self.laterals[0]
        self.add_module(f"fpn_inner_{top}", conv(stage_dims[top], a.fpn_dim, 1, bias=True))
        for name in self.laterals[1:]:
            self.add_module(f"fpn_inner_{name}_lateral",
                            conv(stage_dims[name], a.fpn_dim, 1, bias=True))
        for name in self.laterals:
            self.add_module(f"fpn_{name}", conv(a.fpn_dim, a.fpn_dim, 3, bias=True))
        self.extra_levels = []
        if a.max_level > 5:
            if a.extra_conv_levels:
                cin = stage_dims[self.res5]
                for lvl in range(6, a.max_level + 1):
                    self.add_module(f"fpn_{lvl}", conv(cin, a.fpn_dim, 3, 2, bias=True))
                    self.extra_levels.append(lvl)
                    cin = a.fpn_dim
            elif a.max_level != 6:
                raise ValueError("levels above P6 need FPN.EXTRA_CONV_LEVELS")

    def forward(self, images: torch.Tensor) -> Dict[int, torch.Tensor]:
        a = self.arch
        body_out = self.body(images)
        top = self.laterals[0]
        inners = [getattr(self, f"fpn_inner_{top}")(body_out[top])]
        for name in self.laterals[1:]:
            lat = getattr(self, f"fpn_inner_{name}_lateral")(body_out[name])
            inners.append(lat + F.interpolate(inners[-1], scale_factor=2, mode="nearest"))
        pyramid: Dict[int, torch.Tensor] = {}
        for i, name in enumerate(self.laterals):
            pyramid[5 - i] = getattr(self, f"fpn_{name}")(inners[i])
        if a.max_level > 5:
            if a.extra_conv_levels:
                feat = body_out[self.res5]
                for lvl in self.extra_levels:
                    if lvl > 6:
                        feat = F.relu(feat)
                    feat = getattr(self, f"fpn_{lvl}")(feat)
                    pyramid[lvl] = feat
            else:
                pyramid[6] = F.max_pool2d(pyramid[5], 1, stride=2)
        return {lvl: pyramid[lvl] for lvl in a.levels}
