"""VGG conv bodies for the single-scale Faster R-CNN (ref: sad_tpu/models/vgg.py;
detectron/lib/modeling/VGG16.py and VGG_CNN_M_1024.py).

Stride-16 trunks. Module names are the reference's blob names (``conv1_1`` ..
``conv5_3``, ``conv1`` .. ``conv5``), as in sad_tpu's Flax tree, so
sad_tpu_torch/convert.py maps the weights by name. NCHW inside; every conv
runs in the dtype of its input (models/resnet.Conv2d), the images cast to the
compute dtype first. Max-pools are PyTorch's, whose padding is -inf as Flax's.

sad_tpu's VGG16 docstring says its first two stages are frozen; its
trainable_mask freezes only the parameters whose names start with ``conv1``
(models/model_builder._is_frozen_stage), and so does the port's: ROADMAP.md
Queue 3 keeps the question.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import conv

# (convs, channels, stage name) of VGG16.py add_VGG16_conv5_body
VGG16_STAGES = ((2, 64, "conv1"), (2, 128, "conv2"), (3, 256, "conv3"), (3, 512, "conv4"),
                (3, 512, "conv5"))


class VGG16Body(nn.Module):
    """conv1_1 .. conv5_3 with a 2x2 / 2 max-pool after each of the first
    four stages: (B, 512, H / 16, W / 16)."""

    dim_out = 512

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.names = []
        cin = 3
        for n, dim, stage in VGG16_STAGES:
            names = [f"{stage}_{i + 1}" for i in range(n)]
            for name in names:
                self.add_module(name, conv(cin, dim, 3, bias=True))
                cin = dim
            self.names.append(names)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for si, names in enumerate(self.names):
            for name in names:
                x = F.relu(getattr(self, name)(x))
            if si < 4:  # no pool after conv5: stride 16
                x = F.max_pool2d(x, 2, stride=2)
        return x


class VGGCNNM1024Body(nn.Module):
    """VGG_CNN_M_1024: a 7x7 / 2 stem, 3x3 / 2 max-pools with padding 1 after
    conv1 and conv2, conv5 at 1024 channels: (B, 1024, H / 16, W / 16)."""

    dim_out = 1024

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = conv(3, 96, 7, 2, bias=True)
        self.conv2 = conv(96, 256, 5, 2, bias=True)
        self.conv3 = conv(256, 512, 3, bias=True)
        self.conv4 = conv(512, 512, 3, bias=True)
        self.conv5 = conv(512, 1024, 3, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        x = F.max_pool2d(F.relu(self.conv1(x)), 3, stride=2, padding=1)
        x = F.max_pool2d(F.relu(self.conv2(x)), 3, stride=2, padding=1)
        x = F.relu(self.conv3(x))
        x = F.relu(self.conv4(x))
        return F.relu(self.conv5(x))
