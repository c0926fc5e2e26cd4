"""ResNet / ResNeXt backbone body (ref: sad_tpu/models/resnet.py, itself
capability-equivalent to detectron/lib/modeling/ResNet.py).

NCHW inside, as cuDNN prefers. Module names follow the Flax parameter tree
(``body.Bottleneck_3.res3_0_branch2a``, ``body.res_conv1_bn``) so that
sad_tpu_torch/convert.py is a renaming plus a kernel transpose, and the
Detectron blob names stay one renaming away.

Parameters stay float32 and every layer runs in the dtype of its input,
casting its weights to it, as the JAX model (param_dtype float32, dtype
COMPUTE_DTYPE) does; the body casts the images to ``arch.compute_dtype``.
So the optimizer updates float32 weights while convolutions run in bf16.
For inference a model may also be cast once (``model.to(torch.bfloat16)``):
the per-layer casts are then no-ops.

FREEZE_AT: the output of stage res{FREEZE_AT} is detached, so no gradient
reaches conv1..res{FREEZE_AT} (sad_tpu's stop_gradient, resnet.py:357-358;
the reference's StopGradient, ResNet.py:103-122).

FOLD_AFFINE (sad_tpu resnet.py:222-260, the stem :307-315): every conv ->
AffineChannel pair, the stem's included, becomes one ``conv(x, W*s) + b``.
``W*s`` is formed in float32 on every forward (so a trainable W gets its
gradient through it) and cast to the compute dtype, and ``b`` goes in as the
conv's bias; s and b stay frozen and the parameter tree is unchanged, so
convert.py and the checkpoints are untouched. The per-channel multiply then
runs over the weights instead of the activations; the bias still costs one
broadcast pass over the output (PyTorch adds a cuDNN conv's bias after the
conv, as sad_tpu adds b to the conv's output). At float32 it equals the
unfolded form up to rounding; at bf16 the product W*s is rounded once more
(chip_smoke.py ``[fold_affine]`` states the tolerance).

S2D_STEM (sad_tpu resnet.py:156-207, ``Conv1S2D``): sad_tpu computes conv1
as a 4x4/s1 convolution over the canvas blocked 2x2 into 12 channels, a TPU
phrasing with the same outputs and the same parameter. On the H100 that
phrasing, through cuDNN, was slower than cuDNN's 7x7 stem in every reading
(PERF.md section 6's S2D_STEM readings: the stem alone, serving and the
joint step), so
with S2D_STEM the port runs the 7x7 stem. It keeps sad_tpu's refusal of an
odd canvas height or width (its reshape's).

REMAT_BACKBONE (sad_tpu resnet.py:336, ``nn.remat(Bottleneck)``; the
reference's memonger): with grad enabled every Bottleneck runs under
``torch.utils.checkpoint`` (non-reentrant: the steps take ``torch.autograd.
grad``, which the reentrant form refuses), so its activations are not kept
but computed again in the backward, by the same ops in the same dtype (the
per-layer casts and FOLD_AFFINE's W*s sit inside the block). FREEZE_AT's
detach stays after the stage. Inference is unchanged.

A caller that runs the body on row bands of the canvas (parallel/spatial.py)
sets two attributes for its call: ``remat_context_fn``, checkpoint's
context_fn, so that a block's recompute runs on the bands again, and
``whole_rows`` False, since a band's height is not the canvas's.

Not ported: the grouped-conv phrasings of sad_tpu/ops/grouped_conv.py
(native ``groups=`` here).
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, noop_context_fn

from .arch import ModelArch


class AffineChannel(nn.Module):
    """y = x * s + b per channel; s/b are frozen (no grad in the reference,
    affine_channel_op.cc:70-80), cast to the activation dtype."""

    def __init__(self, dim: int):
        super().__init__()
        self.s = nn.Parameter(torch.ones(dim), requires_grad=False)
        self.b = nn.Parameter(torch.zeros(dim), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.s.to(x.dtype).view(1, -1, 1, 1)
        b = self.b.to(x.dtype).view(1, -1, 1, 1)
        return x * s + b


class Conv2d(nn.Conv2d):
    """nn.Conv2d in the dtype of its input: weight and bias are cast to it,
    as a Flax conv with float32 params and a bf16 dtype casts its kernel."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


def conv_affine(conv: Conv2d, affine: AffineChannel, x: torch.Tensor,
                fold: bool) -> torch.Tensor:
    """``affine(conv(x))``, or with ``fold`` (FOLD_AFFINE) the same as one
    conv with the weight W*s (formed in float32, or float64 for a float64
    model, then cast to x's dtype) and the bias b."""
    if not fold:
        return affine(conv(x))
    dt = torch.promote_types(conv.weight.dtype, torch.float32)
    w = conv.weight.to(dt) * affine.s.to(dt).view(-1, 1, 1, 1)
    return conv._conv_forward(x, w.to(x.dtype), affine.b.to(x.dtype))


def conv(cin: int, cout: int, kernel: int, stride: int = 1, dilation: int = 1,
         groups: int = 1, bias: bool = False) -> Conv2d:
    """Conv with sad_tpu's symmetric ``(k-1)*d//2`` padding (resnet.py:51-68)."""
    return Conv2d(
        cin, cout, kernel, stride=stride, padding=((kernel - 1) * dilation) // 2,
        dilation=dilation, groups=groups, bias=bias,
    )


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (grouped) -> 1x1 with AffineChannel after each conv, plus a
    projection shortcut when dims change (ResNet.py:221-278)."""

    def __init__(self, prefix: str, dim_in: int, dim_out: int, dim_inner: int,
                 stride: int, groups: int, dilation: int, stride_1x1: bool,
                 fold: bool):
        super().__init__()
        self.fold = fold
        s1, s3 = (stride, 1) if stride_1x1 else (1, stride)
        self.names = [prefix + "_branch2a", prefix + "_branch2b",
                      prefix + "_branch2c"]
        self.add_module(self.names[0], conv(dim_in, dim_inner, 1, s1))
        self.add_module(self.names[0] + "_bn", AffineChannel(dim_inner))
        self.add_module(self.names[1], conv(dim_inner, dim_inner, 3, s3,
                                            dilation, groups))
        self.add_module(self.names[1] + "_bn", AffineChannel(dim_inner))
        self.add_module(self.names[2], conv(dim_inner, dim_out, 1))
        self.add_module(self.names[2] + "_bn", AffineChannel(dim_out))
        self.shortcut = None
        if dim_in != dim_out:
            self.shortcut = prefix + "_branch1"
            self.add_module(self.shortcut, conv(dim_in, dim_out, 1, stride))
            self.add_module(self.shortcut + "_bn", AffineChannel(dim_out))

    def _conv_bn(self, x, name):
        return conv_affine(getattr(self, name), getattr(self, name + "_bn"), x, self.fold)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b, c = self.names
        cur = F.relu(self._conv_bn(x, a))
        cur = F.relu(self._conv_bn(cur, b))
        cur = self._conv_bn(cur, c)
        sc = x if self.shortcut is None else self._conv_bn(x, self.shortcut)
        return F.relu(cur + sc)


class ResNetBody(nn.Module):
    """conv1..res5 trunk returning the stage outputs keyed by the reference's
    blob names ('res{stage}_{last}_sum')."""

    # set for a call on row bands (module docstring)
    remat_context_fn = staticmethod(noop_context_fn)
    whole_rows = True

    def __init__(self, arch: ModelArch):
        super().__init__()
        a = arch
        self.arch = a
        self.conv1 = conv(3, 64, 7, 2)
        self.res_conv1_bn = AffineChannel(64)
        dim_in = 64
        dim_bottleneck = int(a.num_groups * a.width_per_group * a.channel_ratio)
        self.stages: List[List[str]] = []
        k = 0
        for stage_idx, (n_blocks, dim_out) in enumerate(
            zip(a.block_counts, a.stage_dims()), start=2
        ):
            dilation = a.res5_dilation if stage_idx == 5 else 1
            inner = dim_bottleneck * (2 ** (stage_idx - 2))
            names = []
            for i in range(n_blocks):
                # stride rule of sad_tpu resnet.py:343
                stride = 2 if (i == 0 and stage_idx > 2 and dilation == 1) else 1
                name = f"Bottleneck_{k}"
                self.add_module(name, Bottleneck(
                    f"res{stage_idx}_{i}", dim_in, dim_out, inner, stride,
                    a.num_groups, dilation, a.stride_1x1, a.fold_affine,
                ))
                names.append(name)
                dim_in = dim_out
                k += 1
            self.stages.append(names)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = x.to(getattr(torch, self.arch.compute_dtype))
        h, w = x.shape[2:]
        if self.arch.s2d_stem and (w % 2 or self.whole_rows and h % 2):
            raise ValueError(f"S2D_STEM: a {h}x{w} canvas; sad_tpu's space-to-depth stem blocks "
                             "it 2x2 and needs an even height and width")
        p = F.relu(conv_affine(self.conv1, self.res_conv1_bn, x, self.arch.fold_affine))
        p = F.max_pool2d(p, 3, stride=2, padding=1)
        remat = self.arch.remat and torch.is_grad_enabled()
        outputs = {}
        for stage_idx, names in enumerate(self.stages, start=2):
            for name in names:
                block = getattr(self, name)
                if remat:
                    # the whole block again (no early stop): on a mesh every rank then
                    # takes every halo of the block's recompute
                    p = checkpoint(block, p, use_reentrant=False, preserve_rng_state=False,
                                   early_stop=False, context_fn=self.remat_context_fn)
                else:
                    p = block(p)
            if self.arch.freeze_at == stage_idx:
                p = p.detach()
            outputs[f"res{stage_idx}_{len(names) - 1}_sum"] = p
        return outputs

    @staticmethod
    def stage_blob_names(arch: ModelArch) -> List[str]:
        return [
            f"res{stage}_{n - 1}_sum"
            for stage, n in zip(range(2, 6), arch.block_counts)
        ]
