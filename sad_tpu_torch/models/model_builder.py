"""Model creation (ref: sad_tpu/models/model_builder.py:25-54), seeded
random initialisation, and the parameter-role masks of training (ref:
sad_tpu/models/model_builder.py:139-182).

'retinanet' and 'distillation' both build a RetinaNet: for distillation,
call create_model once with the teacher config and once with the student
config. The R-CNN families are not ported yet.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from ..device import get_device
from .arch import arch_from_config
from .retinanet import RetinaNet, cls_bias_init


def create_model(cfg, device="cuda", generator: Optional[torch.Generator] = None
                 ) -> RetinaNet:
    """RetinaNet for cfg.MODEL.TYPE, float32 parameters on ``device`` (the
    card unless the caller asks for the CPU; no fallback), initialised from
    ``generator`` (a torch.Generator on that device) with the JAX model's
    initialiser distributions. Layers run in cfg.COMPUTE_DTYPE with the
    float32 parameters cast per layer; for inference the model may be cast
    once with ``model.to(compute_dtype(cfg))`` after loading weights."""
    if cfg.MODEL.TYPE not in ("retinanet", "distillation"):
        raise NotImplementedError(
            f"MODEL.TYPE={cfg.MODEL.TYPE!r} is not ported to sad_tpu_torch "
            "yet (ROADMAP.md Queue 1)"
        )
    with torch.device(get_device(device)):
        model = RetinaNet(arch_from_config(cfg))
    init_weights(model, generator)
    return model.eval()


def compute_dtype(cfg) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.COMPUTE_DTYPE]


def _variance_scaling(w: torch.Tensor, scale: float, mode: str,
                      distribution: str, generator) -> None:
    """flax.linen.initializers.variance_scaling on an OIHW kernel."""
    receptive = w[0, 0].numel()
    fan_in, fan_out = w.shape[1] * receptive, w.shape[0] * receptive
    fan = fan_in if mode == "fan_in" else (fan_in + fan_out) / 2.0
    var = scale / fan
    if distribution == "truncated_normal":
        std = math.sqrt(var) / 0.87962566103423978  # std of N(0,1) cut at +-2
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    else:  # uniform
        lim = math.sqrt(3.0 * var)
        nn.init.uniform_(w, -lim, lim, generator=generator)


@torch.no_grad()
def init_weights(model: RetinaNet, generator: Optional[torch.Generator] = None):
    """Per-module initialisers of sad_tpu's RetinaNet: he-normal backbone
    convs with a 0.01-scaled branch2c, xavier-uniform FPN convs (zero
    laterals under FPN.ZERO_INIT_LATERAL), N(0, 0.01) head convs, zero
    biases, the prior-prob cls bias, AffineChannel s=1/b=0."""
    a = model.arch
    for name, m in model.named_modules():
        if not isinstance(m, nn.Conv2d):
            continue
        leaf = name.rsplit(".", 1)[-1]
        if name.startswith("fpn.body."):
            scale = 0.01 if leaf.endswith("_branch2c") else 2.0
            _variance_scaling(m.weight, scale, "fan_in", "truncated_normal", generator)
        elif name.startswith("fpn."):
            if leaf.endswith("_lateral") and a.zero_init_lateral:
                m.weight.zero_()
            else:
                _variance_scaling(m.weight, 1.0, "fan_avg", "uniform", generator)
        else:
            m.weight.normal_(0.0, 0.01, generator=generator)
        if m.bias is not None:
            m.bias.zero_()
    cls_pred = getattr(model.head, model.head.cls_pred)
    cls_pred.bias.copy_(cls_bias_init(a))


def _is_affine_channel(path) -> bool:
    return len(path) >= 2 and path[-2].endswith("_bn") and path[-1] in ("s", "b")


def _is_frozen_stage(path, freeze_at: int) -> bool:
    """conv1 + res2..res<freeze_at> are frozen when freeze_at >= 2."""
    if freeze_at < 2:
        return False
    prefixes = ["conv1", "res_conv1_bn"] + [f"res{s}_" for s in range(2, freeze_at + 1)]
    return any(name.startswith(pfx) for name in path for pfx in prefixes)


def trainable_mask(model: nn.Module, freeze_at: int = 2,
                   freeze_conv_body: bool = False) -> Dict[str, bool]:
    """Parameter name -> trainable. Frozen: AffineChannel s/b everywhere
    (affine_channel_op.cc:70-80), conv1..res{freeze_at}, and with
    freeze_conv_body (TRAIN.FREEZE_CONV_BODY) the whole body and FPN
    (model_builder.py:200-207)."""
    out = {}
    for name, _ in model.named_parameters():
        path = name.split(".")
        out[name] = not (_is_affine_channel(path) or _is_frozen_stage(path, freeze_at)
                         or (freeze_conv_body and path[0] == "fpn"))
    return out


def bias_mask(model: nn.Module) -> Dict[str, bool]:
    """Parameter name -> is a conv bias (2x LR, no weight decay;
    optimizer.py:115-124)."""
    return {name: name.endswith(".bias") for name, _ in model.named_parameters()}
