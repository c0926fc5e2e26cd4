"""Model creation (ref: sad_tpu/models/model_builder.py:25-54), seeded
random initialisation, and the parameter-role masks of training (ref:
sad_tpu/models/model_builder.py:139-182).

'retinanet' and 'distillation' both build a RetinaNet: for distillation,
call create_model once with the teacher config and once with the student
config. 'generalized_rcnn' with FPN builds a GeneralizedRCNN (Faster / Mask /
Keypoint R-CNN). RPN-only models, the single-scale (C4) and VGG bodies and
R-FCN are not ported yet.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from ..device import get_device
from .arch import arch_from_config
from .rcnn import GeneralizedRCNN
from .retinanet import RetinaNet, cls_bias_init


def create_model(cfg, device="cuda", generator: Optional[torch.Generator] = None
                 ) -> nn.Module:
    """The model for cfg.MODEL.TYPE (a RetinaNet or a GeneralizedRCNN),
    float32 parameters on ``device`` (the card unless the caller asks for the
    CPU; no fallback), initialised from ``generator`` (a torch.Generator on
    that device) with the JAX model's initialiser distributions. Layers run
    in cfg.COMPUTE_DTYPE with the float32 parameters cast per layer; for
    inference the model may be cast once with ``model.to(compute_dtype(cfg))``
    after loading weights."""
    mtype = cfg.MODEL.TYPE
    with torch.device(get_device(device)):
        if mtype in ("retinanet", "distillation"):
            model = RetinaNet(arch_from_config(cfg))
        elif mtype == "generalized_rcnn" and cfg.FPN.FPN_ON and not cfg.MODEL.RPN_ONLY:
            _check_head_strings_fpn(cfg)
            model = GeneralizedRCNN(cfg)
        else:
            raise NotImplementedError(
                f"MODEL.TYPE={mtype!r} (FPN_ON={cfg.FPN.FPN_ON}, RPN_ONLY="
                f"{cfg.MODEL.RPN_ONLY}) is not ported to sad_tpu_torch yet: RPN-only "
                "models, single-scale (C4) and VGG bodies and R-FCN wait (ROADMAP.md "
                "Queue 1)"
            )
    init_weights(model, generator)
    return model.eval()


def _check_head_strings_fpn(cfg) -> None:
    """Strict head-string dispatch (sad_tpu/models/model_builder.py:57-78):
    an unknown head must fail, not build the default one silently."""
    if cfg.FAST_RCNN.ROI_BOX_HEAD not in (
        "fast_rcnn_heads.add_roi_2mlp_head",
        "head_builder.add_roi_2mlp_head",
    ):
        raise NotImplementedError(f"FPN box head {cfg.FAST_RCNN.ROI_BOX_HEAD!r}")
    if cfg.FAST_RCNN.ROI_XFORM_METHOD != "RoIAlign" or (
            cfg.MODEL.MASK_ON and cfg.MRCNN.ROI_XFORM_METHOD != "RoIAlign") or (
            cfg.MODEL.KEYPOINTS_ON and cfg.KRCNN.ROI_XFORM_METHOD != "RoIAlign"):
        raise NotImplementedError("only ROI_XFORM_METHOD RoIAlign is ported")
    if cfg.MODEL.MASK_ON and "v1up" not in cfg.MRCNN.ROI_MASK_HEAD:
        raise NotImplementedError(
            f"FPN mask head {cfg.MRCNN.ROI_MASK_HEAD!r} (v0up/v0upshare are C4 heads)")
    if cfg.MODEL.KEYPOINTS_ON and "v1convX" not in cfg.KRCNN.ROI_KEYPOINTS_HEAD:
        raise NotImplementedError(f"keypoint head {cfg.KRCNN.ROI_KEYPOINTS_HEAD!r}")


def compute_dtype(cfg) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.COMPUTE_DTYPE]


def _variance_scaling(w: torch.Tensor, scale: float, mode: str,
                      distribution: str, generator, transposed: bool = False) -> None:
    """flax.linen.initializers.variance_scaling on an OIHW conv kernel, an
    (out, in) linear weight or, with ``transposed``, an IOHW deconv kernel."""
    receptive = w[0, 0].numel()
    n_out, n_in = (w.shape[1], w.shape[0]) if transposed else (w.shape[0], w.shape[1])
    fan_in, fan_out = n_in * receptive, n_out * receptive
    fan = {"fan_in": fan_in, "fan_out": fan_out, "fan_avg": (fan_in + fan_out) / 2.0}[mode]
    var = scale / fan
    if distribution == "truncated_normal":
        std = math.sqrt(var) / 0.87962566103423978  # std of N(0,1) cut at +-2
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    elif distribution == "normal":
        w.normal_(0.0, math.sqrt(var), generator=generator)
    else:  # uniform
        lim = math.sqrt(3.0 * var)
        nn.init.uniform_(w, -lim, lim, generator=generator)


def _init_mask_weight(cfg, w: torch.Tensor, leaf: str, generator) -> None:
    """MRCNN.CONV_INIT (sad_tpu/models/rcnn.py:115-155): N(0, 0.001), or
    MSRAFill = normal with std sqrt(2 / fan_out); the dense output and the
    class-agnostic logits always take N(0, 0.001)."""
    if cfg.MRCNN.CONV_INIT not in ("GaussianFill", "MSRAFill"):
        raise ValueError(f"Unknown MRCNN.CONV_INIT: {cfg.MRCNN.CONV_INIT!r}")
    gauss = cfg.MRCNN.CONV_INIT == "GaussianFill" or (
        leaf == "mask_fcn_logits" and (cfg.MRCNN.USE_FC_OUTPUT or not cfg.MRCNN.CLS_SPECIFIC_MASK))
    if gauss:
        w.normal_(0.0, 0.001, generator=generator)
    else:
        _variance_scaling(w, 2.0, "fan_out", "normal", generator,
                          transposed=leaf == "conv5_mask")


def _init_keypoint_weight(cfg, w: torch.Tensor, leaf: str, generator) -> None:
    """KRCNN.CONV_INIT (sad_tpu/models/rcnn.py KeypointHead): GaussianFill is
    N(0, 0.01) on the convs and N(0, 0.001) on the deconv output; MSRAFill
    is normal with std sqrt(2 / fan_out) on both."""
    if cfg.KRCNN.CONV_INIT == "GaussianFill":
        w.normal_(0.0, 0.001 if leaf == "kps_score_lowres" else 0.01, generator=generator)
    elif cfg.KRCNN.CONV_INIT == "MSRAFill":
        _variance_scaling(w, 2.0, "fan_out", "normal", generator,
                          transposed=leaf == "kps_score_lowres")
    else:
        raise ValueError(f"Unknown KRCNN.CONV_INIT: {cfg.KRCNN.CONV_INIT!r}")


@torch.no_grad()
def init_weights(model: nn.Module, generator: Optional[torch.Generator] = None):
    """Per-module initialisers of sad_tpu's models: he-normal backbone
    convs with a 0.01-scaled branch2c, xavier-uniform FPN convs (zero
    laterals under FPN.ZERO_INIT_LATERAL), N(0, 0.01) RetinaNet-head and RPN
    convs, zero biases, the prior-prob cls bias, AffineChannel s=1/b=0; for
    the R-CNN heads Flax's Dense default (lecun normal) on fc6/fc7, N(0,
    0.01) on cls_score, N(0, 0.001) on bbox_pred, MRCNN.CONV_INIT on the
    mask head, KRCNN.CONV_INIT on the keypoint head."""
    a = model.arch
    for name, m in model.named_modules():
        if not isinstance(m, (nn.Conv2d, nn.Linear, nn.ConvTranspose2d)):
            continue
        leaf = name.rsplit(".", 1)[-1]
        if name.startswith("mask_head."):
            _init_mask_weight(model.cfg, m.weight, leaf, generator)
        elif name.startswith("kps_head."):
            _init_keypoint_weight(model.cfg, m.weight, leaf, generator)
        elif name.startswith("box_head."):
            if leaf in ("fc6", "fc7"):
                _variance_scaling(m.weight, 1.0, "fan_in", "truncated_normal", generator)
            else:
                m.weight.normal_(0.0, 0.01 if leaf == "cls_score" else 0.001,
                                 generator=generator)
        elif name.startswith("fpn.body."):
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
    if isinstance(model, RetinaNet):
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
