"""Model creation (ref: sad_tpu/models/model_builder.py:25-95), seeded
random initialisation, and the parameter-role masks of training (ref:
sad_tpu/models/model_builder.py:139-182).

'retinanet' and 'distillation' both build a RetinaNet: for distillation,
call create_model once with the teacher config and once with the student
config. 'generalized_rcnn' with FPN builds a GeneralizedRCNN (Fast / Faster /
Mask / Keypoint R-CNN), and so does 'rpn' (RPN-only proposals: the same tree,
of which test_net runs the proposal stage), as sad_tpu's create_model does
(sad_tpu/models/model_builder.py:40-46); the old type spellings that
sad_tpu's config aliases to them normalise here too. Without FPN, and for
'rfcn', a SingleScaleRCNN (models/single_scale.py): the C4, VGG16 and
VGG_CNN_M_1024 bodies, the res5 or fc6 / fc7 box head, the v0upshare / v0up
mask heads, R-FCN.

Refused where sad_tpu builds something other than what the config names or
ignores the option (ROADMAP.md Queue 3): a single-scale model with
KEYPOINTS_ON, ROI_XFORM_METHOD other than RoIAlign or ROI_XFORM_SAMPLING_RATIO
0, a v1up mask head on a single-scale body, a mask head without the res5 box
head, R-FCN with MASK_ON.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from ..config.config import _TYPE_ALIASES
from ..device import get_device
from .arch import arch_from_config
from .rcnn import GeneralizedRCNN
from .retinanet import RetinaNet, cls_bias_init
from .single_scale import SingleScaleRCNN

_QUEUE3 = " (ROADMAP.md Queue 3)"


def create_model(cfg, device="cuda", generator: Optional[torch.Generator] = None
                 ) -> nn.Module:
    """The model for cfg.MODEL.TYPE (a RetinaNet or a GeneralizedRCNN),
    float32 parameters on ``device`` (the card unless the caller asks for the
    CPU; no fallback), initialised from ``generator`` (a torch.Generator on
    that device) with the JAX model's initialiser distributions. Layers run
    in cfg.COMPUTE_DTYPE with the float32 parameters cast per layer; for
    inference the model may be cast once with ``model.to(compute_dtype(cfg))``
    after loading weights."""
    # deprecated type spellings normalise at load_cfg; here too, for configs
    # assembled without it
    mtype = _TYPE_ALIASES.get(cfg.MODEL.TYPE, cfg.MODEL.TYPE)
    if mtype == "generalized_rcnn" and cfg.MODEL.RPN_ONLY:
        raise NotImplementedError(
            "MODEL.RPN_ONLY with MODEL.TYPE 'generalized_rcnn': sad_tpu dispatches "
            "RPN-only on MODEL.TYPE 'rpn' alone and ignores the flag; set MODEL.TYPE 'rpn' "
            "(ROADMAP.md Queue 3)")
    with torch.device(get_device(device)):
        if mtype in ("retinanet", "distillation"):
            model = RetinaNet(arch_from_config(cfg))
        elif mtype in ("generalized_rcnn", "rpn") and cfg.FPN.FPN_ON:
            _check_head_strings_fpn(cfg)
            model = GeneralizedRCNN(cfg)
        elif mtype in ("generalized_rcnn", "rpn", "rfcn"):
            if mtype != "rfcn":
                _check_head_strings_c4(cfg)
            check_single_scale(cfg)
            model = SingleScaleRCNN(cfg)
        else:
            raise NotImplementedError(f"MODEL.TYPE={mtype!r} is not a model type of sad_tpu")
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


def _check_head_strings_c4(cfg) -> None:
    """sad_tpu/models/model_builder.py:81-95: a single-scale box head must
    be the res5 head, a 2mlp head or a VGG body's; a mask head v0up* or v1up*."""
    body = cfg.MODEL.CONV_BODY or ""
    head = cfg.FAST_RCNN.ROI_BOX_HEAD
    if not ("ResNet" in head or "resnet" in head or "VGG16" in body or "VGG_CNN" in body
            or "2mlp" in head):
        raise NotImplementedError(f"C4 box head {head!r}")
    if cfg.MODEL.MASK_ON and not ("v0up" in cfg.MRCNN.ROI_MASK_HEAD
                                  or "v1up" in cfg.MRCNN.ROI_MASK_HEAD):
        raise NotImplementedError(f"C4 mask head {cfg.MRCNN.ROI_MASK_HEAD!r}")


def check_single_scale(cfg) -> None:
    """Refuse the single-scale options that sad_tpu's SingleScaleRCNN builds
    as something else or ignores, before any work."""
    m = cfg.MODEL
    if m.KEYPOINTS_ON:
        raise NotImplementedError("KEYPOINTS_ON on a single-scale (C4) model: sad_tpu's "
                                  "SingleScaleRCNN has no keypoint head" + _QUEUE3)
    xforms = [("FAST_RCNN", cfg.FAST_RCNN)] + ([("MRCNN", cfg.MRCNN)] if m.MASK_ON else [])
    for name, c in xforms:
        if c.ROI_XFORM_METHOD != "RoIAlign":
            raise NotImplementedError(
                f"{name}.ROI_XFORM_METHOD {c.ROI_XFORM_METHOD!r} on a single-scale model: "
                "sad_tpu's SingleScaleRCNN always aligns" + _QUEUE3)
        if c.ROI_XFORM_SAMPLING_RATIO <= 0:
            raise NotImplementedError(
                f"{name}.ROI_XFORM_SAMPLING_RATIO 0 (Detectron's adaptive grid): sad_tpu "
                "requires a fixed ratio > 0" + _QUEUE3)
    if not m.MASK_ON:
        return
    if m.TYPE == "rfcn":
        raise NotImplementedError("R-FCN with MASK_ON: sad_tpu's R-FCN has no mask head and "
                                  "its step skips the mask loss" + _QUEUE3)
    if "v1up" in cfg.MRCNN.ROI_MASK_HEAD:
        raise NotImplementedError(
            f"mask head {cfg.MRCNN.ROI_MASK_HEAD!r} on a single-scale body: sad_tpu accepts "
            "it and builds v0up" + _QUEUE3)
    if "ResNet" not in cfg.FAST_RCNN.ROI_BOX_HEAD:
        raise NotImplementedError("MASK_ON on a single-scale model without the res5 box head "
                                  "(ResNet.add_ResNet_roi_conv5_head): the v0up mask heads "
                                  "need res5" + _QUEUE3)


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


def _init_mask_weight(cfg, w: torch.Tensor, leaf: str, generator, fc_output=None) -> None:
    """MRCNN.CONV_INIT (sad_tpu/models/rcnn.py:115-155): N(0, 0.001), or
    MSRAFill = normal with std sqrt(2 / fan_out); the dense output and the
    class-agnostic logits always take N(0, 0.001). ``fc_output`` defaults to
    MRCNN.USE_FC_OUTPUT (the v0up output of a single-scale model has none)."""
    if cfg.MRCNN.CONV_INIT not in ("GaussianFill", "MSRAFill"):
        raise ValueError(f"Unknown MRCNN.CONV_INIT: {cfg.MRCNN.CONV_INIT!r}")
    fc = cfg.MRCNN.USE_FC_OUTPUT if fc_output is None else fc_output
    gauss = cfg.MRCNN.CONV_INIT == "GaussianFill" or (
        leaf == "mask_fcn_logits" and (fc or not cfg.MRCNN.CLS_SPECIFIC_MASK))
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
    mask head, KRCNN.CONV_INIT on the keypoint head; for a single-scale
    model the same by role (the VGG and res5 convs he-normal, R-FCN's N(0,
    0.01), the v0up output by MRCNN.CONV_INIT)."""
    a = model.arch
    for name, m in model.named_modules():
        if not isinstance(m, (nn.Conv2d, nn.Linear, nn.ConvTranspose2d)):
            continue
        leaf = name.rsplit(".", 1)[-1]
        top = name.split(".", 1)[0]
        if top == "mask_head":
            _init_mask_weight(model.cfg, m.weight, leaf, generator)
        elif top == "mask_out":  # single-scale v0up output
            _init_mask_weight(model.cfg, m.weight, leaf, generator, fc_output=False)
        elif top == "kps_head":
            _init_keypoint_weight(model.cfg, m.weight, leaf, generator)
        elif leaf in ("fc6", "fc7") and top in ("box_head", "fc6", "fc7"):
            _variance_scaling(m.weight, 1.0, "fan_in", "truncated_normal", generator)
        elif leaf in ("cls_score", "bbox_pred") and top in ("box_head", leaf):
            m.weight.normal_(0.0, 0.01 if leaf == "cls_score" else 0.001, generator=generator)
        elif name.startswith("fpn.body.") or top in ("body", "res5_head", "mask_res5"):
            # he-normal backbone convs (VGG's too), branch2c scaled to 0.01
            scale = 0.01 if leaf.endswith("_branch2c") else 2.0
            _variance_scaling(m.weight, scale, "fan_in", "truncated_normal", generator)
        elif top == "fpn":
            if leaf.endswith("_lateral") and a.zero_init_lateral:
                m.weight.zero_()
            else:
                _variance_scaling(m.weight, 1.0, "fan_avg", "uniform", generator)
        else:  # RetinaNet and RPN heads, R-FCN's convs
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
    (model_builder.py:200-207). The prefix rule takes VGG16's conv1_1 /
    conv1_2 and VGG_CNN_M's conv1 too, as sad_tpu's does."""
    out = {}
    for name, _ in model.named_parameters():
        path = name.split(".")
        out[name] = not (_is_affine_channel(path) or _is_frozen_stage(path, freeze_at)
                         or (freeze_conv_body and path[0] in ("fpn", "body")))
    return out


def bias_mask(model: nn.Module) -> Dict[str, bool]:
    """Parameter name -> is a conv bias (2x LR, no weight decay;
    optimizer.py:115-124)."""
    return {name: name.endswith(".bias") for name, _ in model.named_parameters()}
