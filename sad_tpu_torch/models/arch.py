"""Static model-architecture description derived from a Config.

A copy of sad_tpu/models/arch.py (which sits behind a package that imports
flax); tests/test_torch_models.py holds the two equal field for field.
REMAT_BACKBONE (``remat``), S2D_STEM (``s2d_stem``) and FOLD_AFFINE are
read by models/resnet.py's ResNetBody.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Tuple

_BLOCK_COUNTS = {
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}


def blocks_for_body(conv_body: str, depth: int):
    """conv4 bodies stop at res4 (ResNet.py add_ResNet*_conv4_body)."""
    bc = _BLOCK_COUNTS[depth]
    return bc[:3] if "conv4" in conv_body else bc


@dataclass(frozen=True)
class ModelArch:
    """Everything the model modules need, all static/hashable."""

    depth: int  # 50 | 101 | 152
    block_counts: Tuple[int, ...]  # 3 stages for conv4 bodies, 4 for conv5
    num_groups: int
    width_per_group: int
    stride_1x1: bool
    channel_ratio: float
    res5_dilation: int
    freeze_at: int

    fpn_dim: int
    zero_init_lateral: bool
    min_level: int
    max_level: int
    extra_conv_levels: bool

    num_classes: int  # includes background
    aspect_ratios: Tuple[float, ...]
    scales_per_octave: int
    anchor_scale: float
    num_convs: int
    prior_prob: float
    share_cls_bbox_tower: bool
    class_specific_bbox: bool
    softmax: bool

    compute_dtype: str = "bfloat16"
    remat: bool = False
    s2d_stem: bool = False
    fold_affine: bool = False

    @property
    def num_anchors(self) -> int:
        return len(self.aspect_ratios) * self.scales_per_octave

    @property
    def num_fg_classes(self) -> int:
        return self.num_classes - 1

    @property
    def cls_pred_dim(self) -> int:
        # softmax predicts C (incl. background); sigmoid predicts C-1
        return self.num_classes if self.softmax else self.num_classes - 1

    @property
    def bbox_regr_dim(self) -> int:
        return 4 * (self.num_classes - 1) if self.class_specific_bbox else 4

    @property
    def levels(self) -> Tuple[int, ...]:
        return tuple(range(self.min_level, self.max_level + 1))

    def stage_dims(self) -> Tuple[int, int, int, int]:
        r = self.channel_ratio
        return (int(256 * r), int(512 * r), int(1024 * r), int(2048 * r))


def parse_conv_body(conv_body: str) -> int:
    """'FPN.add_fpn_ResNet50_conv5_body' -> 50 (ref naming convention)."""
    m = re.search(r"ResNet(\d+)", conv_body)
    if not m:
        raise ValueError(f"Unsupported CONV_BODY for RetinaNet path: {conv_body!r}")
    return int(m.group(1))


def arch_from_config(cfg) -> ModelArch:
    depth = parse_conv_body(cfg.MODEL.CONV_BODY) if cfg.MODEL.CONV_BODY else 50
    return ModelArch(
        depth=depth,
        block_counts=blocks_for_body(cfg.MODEL.CONV_BODY or "conv5", depth),
        num_groups=cfg.RESNETS.NUM_GROUPS,
        width_per_group=cfg.RESNETS.WIDTH_PER_GROUP,
        stride_1x1=cfg.RESNETS.STRIDE_1X1,
        channel_ratio=cfg.RESNETS.CHANNEL_RATIO,
        res5_dilation=cfg.RESNETS.RES5_DILATION,
        freeze_at=cfg.TRAIN.FREEZE_AT,
        fpn_dim=int(cfg.FPN.DIM * cfg.RESNETS.CHANNEL_RATIO),
        zero_init_lateral=cfg.FPN.ZERO_INIT_LATERAL,
        min_level=cfg.FPN.RPN_MIN_LEVEL,
        max_level=cfg.FPN.RPN_MAX_LEVEL,
        extra_conv_levels=cfg.FPN.EXTRA_CONV_LEVELS,
        num_classes=cfg.MODEL.NUM_CLASSES,
        aspect_ratios=tuple(cfg.RETINANET.ASPECT_RATIOS),
        scales_per_octave=cfg.RETINANET.SCALES_PER_OCTAVE,
        anchor_scale=float(cfg.RETINANET.ANCHOR_SCALE),
        num_convs=cfg.RETINANET.NUM_CONVS,
        prior_prob=cfg.RETINANET.PRIOR_PROB,
        share_cls_bbox_tower=cfg.RETINANET.SHARE_CLS_BBOX_TOWER,
        class_specific_bbox=cfg.RETINANET.CLASS_SPECIFIC_BBOX,
        softmax=cfg.RETINANET.SOFTMAX,
        compute_dtype=cfg.COMPUTE_DTYPE,
        remat=cfg.REMAT_BACKBONE,
        s2d_stem=cfg.S2D_STEM,
        fold_affine=cfg.FOLD_AFFINE,
    )
