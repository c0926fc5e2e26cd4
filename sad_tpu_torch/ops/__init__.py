"""Tensor ops of the serving slice and their CUDA kernels.

The Detectron op library of ``detectron_ops`` (sad_tpu/ops/__init__.py:17-29)
is exported here, but for its one-level ``roi_align``: ``sad_tpu_torch.ops.
roi_align`` is the multilevel RoIAlign module, so that op stays
``detectron_ops.roi_align``."""

from .detectron_ops import (
    affine_channel, batch_permutation, box_annotator_ohem, group_spatial_softmax,
    ps_roi_pool, roi_pool, sample_as, sigmoid_cross_entropy_loss, smooth_l1_loss_per_roi,
    softmax_with_loss_ohem, spatial_l2_loss, spatial_narrow_as, spatial_sigmoid,
    upsample_nearest, zero_even,
)
from .losses import softmax_focal_loss

__all__ = [
    "affine_channel", "batch_permutation", "box_annotator_ohem", "group_spatial_softmax",
    "ps_roi_pool", "roi_pool", "sample_as", "sigmoid_cross_entropy_loss",
    "smooth_l1_loss_per_roi", "softmax_focal_loss", "softmax_with_loss_ohem",
    "spatial_l2_loss", "spatial_narrow_as", "spatial_sigmoid", "upsample_nearest",
    "zero_even",
]
