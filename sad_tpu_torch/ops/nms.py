"""Greedy NMS with static shapes (ref: sad_tpu/ops/nms.py).

At each of ``max_out`` steps, pick the highest-scoring live box (the first
index among equal maxima), emit it, and suppress everything over the IoU
threshold against it, the pick included. That is the greedy keep sequence
truncated to ``max_out``, which is all RetinaNet decode needs.

Class-wise NMS uses the coordinate-offset trick: boxes of different classes
are moved apart by a per-problem span, so they never suppress each other.

Dispatch is by tensor device: CUDA tensors go to the hand-written kernel
(ops/nms_kernel.py, csrc/nms.cu), CPU tensors to ``nms_multi_plain`` below.
There is no flag and no fallback between them. The dispatch is the custom
op ``sad_tpu_torch::nms_multi`` (``torch.library.custom_op``): its CUDA
implementation is ``nms_kernel.nms_cuda``, its CPU one ``nms_multi_plain``,
and its fake implementation gives the (N, max_out) int32 / bool outputs
without running either. So ``torch.export`` (eval/export.py) records one op
node where it would otherwise unroll the plain loop's max_out steps, or
fail on the kernel's ctypes call, and a program reloaded with
``torch.export.load`` launches the kernel on the card. Soft-NMS (TTA only)
is the host's g++ ``native.soft_nms`` (eval/test_augmentation.py).
"""

from __future__ import annotations

from typing import Tuple

import torch

# invalid candidates carry this score (sad_tpu's NEG_INF, a float32 -1e30)
NEG_INF = -1e30


def nms_multi_plain(
    boxes: torch.Tensor,  # (N, K, 4)
    scores: torch.Tensor,  # (N, K); invalid carry NEG_INF
    iou_threshold: float,
    max_out: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the kernel: a loop of max_out steps over
    (N, K) tensors, with the kernel's arithmetic in the kernel's order."""
    boxes = boxes.float()
    live = scores.float().clone()
    n, k = live.shape
    x1, y1, x2, y2 = boxes.unbind(-1)
    areas = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    rows = torch.arange(n, device=live.device)
    lanes = torch.arange(k, device=live.device)
    out_idx = torch.zeros((n, max_out), dtype=torch.int32, device=live.device)
    out_valid = torch.zeros((n, max_out), dtype=torch.bool, device=live.device)
    if k == 0:
        return out_idx, out_valid
    for i in range(max_out):
        pick = torch.argmax(live, dim=1)  # first maximum
        valid = live[rows, pick] > NEG_INF
        px1, py1 = x1[rows, pick, None], y1[rows, pick, None]
        px2, py2 = x2[rows, pick, None], y2[rows, pick, None]
        parea = (px2 - px1 + 1.0) * (py2 - py1 + 1.0)
        iw = torch.clamp(torch.minimum(px2, x2) - torch.maximum(px1, x1) + 1.0, min=0.0)
        ih = torch.clamp(torch.minimum(py2, y2) - torch.maximum(py1, y1) + 1.0, min=0.0)
        inter = iw * ih
        iou = inter / (parea + areas - inter)
        suppress = (iou > iou_threshold) | (lanes[None, :] == pick[:, None])
        live = torch.where(valid[:, None] & suppress, NEG_INF, live)
        out_idx[:, i] = torch.where(valid, pick, 0).to(torch.int32)
        out_valid[:, i] = valid
    return out_idx, out_valid


@torch.library.custom_op("sad_tpu_torch::nms_multi", mutates_args=())
def _nms_multi_op(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
                  max_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    raise ValueError(f"nms has no path for device {boxes.device}")


@_nms_multi_op.register_kernel("cuda")
def _nms_multi_cuda(boxes, scores, iou_threshold, max_out):
    from . import nms_kernel

    return nms_kernel.nms_cuda(boxes, scores, iou_threshold, max_out)


@_nms_multi_op.register_kernel("cpu")
def _nms_multi_cpu(boxes, scores, iou_threshold, max_out):
    return nms_multi_plain(boxes, scores, iou_threshold, max_out)


@_nms_multi_op.register_fake
def _nms_multi_fake(boxes, scores, iou_threshold, max_out):
    n = scores.shape[0]
    return (scores.new_empty((n, max_out), dtype=torch.int32),
            scores.new_empty((n, max_out), dtype=torch.bool))


def nms_multi(
    boxes: torch.Tensor,  # (N, K, 4)
    masked_scores: torch.Tensor,  # (N, K); invalid carry NEG_INF
    iou_threshold: float,
    max_out: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain (classless) greedy NMS over N independent problems, through the
    custom op ``sad_tpu_torch::nms_multi``."""
    if boxes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"nms has no path for device {boxes.device}")
    return torch.ops.sad_tpu_torch.nms_multi(
        boxes.float().contiguous(), masked_scores.float().contiguous(),
        float(iou_threshold), int(max_out))


def nms_fixed(boxes, scores, iou_threshold: float, max_out: int):
    """One problem: boxes (K, 4), scores (K,) -> (idx (max_out,), valid)."""
    idx, valid = nms_multi(boxes[None], scores[None], iou_threshold, max_out)
    return idx[0], valid[0]


def offset_by_class(boxes, scores, classes, valid):
    """Shift each class by a per-problem span so classes never overlap
    (sad_tpu nms.py:143-150); invalid candidates get NEG_INF scores."""
    extent = torch.where(valid, boxes[..., 2:4].amax(dim=-1), 0.0)
    span = extent.amax(dim=-1, keepdim=True) + 1.0  # (N, 1)
    shifted = boxes + (classes.float() * span)[..., None]
    return shifted, torch.where(valid, scores, NEG_INF)


def batched_nms_multi(
    boxes: torch.Tensor,  # (N, K, 4)
    scores: torch.Tensor,  # (N, K)
    classes: torch.Tensor,  # (N, K) int
    valid: torch.Tensor,  # (N, K) bool
    iou_threshold: float,
    max_out: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class-wise NMS over N independent problems in one call."""
    shifted, masked = offset_by_class(boxes.float(), scores.float(), classes, valid)
    return nms_multi(shifted, masked, iou_threshold, max_out)


def batched_nms(boxes, scores, classes, valid, iou_threshold: float, max_out: int):
    """Class-wise NMS of one problem: (K, 4), (K,), (K,), (K,)."""
    idx, keep = batched_nms_multi(boxes[None], scores[None], classes[None],
                                  valid[None], iou_threshold, max_out)
    return idx[0], keep[0]
