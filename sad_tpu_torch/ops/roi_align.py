"""Multilevel RoIAlign: each roi is pooled from its own FPN level (ref:
sad_tpu/ops/proposals.py multilevel_roi_align and the windowed Pallas kernel
of sad_tpu/ops/pallas_roi_align.py; Detectron's roi_align_op.cu:89-160).

For a roi [batch, x1, y1, x2, y2] on level l, with scale = 1 / 2^l: the
corners are scaled without rounding, a bin is max(extent, 1) / res wide, and
each bin is the mean of sr x sr bilinear samples at
``start + p * bin + (i + 0.5) * (bin / sr)``. A sample below -1 or above n
contributes nothing, otherwise it is clamped to [0, n - 1] and weighs the two
cells around it by max(0, 1 - |s - cell|). Sums are float32 whatever the
feature dtype; the result has the feature dtype; invalid rois give zeros.
Levels outside the given ones and batch indices outside the batch are
clamped into range. The batch column of the rois is always read (sad_tpu's
``slots_per_im`` shortcut, which ignores it, is a TPU matter).

Dispatch is by tensor device: CUDA tensors go to the hand-written kernels
(ops/roi_align_kernel.py, csrc/roi_align.cu), CPU tensors to
``multilevel_roi_align_plain`` below. There is no flag and no fallback
between them. The result is differentiable with respect to the feature maps
and not to the rois (sad_tpu stops the gradient there too): on the card the
backward is the gather kernel, one call per RoIAlign call, which bins the
rois onto map tiles and writes each cell once in the feature dtype; on the
CPU autograd differentiates the plain forward. ``multilevel_roi_align_bwd_plain``
is the scatter written out in PyTorch, the version the kernel is held
against (within a tolerance: the two add the same terms in other orders).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def _level_list(features: Dict[int, torch.Tensor]) -> Tuple[int, List[torch.Tensor]]:
    lvls = sorted(features)
    if not lvls or lvls != list(range(lvls[0], lvls[-1] + 1)):
        raise ValueError(f"RoIAlign needs consecutive FPN levels, got {lvls}")
    return lvls[0], [features[l] for l in lvls]


def _axis_taps(start: torch.Tensor, bin_sz: torch.Tensor, n: torch.Tensor, res: int, sr: int):
    """The res * sr samples of one axis for every roi: (lo, hi) cell indices
    (R, res, sr) int64 and their weights, already divided by sr and zero for
    a sample outside [-1, n]. ``n`` is the (R,) float size of the axis."""
    dev = start.device
    p = torch.arange(res, dtype=torch.float32, device=dev)[None, :, None]
    i = torch.arange(sr, dtype=torch.float32, device=dev)[None, None, :]
    start, bin_sz, n = start[:, None, None], bin_sz[:, None, None], n[:, None, None]
    # tensor / tensor is an IEEE division, as in the kernel; tensor / number
    # multiplies by the rounded reciprocal on CUDA, and one ulp of a sample
    # position near 300 moves a tap weight by 3e-5
    s = start + p * bin_sz + (i + 0.5) * (bin_sz / torch.full_like(bin_sz, float(sr)))
    inside = (s >= -1.0) & (s <= n)
    s_eff = torch.minimum(torch.clamp(s, min=0.0), n - 1.0)
    lo = torch.floor(s_eff)
    has_hi = lo + 1.0 <= n - 1.0
    scale = inside.float() * (1.0 / sr)
    w_lo = (1.0 - (s_eff - lo)) * scale
    w_hi = torch.where(has_hi, (1.0 - ((lo + 1.0) - s_eff)) * scale, 0.0)
    hi = torch.where(has_hi, lo + 1.0, lo)
    return lo.long(), hi.long(), w_lo, w_hi


def roi_geometry(dims: List[Tuple[int, int]], lvl_min: int, batch: int, rois: torch.Tensor,
                 roi_levels: torch.Tensor, res: int, sr: int):
    """What the kernel derives per roi, as tensors: the level's position in
    ``dims`` (R,), the batch index (R,), the level's (h, w) as int64 (R,)
    each, and the y and x taps of ``_axis_taps``."""
    dev = rois.device
    li = (roi_levels.long() - lvl_min).clamp(0, len(dims) - 1)
    hw = torch.tensor(dims, dtype=torch.int64, device=dev)[li]  # (R, 2)
    h, w = hw[:, 0], hw[:, 1]
    scale = 1.0 / torch.pow(2.0, (li + lvl_min).float())
    rois = rois.float()
    b = rois[:, 0].long().clamp(0, batch - 1)
    x1, y1, x2, y2 = (rois[:, k] * scale for k in range(1, 5))
    res_t = torch.full_like(x1, float(res))  # see _axis_taps on tensor / tensor
    bin_w = torch.clamp(x2 - x1, min=1.0) / res_t
    bin_h = torch.clamp(y2 - y1, min=1.0) / res_t
    ytaps = _axis_taps(y1, bin_h, h.float(), res, sr)
    xtaps = _axis_taps(x1, bin_w, w.float(), res, sr)
    return li, b, h, w, ytaps, xtaps


def multilevel_roi_align_plain(
    features: Dict[int, torch.Tensor],  # {level: (B, H_l, W_l, C)}
    rois: torch.Tensor,  # (R, 5) [batch, x1, y1, x2, y2]
    roi_levels: torch.Tensor,  # (R,) absolute FPN level
    valid: torch.Tensor,  # (R,) bool
    resolution: int,
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """The plain PyTorch version of the kernel: per sample and tap, one
    gather of (R, res, res, C) rows from the levels laid end to end, with the
    kernel's arithmetic in the kernel's order."""
    lvl_min, feats = _level_list(features)
    res, sr = int(resolution), int(sampling_ratio)
    batch, c = feats[0].shape[0], feats[0].shape[-1]
    dims = [(f.shape[1], f.shape[2]) for f in feats]
    li, b, h, w, (ylo, yhi, wylo, wyhi), (xlo, xhi, wxlo, wxhi) = roi_geometry(
        dims, lvl_min, batch, rois, roi_levels, res, sr)
    flat = torch.cat([f.reshape(-1, c) for f in feats])
    sizes = [batch * hh * ww for hh, ww in dims]
    bases = torch.tensor([sum(sizes[:k]) for k in range(len(sizes))],
                         dtype=torch.int64, device=rois.device)
    base = (bases[li] + b * h * w)[:, None, None]  # first cell of the roi's map
    w_ = w[:, None, None]
    acc = torch.zeros((rois.shape[0], res, res, c), dtype=torch.float32, device=rois.device)
    for i in range(sr):
        for j in range(sr):
            for yi, wy in ((ylo[:, :, i], wylo[:, :, i]), (yhi[:, :, i], wyhi[:, :, i])):
                for xi, wx in ((xlo[:, :, j], wxlo[:, :, j]), (xhi[:, :, j], wxhi[:, :, j])):
                    idx = base + yi[:, :, None] * w_ + xi[:, None, :]  # (R, res, res)
                    wt = wy[:, :, None] * wx[:, None, :]
                    acc = acc + flat[idx].float() * wt[..., None]
    acc = torch.where(valid[:, None, None, None], acc, 0.0)
    return acc.to(feats[0].dtype)


def multilevel_roi_align_bwd_plain(
    grad_out: torch.Tensor,  # (R, res, res, C) cotangent
    level_hw: Dict[int, Tuple[int, int]],  # {level: (H_l, W_l)}
    batch: int,
    rois: torch.Tensor,  # (R, 5)
    roi_levels: torch.Tensor,  # (R,)
    valid: torch.Tensor,  # (R,) bool
    sampling_ratio: int = 2,
) -> Dict[int, torch.Tensor]:
    """The plain PyTorch version of the backward kernel: the gradient of
    ``multilevel_roi_align_plain`` with respect to each feature map, {level:
    (B, H_l, W_l, C)} in ``grad_out``'s dtype. Per sample and tap one
    ``index_add_`` of the weighted cotangent into float32 maps laid end to
    end, in a fixed order, and one cast at the end. Invalid rois add
    nothing."""
    lvls = sorted(level_hw)
    if not lvls or lvls != list(range(lvls[0], lvls[-1] + 1)):
        raise ValueError(f"RoIAlign needs consecutive FPN levels, got {lvls}")
    lvl_min, dims = lvls[0], [tuple(level_hw[l]) for l in lvls]
    r, res, _, c = grad_out.shape
    sr, dev = int(sampling_ratio), grad_out.device
    li, b, h, w, (ylo, yhi, wylo, wyhi), (xlo, xhi, wxlo, wxhi) = roi_geometry(
        dims, lvl_min, batch, rois, roi_levels, res, sr)
    sizes = [batch * hh * ww for hh, ww in dims]
    bases = torch.tensor([sum(sizes[:k]) for k in range(len(sizes))],
                         dtype=torch.int64, device=dev)
    base = (bases[li] + b * h * w)[:, None, None]
    w_ = w[:, None, None]
    g = torch.where(valid.to(torch.bool)[:, None, None, None], grad_out.float(), 0.0)
    g = g.reshape(-1, c)
    flat = torch.zeros((sum(sizes), c), dtype=torch.float32, device=dev)
    for i in range(sr):
        for j in range(sr):
            for yi, wy in ((ylo[:, :, i], wylo[:, :, i]), (yhi[:, :, i], wyhi[:, :, i])):
                for xi, wx in ((xlo[:, :, j], wxlo[:, :, j]), (xhi[:, :, j], wxhi[:, :, j])):
                    idx = base + yi[:, :, None] * w_ + xi[:, None, :]
                    wt = wy[:, :, None] * wx[:, None, :]
                    flat.index_add_(0, idx.reshape(-1), g * wt.reshape(-1, 1))
    flat = flat.to(grad_out.dtype)
    return {l: part.view(batch, hh, ww, c)
            for l, part, (hh, ww) in zip(lvls, torch.split(flat, sizes), dims)}


class _RoIAlignOnCard(torch.autograd.Function):
    """The forward kernel and, for the feature maps, the backward kernel."""

    @staticmethod
    def forward(ctx, lvl_min, rois, roi_levels, valid, res, sr, *feats):
        from . import roi_align_kernel

        ctx.save_for_backward(rois, roi_levels, valid)
        ctx.geometry = (lvl_min, sr, feats[0].shape[0], [tuple(f.shape[1:3]) for f in feats],
                        feats[0].dtype)
        return roi_align_kernel.roi_align_fwd_cuda(feats, lvl_min, rois, roi_levels, valid,
                                                   res, sr)

    @staticmethod
    def backward(ctx, grad):
        from . import roi_align_kernel

        rois, roi_levels, valid = ctx.saved_tensors
        lvl_min, sr, batch, dims, dtype = ctx.geometry
        # autograd hands over views and, under mixed precision, other dtypes
        grads = roi_align_kernel.roi_align_bwd_cuda(
            grad.to(dtype).contiguous(), dims, lvl_min, batch, rois, roi_levels, valid, sr)
        return (None,) * 6 + tuple(grads)


def multilevel_roi_align(
    features: Dict[int, torch.Tensor],  # {level: (B, H_l, W_l, C)}
    rois: torch.Tensor,  # (R, 5) [batch, x1, y1, x2, y2]
    roi_levels: torch.Tensor,  # (R,)
    valid: torch.Tensor,  # (R,)
    resolution: int,
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """RoIAlign each roi from its FPN level; rois keep their order. Returns
    (R, res, res, C) in the features' dtype, differentiable with respect to
    the feature maps. No gradient reaches the rois."""
    rois = rois.detach()
    dev = rois.device
    if dev.type == "cuda":
        lvl_min, feats = _level_list(features)
        return _RoIAlignOnCard.apply(
            lvl_min, rois.float().contiguous(), roi_levels.to(torch.int32).contiguous(),
            valid.to(torch.bool).contiguous(), int(resolution), int(sampling_ratio),
            *(f.contiguous() for f in feats))
    if dev.type != "cpu":
        raise ValueError(f"multilevel_roi_align has no path for device {dev}")
    return multilevel_roi_align_plain(features, rois, roi_levels, valid.to(torch.bool),
                                      resolution, sampling_ratio)
