"""The Detectron custom ops of the single-scale R-CNN family (ref:
sad_tpu/ops/detectron_ops.py; detectron's caffe2 ops they transcribe).

- ``roi_align``: single-map RoIAlign (roi_align_op.cu:40-160). It is the
  port's multilevel RoIAlign with one level, log2(1 / spatial_scale), and
  every roi at that level, so on the card it is the CUDA forward and backward
  of csrc/roi_align.cu and on the CPU their plain twin (ops/roi_align.py).
  Every roi is pooled, as sad_tpu's tent-matmul form pools them: no valid
  mask. sad_tpu computes this op outside Pallas; the port's one-level call
  and it are two transcriptions of the same Detectron op.
- ``ps_roi_pool``: R-FCN's position-sensitive average pooling
  (ps_roi_pool_op.cu), in plain PyTorch with autograd for the gradient
  (sad_tpu computes it outside Pallas too): bin (ph, pw) averages channel
  group ph * k + pw of the score maps, channel (ph * k + pw) * C_out + c, over
  the bin's window of cells; the roi corners are rounded half to even
  (``torch.round``, as ``jnp.round``) and the end corner is round(x + 1); the
  bin size is the roi's extent times float32(1 / k), as XLA compiles
  sad_tpu's ``roi / k`` (the reference divides; ROADMAP.md Queue 3), and a
  bin edge p * bin + start is rounded once, as a fused multiply-add.
  Each roi's windows are gathered at most ceil(H / k) + 1 by ceil(W / k) + 1
  cells, in chunks of rois so that a chunk's gathered values stay under
  ``_PS_CHUNK_ELEMS`` (sad_tpu's ``roi_chunk`` does the same).
- the OHEM trio (smooth_l1_loss_OHEM_op, softmax_with_loss_OHEM_op,
  box_annotator_ohem_op): per-roi losses without reduction, and the selection
  of the hardest rois as 0 / 1 weights. Ranks come from a stable double
  argsort, as sad_tpu's ``jnp.argsort`` (stable) gives them, so ties keep the
  lower index.

These three take NHWC features, as the port's R-CNN heads hold them, and
(R, 5) rois [batch, x1, y1, x2, y2].

The rest of the library (sad_tpu/ops/detectron_ops.py:191-257, :338-345,
:430-512) takes NCHW maps, Caffe2's layout and PyTorch's, where sad_tpu's
take NHWC: no path of sad_tpu or the port calls them (ROI_XFORM_METHOD stays
RoIAlign), they are the op library for users of Detectron's ops. Plain
PyTorch with autograd, as sad_tpu's are plain JAX:

- ``roi_pool``: RoIPoolF max pooling (roi_pool_f_op.cu:36-95): roi corners
  times the scale rounded half to even, extents + 1 (at least 1), bin edges
  floor(p * bin) and ceil((p + 1) * bin) from the roi's corner, clipped to
  the map, an empty bin 0; the bin size is the extent times float32(1 /
  res), as XLA compiles sad_tpu's division. The gradient goes to each
  bin's maximum, the first in row-major order among equal ones (the
  reference's argmax; JAX splits a tie's gradient).
- ``group_spatial_softmax`` (group_spatial_softmax_op.cu): a softmax over
  each anchor's C classes of the A * C channels.
- ``sigmoid_cross_entropy_loss`` (sigmoid_cross_entropy_loss_op.cu:29-66):
  the stable BCE summed over the targets that are not -1, over their count
  clamped to 1.
- ``batch_permutation``, ``sample_as`` (the static form: the first
  ``max_out`` rows with a label > 0 in order, and their valid mask),
  ``spatial_narrow_as``, ``spatial_l2_loss`` (0.5 * scale * the mean
  squared difference), ``spatial_sigmoid``, ``affine_channel`` (no gradient
  to the scale and bias, as affine_channel_op.cc:70-80), ``upsample_nearest``
  and ``zero_even`` (the reference's tutorial op).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from .roi_align import multilevel_roi_align

FLT_MIN = 1.1754944e-38
# gathered values of one chunk of ps_roi_pool or roi_pool: 64 Mi elements, 256 MiB in float32
_PS_CHUNK_ELEMS = 1 << 26


def roi_align_level(spatial_scale: float) -> int:
    """The level l with spatial_scale = 1 / 2^l; other scales raise."""
    lvl = int(round(-math.log2(spatial_scale)))
    if 2.0 ** -lvl != float(spatial_scale):
        raise ValueError(f"roi_align: spatial scale {spatial_scale} is not 1 / 2^l")
    return lvl


def roi_align(features: torch.Tensor, rois: torch.Tensor, spatial_scale: float,
              resolution: int, sampling_ratio: int = 2) -> torch.Tensor:
    """RoIAlign of every (R, 5) roi from one (B, H, W, C) map: (R, res, res,
    C) in the map's dtype, differentiable with respect to the map. A
    sampling_ratio of 0 (the reference's adaptive grid) is refused, as
    sad_tpu asserts against it."""
    if sampling_ratio <= 0:
        raise NotImplementedError(
            "ROI_XFORM_SAMPLING_RATIO 0 (Detectron's adaptive grid): sad_tpu requires a fixed "
            "ratio > 0 (ROADMAP.md Queue 3)")
    lvl = roi_align_level(spatial_scale)
    r = rois.shape[0]
    levels = torch.full((r,), lvl, dtype=torch.int32, device=rois.device)
    every = torch.ones((r,), dtype=torch.bool, device=rois.device)
    return multilevel_roi_align({lvl: features}, rois, levels, every, resolution,
                                sampling_ratio)


def _ps_chunk(fflat, rois, scale, k, h, w, mbh, mbw):
    """ps_roi_pool of one chunk of rois over the flattened (B*H*W*k*k, C)
    maps."""
    dev = rois.device
    bi = rois[:, 0].long()
    x1 = torch.round(rois[:, 1]) * scale
    y1 = torch.round(rois[:, 2]) * scale
    x2 = torch.round(rois[:, 3] + 1.0) * scale
    y2 = torch.round(rois[:, 4] + 1.0) * scale
    roi_w = torch.clamp_min(x2 - x1, 0.1)
    roi_h = torch.clamp_min(y2 - y1, 0.1)
    # sad_tpu's roi / k is compiled by XLA as roi * float32(1 / k); an IEEE
    # division (Detectron's) moves a bin edge that falls on an integer
    inv_k = torch.tensor(1.0 / k, dtype=torch.float32, device=dev)
    bin_h, bin_w = roi_h * inv_k, roi_w * inv_k
    p = torch.arange(k, dtype=torch.float32, device=dev)[None, :]

    def fma(q, bin_sz, start):
        # q * bin + start rounded once, as XLA's fused multiply-add (and nvcc's,
        # in the reference's kernel) rounds it: the product is exact in float64
        return (q.double() * bin_sz.double()[:, None] + start.double()[:, None]).float()

    def edges(start, bin_sz, n):
        lo = torch.floor(fma(p, bin_sz, start)).long().clamp(0, n)
        hi = torch.ceil(fma(p + 1.0, bin_sz, start)).long().clamp(0, n)
        return lo, hi

    hstart, hend = edges(y1, bin_h, h)
    wstart, wend = edges(x1, bin_w, w)
    hs = hstart[:, :, None] + torch.arange(mbh, device=dev)  # (rc, k, mbh)
    ws = wstart[:, :, None] + torch.arange(mbw, device=dev)  # (rc, k, mbw)
    hvalid, wvalid = hs < hend[:, :, None], ws < wend[:, :, None]
    hs, ws = hs.clamp(0, h - 1), ws.clamp(0, w - 1)
    g = torch.arange(k * k, device=dev).view(1, k, k, 1, 1)  # channel group ph * k + pw
    cell = (bi[:, None, None] * h + hs)[:, :, None, :, None] * w + ws[:, None, :, None, :]
    vals = fflat[cell * (k * k) + g]  # (rc, k, k, mbh, mbw, C)
    m = hvalid[:, :, None, :, None] & wvalid[:, None, :, None, :]
    s = torch.where(m[..., None], vals, 0.0).sum(dim=(3, 4))
    cnt = torch.clamp_min(m.sum(dim=(3, 4)), 1).to(s.dtype)
    return s / cnt[..., None]


def ps_roi_pool(features: torch.Tensor, rois: torch.Tensor, spatial_scale: float,
                resolution: int, output_dim: int) -> torch.Tensor:
    """Position-sensitive RoI average pooling of (B, H, W, k*k*C_out) score
    maps: (R, k, k, C_out) in the maps' dtype."""
    b, h, w, d = features.shape
    k = int(resolution)
    if d != k * k * output_dim:
        raise ValueError(f"ps_roi_pool: {d} channels != {k}^2 x {output_dim}")
    fflat = features.reshape(b * h * w * k * k, output_dim)
    mbh, mbw = -(-h // k) + 1, -(-w // k) + 1
    rois = rois.detach().float()
    per_roi = k * k * mbh * mbw * (output_dim + 2)  # values, index and mask
    rc = max(1, _PS_CHUNK_ELEMS // per_roi)
    outs = [_ps_chunk(fflat, rois[i:i + rc], float(spatial_scale), k, h, w, mbh, mbw)
            for i in range(0, rois.shape[0], rc)]
    return torch.cat(outs) if outs else features.new_zeros((0, k, k, output_dim))


def softmax_with_loss_ohem(logits: torch.Tensor, labels: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-roi softmax cross-entropy without reduction: (loss (R,), probs
    (R, C)); rois labelled below 0 get 0."""
    p = torch.softmax(logits.float(), dim=-1)
    t = labels.long().clamp_min(0)
    p_label = torch.gather(p, 1, t[:, None])[:, 0]
    loss = torch.where(labels >= 0, -torch.log(torch.clamp_min(p_label, FLT_MIN)), 0.0)
    return loss, p


def smooth_l1_loss_per_roi(y_hat, y, inside_weights, outside_weights, beta: float = 1.0
                           ) -> torch.Tensor:
    """Per-roi smooth-L1 without reduction: (R,)."""
    d = inside_weights * (y_hat.float() - y.float())
    ad = d.abs()
    huber = torch.where(ad < beta, 0.5 * d * d / beta, ad - 0.5 * beta)
    return (outside_weights * huber).sum(dim=-1)


def ohem_keep(total: torch.Tensor, k: int) -> torch.Tensor:
    """0 / 1 float weights keeping the ``k`` largest entries of each row of
    ``total`` (a 1-D tensor is one row); ties go to the lower index. (sad_tpu
    also tests ``total >= the k-th largest``, which a rank under k implies.)"""
    rank = torch.argsort(torch.argsort(-total, dim=-1, stable=True), dim=-1, stable=True)
    return (rank < k).float()


def box_annotator_ohem(cls_loss: torch.Tensor, bbox_loss: torch.Tensor, labels: torch.Tensor,
                       roi_per_img: int) -> torch.Tensor:
    """The hardest ``roi_per_img`` rois by cls + bbox loss as 0 / 1 weights
    (box_annotator_ohem_op.cu's selection; weights in place of its label
    surgery). ``labels`` is taken for the reference's signature only."""
    del labels
    total = cls_loss + bbox_loss
    return ohem_keep(total, min(roi_per_img, total.shape[0]))


# --------------------------------------------------------------------------- #
# The rest of the op library, NCHW
# --------------------------------------------------------------------------- #


def _roi_pool_chunk(features, rois, scale, res, mbh, mbw):
    """roi_pool of one chunk of rois: (rc, C, res, res)."""
    b, c, h, w = features.shape
    dev = rois.device
    bi = rois[:, 0].long()
    x1, y1, x2, y2 = (torch.round(rois[:, i] * scale).long() for i in range(1, 5))
    inv = torch.tensor(1.0 / res, dtype=torch.float32, device=dev)
    bin_w = torch.clamp_min(x2 - x1 + 1, 1).float() * inv
    bin_h = torch.clamp_min(y2 - y1 + 1, 1).float() * inv
    p = torch.arange(res, dtype=torch.float32, device=dev)[None, :]

    def edges(start, bin_sz, n):
        lo = torch.floor(p * bin_sz[:, None]).long() + start[:, None]
        hi = torch.ceil((p + 1.0) * bin_sz[:, None]).long() + start[:, None]
        return lo.clamp(0, n), hi.clamp(0, n)

    hstart, hend = edges(y1, bin_h, h)
    wstart, wend = edges(x1, bin_w, w)
    hs = hstart[:, :, None] + torch.arange(mbh, device=dev)  # (rc, res, mbh)
    ws = wstart[:, :, None] + torch.arange(mbw, device=dev)  # (rc, res, mbw)
    hvalid, wvalid = hs < hend[:, :, None], ws < wend[:, :, None]
    hs, ws = hs.clamp(0, h - 1), ws.clamp(0, w - 1)
    # (rc, res, mbh, res, mbw, C): the advanced indices first, C last
    vals = features[bi[:, None, None, None, None], :, hs[:, :, :, None, None],
                    ws[:, None, None, :, :]]
    m = hvalid[:, :, :, None, None] & wvalid[:, None, None, :, :]
    vals = torch.where(m[..., None], vals, float("-inf"))
    # each bin's window in row-major order: max takes the first of equal maxima
    win = vals.permute(0, 5, 1, 3, 2, 4).reshape(rois.shape[0], c, res, res, mbh * mbw)
    out = win.max(dim=-1).values
    return torch.where(torch.isfinite(out), out, 0.0)


def roi_pool(features: torch.Tensor, rois: torch.Tensor, spatial_scale: float,
             resolution: int) -> torch.Tensor:
    """RoIPoolF max pooling of every (R, 5) roi from a (B, C, H, W) map:
    (R, C, res, res) in the map's dtype, differentiable with respect to the
    map."""
    b, c, h, w = features.shape
    res = int(resolution)
    mbh, mbw = -(-h // res) + 1, -(-w // res) + 1
    rois = rois.detach().float()
    rc = max(1, _PS_CHUNK_ELEMS // (res * res * mbh * mbw * (c + 2)))
    outs = [_roi_pool_chunk(features, rois[i:i + rc], float(spatial_scale), res, mbh, mbw)
            for i in range(0, rois.shape[0], rc)]
    return torch.cat(outs) if outs else features.new_zeros((0, c, res, res))


def group_spatial_softmax(logits: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Softmax over each anchor's classes of (N, A * C, H, W) logits."""
    n, ac = logits.shape[:2]
    grouped = logits.reshape(n, ac // num_classes, num_classes, *logits.shape[2:])
    return torch.softmax(grouped, dim=2).reshape(logits.shape)


def sigmoid_cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                               scale: float = 1.0) -> torch.Tensor:
    """Mean stable BCE over the elements whose target is not -1 (the count
    clamped to 1), times ``scale``, in float32."""
    x, t = logits.float(), targets.float()
    valid = (targets != -1).float()
    ge = (x >= 0).float()
    losses = (-x * (t - ge) + torch.log(1.0 + torch.exp(x - 2.0 * x * ge))) * valid
    return scale * losses.sum() / torch.clamp_min(valid.sum(), 1.0)


def batch_permutation(x: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """x reordered along dim 0 (FPN's roi unshuffle)."""
    return x[indices.long()]


def sample_as(x: torch.Tensor, labels: torch.Tensor, max_out: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rows of x whose label is > 0, in order, in a static shape:
    (x_selected (min(max_out, N), ...), valid); rows past the count are 0
    and invalid."""
    fg = labels > 0
    idx = torch.argsort((~fg).to(torch.uint8), stable=True)[:max_out]
    valid = fg[idx]
    out = torch.where(valid.view((-1,) + (1,) * (x.dim() - 1)), x[idx], 0)
    return out, valid


def spatial_narrow_as(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """x's height and width cut to ``like``'s (NCHW)."""
    return x[:, :, :like.shape[2], :like.shape[3]]


def spatial_l2_loss(x: torch.Tensor, y: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """0.5 * scale * the mean squared difference, in float32."""
    d = x.float() - y.float()
    return scale * 0.5 * (d * d).mean()


def spatial_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def affine_channel(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """x * s + b per channel of an (N, C, ...) map; s and b take no gradient."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return x * scale.detach().view(shape) + bias.detach().view(shape)


def upsample_nearest(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsample of an (N, C, H, W) map by an integer factor."""
    n, c, h, w = x.shape
    x = x[:, :, :, None, :, None].expand(n, c, h, scale, w, scale)
    return x.reshape(n, c, h * scale, w * scale)


def zero_even(x: torch.Tensor) -> torch.Tensor:
    """x with its even-indexed entries along dim 0 set to 0."""
    even = torch.arange(x.shape[0], device=x.device) % 2 == 0
    return torch.where(even.view((-1,) + (1,) * (x.dim() - 1)), 0, x)
