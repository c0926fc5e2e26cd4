"""ctypes wrappers of the multilevel RoIAlign CUDA kernels, forward and
backward (sad_tpu_torch/csrc/roi_align.cu).

They replace the Pallas kernels ``_mlra_kernel`` (launched by
``_windowed_forward``) and ``_mlra_bwd_kernel`` (``_windowed_backward``) of
sad_tpu/ops/pallas_roi_align.py. Callers go through
sad_tpu_torch/ops/roi_align.py, which sends CUDA tensors here and CPU
tensors to the plain twins.

``launches`` and ``bwd_launches`` count the launches of the forward and the
backward kernel made by this process, so that a run can show that its main
path went through them.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from . import _build

launches = 0
bwd_launches = 0

MAX_LEVELS = 8  # kMaxLevels in the source
_DTYPES = {torch.float32: (0, 4), torch.bfloat16: (1, 8)}  # code, 16-byte vector width

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _I, _I, _P, _P, _P, _P] + [_I] * 7 + [_P]
_BWD_ARGTYPES = ([_P, _P, _P, _I, _I, _P, _P, _P, _P, _P, ctypes.c_longlong] + [_I] * 7 + [_P])
BWD_TILE = 8  # kBwdTile in the source: the backward's map tiles are 8 x 8 cells
BWD_MAX_RES = 32  # kMaxBwdRes in the source


def _fn():
    fn = _build.load_library().lib.sad_roi_align_fwd_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _bwd_fn():
    fn = _build.load_library().lib.sad_roi_align_bwd_launch
    if fn.argtypes is None:
        fn.argtypes = _BWD_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def roi_align_fwd_cuda(
    features: Sequence[torch.Tensor],  # consecutive levels, each (B, H_l, W_l, C) contiguous
    lvl_min: int,  # the FPN level of features[0]
    rois: torch.Tensor,  # (R, 5) float32 [batch, x1, y1, x2, y2]
    roi_levels: torch.Tensor,  # (R,) int32
    valid: torch.Tensor,  # (R,) bool
    resolution: int,
    sampling_ratio: int,
) -> torch.Tensor:
    """(R, res, res, C) in the features' dtype, one launch; raises on
    anything the kernel does not take."""
    global launches
    feats = list(features)
    if not 1 <= len(feats) <= MAX_LEVELS:
        raise ValueError(f"roi_align_fwd_cuda takes 1..{MAX_LEVELS} levels, got {len(feats)}")
    dev, dtype = feats[0].device, feats[0].dtype
    tensors = feats + [rois, roi_levels, valid]
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("roi_align_fwd_cuda needs features, rois, levels and valid on one "
                         "CUDA device")
    if dtype not in _DTYPES or any(f.dtype != dtype for f in feats):
        raise TypeError(f"roi_align_fwd_cuda takes float32 or bfloat16 features of one type, "
                        f"got {[f.dtype for f in feats]}")
    if (rois.dtype, roi_levels.dtype, valid.dtype) != (torch.float32, torch.int32, torch.bool):
        raise TypeError(f"roi_align_fwd_cuda takes float32 rois, int32 levels and bool valid, "
                        f"got {rois.dtype}/{roi_levels.dtype}/{valid.dtype}")
    b, c = feats[0].shape[0], feats[0].shape[-1]
    if any(f.dim() != 4 or f.shape[0] != b or f.shape[3] != c or 0 in f.shape for f in feats):
        raise ValueError(f"roi_align_fwd_cuda features: {[tuple(f.shape) for f in feats]}; "
                         "want non-empty (B, H_l, W_l, C) with one B and one C")
    r = rois.shape[0]
    if rois.dim() != 2 or rois.shape[1] != 5 or roi_levels.shape != (r,) or valid.shape != (r,):
        raise ValueError(f"roi_align_fwd_cuda shapes: rois {tuple(rois.shape)}, levels "
                         f"{tuple(roi_levels.shape)}, valid {tuple(valid.shape)}; want (R,5), "
                         "(R,), (R,)")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("roi_align_fwd_cuda takes contiguous tensors")
    res, sr = int(resolution), int(sampling_ratio)
    if res < 1 or sr < 1 or lvl_min < 0 or r * res >= 2**31 or any(
            f.numel() >= 2**31 * c for f in feats):
        raise ValueError(f"roi_align_fwd_cuda: unsupported sizes R={r} res={res} sr={sr} "
                         f"lvl_min={lvl_min}")
    out = torch.empty((r, res, res, c), dtype=dtype, device=dev)
    if r == 0:  # nothing to launch, and nothing to count
        return out
    code, width = _DTYPES[dtype]
    vec = int(c % width == 0 and all(t.data_ptr() % 16 == 0 for t in feats + [out]))
    n = len(feats)
    ptrs = (ctypes.c_void_p * n)(*[f.data_ptr() for f in feats])
    hs = (ctypes.c_int * n)(*[f.shape[1] for f in feats])
    ws = (ctypes.c_int * n)(*[f.shape[2] for f in feats])
    fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ctypes.cast(ptrs, _P), ctypes.cast(hs, _P), ctypes.cast(ws, _P), n, int(lvl_min),
                 rois.data_ptr(), roi_levels.data_ptr(), valid.data_ptr(), out.data_ptr(),
                 r, b, c, res, sr, code, vec, stream)
    if err != 0:
        raise RuntimeError(f"roi_align kernel launch failed: cudaError_t {err}")
    launches += 1
    return out


def roi_align_bwd_cuda(
    grad_out: torch.Tensor,  # (R, res, res, C) cotangent, float32 or bfloat16, contiguous
    level_hw: Sequence[Tuple[int, int]],  # (H_l, W_l) of the consecutive levels
    lvl_min: int,  # the FPN level of level_hw[0]
    batch: int,
    rois: torch.Tensor,  # (R, 5) float32
    roi_levels: torch.Tensor,  # (R,) int32
    valid: torch.Tensor,  # (R,) bool
    sampling_ratio: int,
) -> List[torch.Tensor]:
    """The gradients of the feature maps, one (B, H_l, W_l, C) tensor a
    level in ``grad_out``'s dtype, views of one allocation that the kernels
    write whole: the rois are binned onto 8 x 8 map tiles and one block a
    (tile, channel slice) gathers and writes its cells once. Raises on
    anything the kernels do not take."""
    global bwd_launches
    dims = [(int(h), int(w)) for h, w in level_hw]
    if not 1 <= len(dims) <= MAX_LEVELS:
        raise ValueError(f"roi_align_bwd_cuda takes 1..{MAX_LEVELS} levels, got {len(dims)}")
    dev, dtype = grad_out.device, grad_out.dtype
    tensors = [grad_out, rois, roi_levels, valid]
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("roi_align_bwd_cuda needs the cotangent, rois, levels and valid on "
                         "one CUDA device")
    if dtype not in _DTYPES:
        raise TypeError(f"roi_align_bwd_cuda takes a float32 or bfloat16 cotangent, got {dtype}")
    if (rois.dtype, roi_levels.dtype, valid.dtype) != (torch.float32, torch.int32, torch.bool):
        raise TypeError(f"roi_align_bwd_cuda takes float32 rois, int32 levels and bool valid, "
                        f"got {rois.dtype}/{roi_levels.dtype}/{valid.dtype}")
    if grad_out.dim() != 4 or grad_out.shape[1] != grad_out.shape[2] or grad_out.shape[3] < 1:
        raise ValueError(f"roi_align_bwd_cuda cotangent {tuple(grad_out.shape)}; want "
                         "(R, res, res, C)")
    r, res, _, c = grad_out.shape
    if rois.shape != (r, 5) or roi_levels.shape != (r,) or valid.shape != (r,):
        raise ValueError(f"roi_align_bwd_cuda shapes: rois {tuple(rois.shape)}, levels "
                         f"{tuple(roi_levels.shape)}, valid {tuple(valid.shape)}; want ({r},5), "
                         f"({r},), ({r},)")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("roi_align_bwd_cuda takes contiguous tensors")
    b, sr = int(batch), int(sampling_ratio)
    sizes = [b * h * w * c for h, w in dims]
    tiles = [-(-h // BWD_TILE) * -(-w // BWD_TILE) for h, w in dims]  # a level's tiles an image
    n_tiles = b * sum(tiles)
    scratch_ints = 3 * n_tiles + 1 + r * max(tiles)
    if res < 1 or res > BWD_MAX_RES or sr < 1 or b < 1 or lvl_min < 0 or r * res >= 2**31 or any(
            h < 1 or w < 1 or n >= 2**31 * c for (h, w), n in zip(dims, sizes)) or (
            scratch_ints >= 2**31):
        raise ValueError(f"roi_align_bwd_cuda: unsupported sizes R={r} res={res} sr={sr} "
                         f"B={b} lvl_min={lvl_min} levels={dims}")
    flat = torch.empty(sum(sizes), dtype=dtype, device=dev)
    grads = [g.view(b, h, w, c) for g, (h, w) in zip(torch.split(flat, sizes), dims)]
    if r == 0:  # nothing to launch, and nothing to count
        flat.zero_()
        return grads
    scratch = torch.empty(scratch_ints, dtype=torch.int32, device=dev)
    code, _ = _DTYPES[dtype]
    # with C a multiple of 4 every level starts a multiple of 16 bytes into the allocation
    vec = int(c % 4 == 0 and grad_out.data_ptr() % 16 == 0 and flat.data_ptr() % 16 == 0)
    n = len(dims)
    ptrs = (ctypes.c_void_p * n)(*[g.data_ptr() for g in grads])
    hs = (ctypes.c_int * n)(*[h for h, _ in dims])
    ws = (ctypes.c_int * n)(*[w for _, w in dims])
    fn = _bwd_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ctypes.cast(ptrs, _P), ctypes.cast(hs, _P), ctypes.cast(ws, _P), n, int(lvl_min),
                 rois.data_ptr(), roi_levels.data_ptr(), valid.data_ptr(), grad_out.data_ptr(),
                 scratch.data_ptr(), scratch_ints, r, b, c, res, sr, code, vec, stream)
    if err != 0:
        raise RuntimeError(f"roi_align backward kernel launch failed: cudaError_t {err}")
    bwd_launches += 1
    return grads
