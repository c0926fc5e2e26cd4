"""ctypes wrapper of the greedy-NMS CUDA kernels (sad_tpu_torch/csrc/nms.cu):
order (compact and sort), IoU bitmask, sweep, and the argmax loop for the
problems with more valid candidates than the order stage holds.

Replaces the Pallas kernels ``_nms_kernel`` and ``_nms_kernel_batched`` of
sad_tpu/ops/pallas_nms.py. Callers go through sad_tpu_torch/ops/nms.py,
which sends CUDA tensors here and CPU tensors to the plain version.

``launches`` counts the calls that launched the kernels, one per call, so
that a run can show that its main path went through them.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

launches = 0

# kOrderCap in the source, the valid candidates a problem the sort holds; the
# launch refuses a scratch sized from another cap
ORDER_CAP = 8192
_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]


def _fn():
    lib = _build.load_library().lib
    fn = lib.sad_nms_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def nms_cuda(
    boxes: torch.Tensor,  # (N, K, 4) float32, CUDA, contiguous
    scores: torch.Tensor,  # (N, K) float32; invalid candidates carry -1e30
    iou_threshold: float,
    max_out: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """N independent greedy-NMS problems in one launch. Returns (idx (N,
    max_out) int32, valid (N, max_out) bool); raises on anything the kernel
    does not take."""
    global launches
    if not (boxes.is_cuda and scores.is_cuda) or boxes.device != scores.device:
        raise ValueError("nms_cuda needs boxes and scores on one CUDA device")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"nms_cuda takes float32, got {boxes.dtype}/{scores.dtype}")
    if boxes.dim() != 3 or boxes.shape[2] != 4 or scores.shape != boxes.shape[:2]:
        raise ValueError(f"nms_cuda shapes: boxes {tuple(boxes.shape)}, "
                         f"scores {tuple(scores.shape)}; want (N,K,4) and (N,K)")
    if not (boxes.is_contiguous() and scores.is_contiguous()):
        raise ValueError("nms_cuda takes contiguous tensors")
    if boxes.data_ptr() % 16:
        raise ValueError("nms_cuda reads boxes as float4: data must be 16-byte aligned")
    n, k = scores.shape
    if max_out < 0 or k >= 2**31 - 1 or n >= 2**31:
        raise ValueError(f"nms_cuda: unsupported sizes N={n} K={k} max_out={max_out}")
    if n == 0 or max_out == 0:  # nothing to launch, and nothing to count
        return (torch.zeros((n, max_out), dtype=torch.int32, device=boxes.device),
                torch.zeros((n, max_out), dtype=torch.bool, device=boxes.device))
    fn = _fn()
    dev = boxes.device
    cap = min(k, ORDER_CAP)
    words = -(-cap // 64)
    # scratch, in one allocation, sized from min(K, ORDER_CAP) on the host: the
    # argmax loop's live scores, the order stage's sorted indices and boxes,
    # the mask, the sweep's removed words and its (count, keeps, done) state
    parts = [n * k * 4, n * cap * 4, n * cap * 16, n * cap * words * 8, n * ORDER_CAP // 8,
             3 * n * 4]
    starts = [0]
    for size in parts[:-1]:
        starts.append(starts[-1] + -(-size // 16) * 16)
    with torch.cuda.device(dev):
        idx = torch.empty((n, max_out), dtype=torch.int32, device=dev)
        valid = torch.empty((n, max_out), dtype=torch.bool, device=dev)
        scratch = torch.empty(starts[-1] + parts[-1], dtype=torch.uint8, device=dev)
        base = scratch.data_ptr()
        live, sorted_idx, sorted_box, mask, removed, state = (base + o for o in starts)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(boxes.data_ptr(), scores.data_ptr(), live, sorted_idx, sorted_box, mask, removed,
                 state, idx.data_ptr(), valid.data_ptr(), n, k, cap, max_out,
                 float(iou_threshold), stream)
    if err != 0:
        raise RuntimeError(f"nms kernel launch failed: cudaError_t {err}")
    launches += 1
    return idx, valid
