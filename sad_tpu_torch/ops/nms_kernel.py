"""ctypes wrapper of the greedy-NMS CUDA kernels (sad_tpu_torch/csrc/nms.cu):
order (compact and sort), IoU bitmask and sweep; and, for the problems with
more valid candidates than the order stage holds, run sort, merge and a
sweep against the kept boxes.

Replaces the Pallas kernels ``_nms_kernel`` and ``_nms_kernel_batched`` of
sad_tpu/ops/pallas_nms.py. Callers go through sad_tpu_torch/ops/nms.py,
which sends CUDA tensors here and CPU tensors to the plain version.

``launches`` counts the calls that launched the kernels, one per call, so
that a run can show that its main path went through them.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from . import _build

launches = 0

# kOrderCap in the source, the valid candidates a problem the order stage
# sorts; the launch refuses a scratch sized from another cap
ORDER_CAP = 8192
# kRun in the source: the input slots a block of the over-cap run sort takes
RUN = 4096
_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]


def _fn():
    lib = _build.load_library().lib
    fn = lib.sad_nms_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def scratch_plan(n: int, k: int) -> Tuple[List[Tuple[str, int, int]], int]:
    """The kernels' scratch in one allocation: ([(name, offset, bytes)], total
    bytes), each part 16-byte aligned. The sorted path's parts are sized from
    cap = min(K, ORDER_CAP); the over-cap stages' parts exist only where K >
    ORDER_CAP (only then can a problem hold more valid candidates than the
    sort) and grow linearly in K."""
    cap = min(k, ORDER_CAP)
    words = -(-cap // 64)
    sizes = [("sorted_idx", n * cap * 4), ("sorted_box", n * cap * 16),
             ("mask", n * cap * words * 8), ("removed", n * ORDER_CAP // 8),
             ("state", 3 * n * 4)]  # (count, keeps, done)
    if k > ORDER_CAP:
        sizes += [("run_keys", n * k * 8), ("run_count", n * -(-k // RUN) * 4),
                  ("over_idx", n * k * 4), ("over_box", n * k * 16)]
    plan, at = [], 0
    for name, size in sizes:
        plan.append((name, at, size))
        at += -(-size // 16) * 16
    return plan, at


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
    plan, total = scratch_plan(n, k)
    with torch.cuda.device(dev):
        idx = torch.empty((n, max_out), dtype=torch.int32, device=dev)
        valid = torch.empty((n, max_out), dtype=torch.bool, device=dev)
        scratch = torch.empty(total, dtype=torch.uint8, device=dev)
        at = {name: scratch.data_ptr() + offset for name, offset, _ in plan}
        over = [at.get(name, 0) for name in ("run_keys", "run_count", "over_idx", "over_box")]
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(boxes.data_ptr(), scores.data_ptr(), at["sorted_idx"], at["sorted_box"],
                 at["mask"], at["removed"], at["state"], *over, idx.data_ptr(),
                 valid.data_ptr(), n, k, min(k, ORDER_CAP), max_out, float(iou_threshold),
                 stream)
    if err != 0:
        raise RuntimeError(f"nms kernel launch failed: cudaError_t {err}")
    launches += 1
    return idx, valid
