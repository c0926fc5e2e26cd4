"""ctypes wrappers of the classification-loss CUDA kernels
(sad_tpu_torch/csrc/cls_losses.cu).

Replace the Pallas kernels ``_fwd_kernel``/``_fwd_kernel_aligned`` (launched
by ``_raw_fwd_impl``) and ``_bwd_kernel``/``_bwd_kernel_aligned`` (launched by
``_raw_bwd``) of sad_tpu/ops/pallas_losses.py. Callers go through
sad_tpu_torch/ops/fused_losses.py, which sends CUDA tensors here and CPU
tensors to the plain twin.

``fwd_launches`` and ``bwd_launches`` count the launches made by this
process, so that a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build

fwd_launches = 0
bwd_launches = 0

_WARPS_PER_BLOCK = 8  # kWarps in the source: one row per warp
_TARGET_BLOCKS = 132 * 8 * 2  # 132 SMs x 8 resident 256-thread blocks x 2 waves

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_FWD_ARGTYPES = [_P] * 5 + [_I, _L, _I, _I] + [_F] * 6 + [_I] * 5 + [_P]
_BWD_ARGTYPES = [_P] * 6 + [_I, _L, _I, _I] + [_F] * 5 + [_I] * 4 + [_P]


class ClsLossParams(NamedTuple):
    """The static arguments of fused_cls_losses_raw (pallas_losses.py:388-401)."""

    gamma_f: float
    alpha_f: float
    gamma_d: float
    alpha_d: float
    beta_d: float
    ignored_label: int
    logits_power: float
    want_powsum: bool


def int_gamma(gamma: float) -> int:
    """gamma as an int when _ipow_or_pow multiplies (an integer in 0..4),
    else -1 (powf)."""
    g = float(gamma)
    return int(g) if g == int(g) and 0 <= int(g) <= 4 else -1


def _fn(name, argtypes):
    fn = getattr(_build.load_library().lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _check(x, pt, labels, n_groups):
    if not (x.is_cuda and pt.is_cuda and labels.is_cuda) or not (
            x.device == pt.device == labels.device):
        raise ValueError("the cls-loss kernels need x, pt and labels on one CUDA device")
    if x.dtype != torch.float32 or pt.dtype != torch.float32 or labels.dtype != torch.int32:
        raise TypeError(f"the cls-loss kernels take float32 x/pt and int32 labels, got "
                        f"{x.dtype}/{pt.dtype}/{labels.dtype}")
    if x.dim() != 2 or pt.shape != x.shape or labels.shape != x.shape[:1]:
        raise ValueError(f"cls-loss kernel shapes: x {tuple(x.shape)}, pt {tuple(pt.shape)}, "
                         f"labels {tuple(labels.shape)}; want (M, C), (M, C), (M,)")
    if not (x.is_contiguous() and pt.is_contiguous() and labels.is_contiguous()):
        raise ValueError("the cls-loss kernels take contiguous tensors")
    m = x.shape[0]
    if n_groups < 1 or m % n_groups or n_groups > 65535:
        raise ValueError(f"rows {m} are not divisible into {n_groups} groups (1..65535)")
    return m // n_groups


def _blocks_per_group(rows_per_group: int, n_groups: int) -> int:
    by_rows = -(-rows_per_group // _WARPS_PER_BLOCK)
    return max(1, min(by_rows, -(-_TARGET_BLOCKS // n_groups)))


def cls_losses_fwd(x: torch.Tensor, pt: torch.Tensor, labels: torch.Tensor, n_groups: int,
                   p: ClsLossParams) -> torch.Tensor:
    """(G, 3) float32 per-group (focal_raw, distill_raw, powsum) of the (M, C)
    logits x, teacher probs pt and (M,) int32 labels; powsum is 0 when not
    wanted. Raises on anything the kernel does not take."""
    global fwd_launches
    rpg = _check(x, pt, labels, n_groups)
    bpg = _blocks_per_group(rpg, n_groups)
    fn = _fn("sad_cls_losses_fwd", _FWD_ARGTYPES)
    with torch.cuda.device(x.device):
        out = torch.empty((n_groups, 3), dtype=torch.float32, device=x.device)
        partial = torch.empty((n_groups, bpg, 3), dtype=torch.float64, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), pt.data_ptr(), labels.data_ptr(), partial.data_ptr(),
                 out.data_ptr(), n_groups, rpg, x.shape[1], bpg,
                 p.gamma_f, p.alpha_f, p.gamma_d, p.alpha_d, p.beta_d, p.logits_power,
                 int_gamma(p.gamma_f), int_gamma(p.gamma_d), int_gamma(p.gamma_d - 1.0),
                 p.ignored_label, int(bool(p.want_powsum)), stream)
    if err != 0:
        raise RuntimeError(f"cls-loss forward kernel launch failed: cudaError_t {err}")
    fwd_launches += 1
    return out


def cls_losses_bwd(x: torch.Tensor, pt: torch.Tensor, labels: torch.Tensor,
                   g_focal: torch.Tensor, g_distill: torch.Tensor,
                   p: ClsLossParams) -> torch.Tensor:
    """dx (M, C) float32 of focal_raw . g_focal + distill_raw . g_distill,
    with the published backwards; g_focal and g_distill are (G,) float32."""
    global bwd_launches
    n_groups = g_focal.shape[0] if g_focal.dim() == 1 else -1
    rpg = _check(x, pt, labels, n_groups)
    gf = g_focal.to(x.device, torch.float32).contiguous()
    gd = g_distill.to(x.device, torch.float32).contiguous()
    if gd.shape != gf.shape:
        raise ValueError(f"g_focal {tuple(gf.shape)} and g_distill {tuple(gd.shape)} differ")
    bpg = _blocks_per_group(rpg, n_groups)
    fn = _fn("sad_cls_losses_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(x.device):
        dx = torch.empty_like(x)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), pt.data_ptr(), labels.data_ptr(), gf.data_ptr(), gd.data_ptr(),
                 dx.data_ptr(), n_groups, rpg, x.shape[1], bpg,
                 p.gamma_f, p.alpha_f, p.gamma_d, p.alpha_d, p.beta_d,
                 int_gamma(p.gamma_f), int_gamma(p.gamma_d), int_gamma(p.gamma_d - 1.0),
                 p.ignored_label, stream)
    if err != 0:
        raise RuntimeError(f"cls-loss backward kernel launch failed: cudaError_t {err}")
    bwd_launches += 1
    return dx
