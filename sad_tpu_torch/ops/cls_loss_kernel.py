"""ctypes wrappers of the classification-loss CUDA kernels
(sad_tpu_torch/csrc/cls_losses.cu).

Replace the Pallas kernels ``_fwd_kernel``/``_fwd_kernel_aligned`` (launched
by ``_raw_fwd_impl``) and ``_bwd_kernel``/``_bwd_kernel_aligned`` (launched by
``_raw_bwd``) of sad_tpu/ops/pallas_losses.py. Callers go through
sad_tpu_torch/ops/fused_losses.py, which sends CUDA tensors here and CPU
tensors to the plain twin.

``fwd_launches`` and ``bwd_launches`` count the launches made by this
process, so that a run can show that its main path went through the kernels;
``fwd_by_rows`` and ``bwd_by_rows`` tally the same launches by the row count
M of x, which tells the FPN levels of a step apart.

The wrapper picks the kernels' instance (``kernel_instance``): 16-byte
chunks when C % 4 == 0 and x and pt are 16-byte aligned, else scalar
elements; the gamma-2 arithmetic (integer gammas 2 and 2, beta_d 0, a
PowSum power of at least 1) with PowSum on or off, else the generic one. Every
instance partitions a group's elements the same way (``launch_geometry``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build

fwd_launches = 0
bwd_launches = 0
fwd_by_rows: dict = {}
bwd_by_rows: dict = {}

THREADS = 256  # kThreads in the source
ELEMS_PER_THREAD = 16  # kElems: a thread's elements an iteration
GAMMA2_POW, GAMMA2_NOPOW, GENERIC = 0, 1, 2  # the source's instances (spec)
# two waves of 8 resident 256-thread blocks on 132 SMs: blocks that start as
# others finish measured faster than one wave of looping blocks (PERF.md)
TARGET_BLOCKS = 132 * 8 * 2

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_FWD_ARGTYPES = [_P] * 5 + [_I] * 6 + [_F] * 6 + [_I] * 5 + [_P]
_BWD_ARGTYPES = [_P] * 6 + [_I] * 6 + [_F] * 5 + [_I] * 4 + [_P]


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
    m, c = x.shape
    if n_groups < 1 or m % n_groups or n_groups > 65535:
        raise ValueError(f"rows {m} are not divisible into {n_groups} groups (1..65535)")
    if c < 1 or (m // n_groups) * c >= 2**31:
        raise ValueError(f"a group of {m // n_groups} rows x {c} columns: the kernels index "
                         f"a group's elements with 31 bits and need C >= 1")
    return m // n_groups


def kernel_instance(c: int, x_ptr: int, pt_ptr: int, p: ClsLossParams):
    """(vec, spec) of the kernels for C columns and the data pointers of x
    and pt: vec 4 (16-byte chunks) or 1, spec GAMMA2_POW, GAMMA2_NOPOW or
    GENERIC. The backward takes the gamma-2 instance for either gamma-2 spec."""
    vec = 4 if c % 4 == 0 and x_ptr % 16 == 0 and pt_ptr % 16 == 0 else 1
    gamma2 = (int_gamma(p.gamma_f) == 2 and int_gamma(p.gamma_d) == 2 and p.beta_d == 0.0)
    if not gamma2 or (p.want_powsum and not p.logits_power >= 1.0):
        return vec, GENERIC
    return vec, GAMMA2_POW if p.want_powsum else GAMMA2_NOPOW


def launch_geometry(rows_per_group: int, n_groups: int, c: int) -> int:
    """Blocks a group. A block takes THREADS * ELEMS_PER_THREAD elements an
    iteration; the G groups share TARGET_BLOCKS, and a group's iterations
    are spread evenly over its blocks."""
    tiles = -(-rows_per_group * c // (THREADS * ELEMS_PER_THREAD))
    iters = -(-tiles // max(1, TARGET_BLOCKS // n_groups))
    return -(-tiles // iters)


def cls_losses_fwd(x: torch.Tensor, pt: torch.Tensor, labels: torch.Tensor, n_groups: int,
                   p: ClsLossParams) -> torch.Tensor:
    """(G, 3) float32 per-group (focal_raw, distill_raw, powsum) of the (M, C)
    logits x, teacher probs pt and (M,) int32 labels; powsum is 0 when not
    wanted. Raises on anything the kernel does not take."""
    _check(x, pt, labels, n_groups)
    return _launch_fwd(x, pt, labels, n_groups, p,
                       *kernel_instance(x.shape[1], x.data_ptr(), pt.data_ptr(), p))


def _launch_fwd(x, pt, labels, n_groups: int, p: ClsLossParams, vec: int, spec: int):
    """The forward through the instance (vec, spec), on checked tensors; the
    library refuses vec 4 for a C or a pointer it does not take. Besides
    cls_losses_fwd, tools/profile_cls_losses.py calls it to time each
    instance."""
    global fwd_launches
    rpg, c = x.shape[0] // n_groups, x.shape[1]
    bpg = launch_geometry(rpg, n_groups, c)
    fn = _fn("sad_cls_losses_fwd", _FWD_ARGTYPES)
    with torch.cuda.device(x.device):
        out = torch.empty((n_groups, 3), dtype=torch.float32, device=x.device)
        partial = torch.empty((n_groups, bpg, 3), dtype=torch.float64, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), pt.data_ptr(), labels.data_ptr(), partial.data_ptr(),
                 out.data_ptr(), n_groups, rpg, c, bpg, vec, spec,
                 p.gamma_f, p.alpha_f, p.gamma_d, p.alpha_d, p.beta_d, p.logits_power,
                 int_gamma(p.gamma_f), int_gamma(p.gamma_d), int_gamma(p.gamma_d - 1.0),
                 p.ignored_label, int(bool(p.want_powsum)), stream)
    if err != 0:
        raise RuntimeError(f"cls-loss forward kernel launch failed: cudaError_t {err}")
    fwd_launches += 1
    fwd_by_rows[x.shape[0]] = fwd_by_rows.get(x.shape[0], 0) + 1
    return out


def cls_losses_bwd(x: torch.Tensor, pt: torch.Tensor, labels: torch.Tensor,
                   g_focal: torch.Tensor, g_distill: torch.Tensor,
                   p: ClsLossParams) -> torch.Tensor:
    """dx (M, C) float32 of focal_raw . g_focal + distill_raw . g_distill,
    with the published backwards; g_focal and g_distill are (G,) float32."""
    n_groups = g_focal.shape[0] if g_focal.dim() == 1 else -1
    _check(x, pt, labels, n_groups)
    gf = g_focal.to(x.device, torch.float32).contiguous()
    gd = g_distill.to(x.device, torch.float32).contiguous()
    if gd.shape != gf.shape:
        raise ValueError(f"g_focal {tuple(gf.shape)} and g_distill {tuple(gd.shape)} differ")
    return _launch_bwd(x, pt, labels, gf, gd, p,
                       *kernel_instance(x.shape[1], x.data_ptr(), pt.data_ptr(), p))


def _launch_bwd(x, pt, labels, gf, gd, p: ClsLossParams, vec: int, spec: int):
    """The backward through the instance (vec, spec), on checked tensors and
    (G,) float32 cotangents; dx is a fresh, 16-byte aligned allocation."""
    global bwd_launches
    n_groups = gf.shape[0]
    rpg, c = x.shape[0] // n_groups, x.shape[1]
    bpg = launch_geometry(rpg, n_groups, c)
    fn = _fn("sad_cls_losses_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(x.device):
        dx = torch.empty_like(x)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), pt.data_ptr(), labels.data_ptr(), gf.data_ptr(), gd.data_ptr(),
                 dx.data_ptr(), n_groups, rpg, c, bpg, vec, spec,
                 p.gamma_f, p.alpha_f, p.gamma_d, p.alpha_d, p.beta_d,
                 int_gamma(p.gamma_f), int_gamma(p.gamma_d), int_gamma(p.gamma_d - 1.0),
                 p.ignored_label, stream)
    if err != 0:
        raise RuntimeError(f"cls-loss backward kernel launch failed: cudaError_t {err}")
    bwd_launches += 1
    bwd_by_rows[x.shape[0]] = bwd_by_rows.get(x.shape[0], 0) + 1
    return dx
