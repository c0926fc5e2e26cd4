"""The port's native host kernels: box IoU, the fused anchor->gt assignment
pass, greedy NMS and soft-NMS (a copy of sad_tpu/native, the reference's
cython_bbox / cython_nms), bound with ctypes.

``g++ -O3 -march=native -ffp-contract=off`` (sad_tpu's flags) compiles
``host_kernels.cpp`` at first use into ``sad_tpu_torch/_build/`` (listed in
.gitignore), under a name that carries the hash of the source, the flags and
the host's CPU (``-march=native`` code runs only where it was built). One
process builds under a file lock; the others (the loader's spawned workers)
wait for it and load the same file. There is no fallback: a missing ``g++``
or a failed build raises ``NativeBuildError``, since a float64 numpy pass
would assign other labels at ties (``plain.py`` holds the float32 twin that
the tests compare with).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = Path(__file__).resolve().parent / "host_kernels.cpp"
BUILD_DIR = PKG_DIR / "_build"
GXX_FLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None


class NativeBuildError(RuntimeError):
    pass


def _cpu_signature() -> bytes:
    """The CPU's model and feature flags, which -march=native compiles for."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name", "flags"))][:2]
    except OSError:
        lines = []
    return ("".join(lines) or platform.processor() or platform.machine()).encode()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    h.update(_cpu_signature())
    return BUILD_DIR / f"libsad_host_kernels_{h.hexdigest()[:16]}.so"


def _build() -> Path:
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise NativeBuildError("g++ not found on PATH; sad_tpu_torch's label assignment "
                               f"is built from {SOURCE} and needs it")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "host_kernels.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes, or the process dies
        if not out.exists():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [gxx, *GXX_FLAGS, "-o", str(tmp), str(SOURCE)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise NativeBuildError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                                       f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    f32, i64 = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64)
    lib.sad_bbox_overlaps.restype = None
    lib.sad_bbox_overlaps.argtypes = [f32, ctypes.c_int64, f32, ctypes.c_int64, f32]
    lib.sad_assign_overlaps.restype = None
    lib.sad_assign_overlaps.argtypes = [
        f32, ctypes.c_int64, f32, ctypes.c_int64, f32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8)]
    lib.sad_nms.restype = ctypes.c_int64
    lib.sad_nms.argtypes = [f32, ctypes.c_int64, ctypes.c_float, i64]
    lib.sad_soft_nms.restype = ctypes.c_int64
    lib.sad_soft_nms.argtypes = [f32, ctypes.c_int64, ctypes.c_float, ctypes.c_float,
                                 ctypes.c_float, ctypes.c_int32, i64]
    return lib


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; the handle is kept for the
    process."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(_build())))
    return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _boxes(a: np.ndarray, width: int) -> np.ndarray:
    a = np.ascontiguousarray(a, np.float32)
    if a.ndim != 2 or a.shape[1] != width:
        raise ValueError(f"expected an (N, {width}) array, got shape {a.shape}")
    return a


def bbox_overlaps(boxes: np.ndarray, query: np.ndarray) -> np.ndarray:
    """(N, K) float32 IoU matrix, legacy +1 convention (ref: cython_bbox.pyx)."""
    boxes, query = _boxes(boxes, 4), _boxes(query, 4)
    out = np.empty((len(boxes), len(query)), np.float32)
    load().sad_bbox_overlaps(_ptr(boxes, ctypes.c_float), len(boxes),
                             _ptr(query, ctypes.c_float), len(query),
                             _ptr(out, ctypes.c_float))
    return out


def assign_overlaps(anchors: np.ndarray, gt: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The fused anchor->gt pass in float32: (a2g_max, a2g_argmax, tie_mask),
    the per-anchor max IoU, its first argmax, and whether the anchor ties
    some gt's best overlap (ref: cython_bbox overlaps + the numpy reductions
    of roi_data/retinanet.py:198-250)."""
    anchors, gt = _boxes(anchors, 4), _boxes(gt, 4)
    n = len(anchors)
    a2g_max = np.empty((n,), np.float32)
    a2g_argmax = np.empty((n,), np.int32)
    tie = np.empty((n,), np.uint8)
    load().sad_assign_overlaps(_ptr(anchors, ctypes.c_float), n, _ptr(gt, ctypes.c_float),
                               len(gt), _ptr(a2g_max, ctypes.c_float),
                               _ptr(a2g_argmax, ctypes.c_int32), _ptr(tie, ctypes.c_uint8))
    return a2g_max, a2g_argmax.astype(np.int64), tie.astype(bool)


def nms(dets: np.ndarray, thresh: float) -> np.ndarray:
    """Greedy NMS keep indices over (N, 5) [x1, y1, x2, y2, score] (ref:
    cython_nms.pyx nms)."""
    dets = _boxes(dets, 5)
    keep = np.empty((len(dets),), np.int64)
    if len(dets) == 0:
        return keep
    cnt = load().sad_nms(_ptr(dets, ctypes.c_float), len(dets), thresh,
                         _ptr(keep, ctypes.c_int64))
    return keep[:cnt].copy()


def soft_nms(dets: np.ndarray, sigma: float = 0.5, overlap_thresh: float = 0.3,
             score_thresh: float = 0.001, method: str = "linear"
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Soft-NMS: (the rescored dets in pick order, keep indices) (ref:
    cython_nms.pyx soft_nms)."""
    methods = {"hard": 0, "linear": 1, "gaussian": 2}
    if method not in methods:
        raise ValueError(f"soft_nms method must be one of {sorted(methods)}, got {method!r}")
    dets = _boxes(dets, 5).copy()
    keep = np.empty((len(dets),), np.int64)
    if len(dets) == 0:
        return dets, keep
    cnt = load().sad_soft_nms(_ptr(dets, ctypes.c_float), len(dets), sigma, overlap_thresh,
                              score_thresh, methods[method], _ptr(keep, ctypes.c_int64))
    keep = keep[:cnt].copy()
    return dets[keep], keep
