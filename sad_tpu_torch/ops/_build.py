"""Build the port's CUDA sources into one shared library, at first use.

``nvcc`` compiles every ``sad_tpu_torch/csrc/*.cu`` for Hopper (sm_90a), one
process per source, all started together, and links the objects into one
shared library with a plain C interface, loaded with ctypes. The library
lands in ``sad_tpu_torch/_build/`` (listed in .gitignore) under a name that
carries the hash of the sources and flags, so an edit rebuilds and an
unchanged tree reuses the library. A missing ``nvcc`` or a failed build
raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + [
    "-std=c++17", "-O3", "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC",
]


class BuildError(RuntimeError):
    pass


class _Library:
    """The loaded library and what its build reported (ptxas output and the
    build time), kept for the process."""

    def __init__(self):
        self.lib: Optional[ctypes.CDLL] = None
        self.path: Optional[Path] = None
        self.build_seconds = 0.0
        self.cached = False
        self.log = ""


_LIB = _Library()


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise BuildError("nvcc not found (PATH, $CUDA_HOME/bin); the CUDA kernels "
                     "of sad_tpu_torch are built from source and need it")


def _sources():
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise BuildError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources() + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def load_library() -> _Library:
    """Build (if needed) and load the kernels' library; the handle is
    kept for the process."""
    if _LIB.lib is not None:
        return _LIB
    out = BUILD_DIR / f"libsad_tpu_torch_{source_hash()}.so"
    t0 = time.perf_counter()
    if out.exists():
        _LIB.cached = True
    else:
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{out.stem}.{os.getpid()}"
        objs, procs = [], []
        for src in _sources():
            obj = BUILD_DIR / f"{tag}.{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
            objs.append(obj)
        logs = []
        for cmd, proc in procs:
            logs.append(proc.communicate()[0])
            if proc.returncode != 0:
                for _, other in procs:
                    other.kill()
                    other.wait()
                raise BuildError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{logs[-1]}")
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        _LIB.log = "".join(logs) + proc.stdout + proc.stderr
        for obj in objs:
            obj.unlink()
        if proc.returncode != 0:
            raise BuildError(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n{_LIB.log}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    _LIB.lib = ctypes.CDLL(str(out))
    _LIB.path = out
    _LIB.build_seconds = time.perf_counter() - t0
    return _LIB
