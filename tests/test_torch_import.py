"""sad_tpu_torch imports no jax, and asks for the card or raises: no silent
fallback from CUDA to the CPU."""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from sad_tpu_torch.device import get_device
from sad_tpu_torch.ops import _build, nms_kernel
from sad_tpu_torch.ops.nms import nms_multi

REPO = Path(__file__).resolve().parent.parent


def test_package_imports_no_jax():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import sad_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(sad_tpu_torch.__path__, "sad_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        assert len(names) >= 15, names
        leaked = [m for m in ("jax", "jaxlib", "flax") if m in sys.modules]
        assert not leaked, leaked
        print("OK", len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK")


def test_chip_smoke_main_path_imports_no_sad_tpu():
    """The modules chip_smoke.py drives import no jax, and of sad_tpu only its
    jax-free host modules (config and anchors), none of its JAX code."""
    code = textwrap.dedent("""
        import sys
        import sad_tpu_torch.eval.inference, sad_tpu_torch.models
        import sad_tpu_torch.ops.nms_kernel, sad_tpu_torch.device
        import sad_tpu_torch.tools.profile_infer
        host = {"sad_tpu", "sad_tpu.config", "sad_tpu.config.config",
                "sad_tpu.config.catalog", "sad_tpu.data", "sad_tpu.data.anchors",
                "sad_tpu.data.dataset", "sad_tpu.data.minibatch"}
        leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax")
                  or (m.split(".")[0] == "sad_tpu" and m not in host)]
        assert not leaked, leaked
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr


def test_device_helper_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the host without one")
    with pytest.raises(RuntimeError, match="does not fall back"):
        get_device("cuda")
    assert get_device("cpu").type == "cpu"


def test_cuda_wrapper_refuses_cpu_tensors():
    boxes = torch.zeros((1, 8, 4))
    scores = torch.zeros((1, 8))
    before = nms_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        nms_kernel.nms_cuda(boxes, scores, 0.5, 4)
    assert nms_kernel.launches == before


def test_nms_dispatch_has_no_path_for_other_devices():
    with pytest.raises(ValueError, match="no path"):
        nms_multi(torch.zeros((1, 8, 4), device="meta"), torch.zeros((1, 8), device="meta"),
                  0.5, 4)


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    with pytest.raises(_build.BuildError, match="nvcc not found"):
        _build.find_nvcc()


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a card, chip_smoke.py exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
