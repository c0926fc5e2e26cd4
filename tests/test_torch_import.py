"""sad_tpu_torch imports no jax, and asks for the card or raises: no silent
fallback from CUDA to the CPU."""

import ast
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
    """The modules chip_smoke.py drives, serving and training, import no jax
    and no module of sad_tpu at all, not even its jax-free host modules:
    the port keeps its own copies (the allow-list is empty)."""
    code = textwrap.dedent("""
        import sys
        import sad_tpu_torch.eval.inference, sad_tpu_torch.models
        import sad_tpu_torch.ops.nms_kernel, sad_tpu_torch.device
        import sad_tpu_torch.ops.cls_loss_kernel, sad_tpu_torch.ops.fused_losses
        import sad_tpu_torch.ops.losses, sad_tpu_torch.train, sad_tpu_torch.config
        import sad_tpu_torch.data.minibatch, sad_tpu_torch.data.dataset
        import sad_tpu_torch.tools.profile_infer, sad_tpu_torch.tools.profile_train
        allowed = set()
        leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax")
                  or (m.split(".")[0] == "sad_tpu" and m not in allowed)]
        assert not leaked, leaked
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr


def _sad_tpu_imports(path: Path):
    """(line, module) of every import of sad_tpu or a module under it."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        found += [(node.lineno, n) for n in names if n.split(".")[0] == "sad_tpu"]
    return found


def test_no_source_of_the_port_imports_sad_tpu():
    """Static check: no file of sad_tpu_torch/ and not chip_smoke.py has an
    `import sad_tpu...` or `from sad_tpu... import`, wherever it stands
    (inside functions too). The gitignored build directory holds no source."""
    pkg = REPO / "sad_tpu_torch"
    files = sorted(f for f in pkg.rglob("*.py") if "_build" not in f.relative_to(pkg).parts)
    files.append(REPO / "chip_smoke.py")
    assert len(files) >= 30
    bad = {str(f.relative_to(REPO)): hits for f in files if (hits := _sad_tpu_imports(f))}
    assert not bad, bad


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
