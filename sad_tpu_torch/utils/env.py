"""Environment introspection (ref: sad_tpu/utils/env.py;
detectron/lib/utils/env.py): the runtime's versions and devices, and the
paths of the port's compiled kernel libraries."""

from __future__ import annotations

from typing import Dict


def get_runtime_info() -> Dict[str, str]:
    """torch and CUDA versions, and the CUDA devices torch sees."""
    import torch

    info = {
        "torch_version": torch.__version__,
        "cuda_version": str(torch.version.cuda),
        "cuda_available": str(torch.cuda.is_available()),
        "device_count": str(torch.cuda.device_count()),
    }
    info["devices"] = ", ".join(torch.cuda.get_device_name(i)
                                for i in range(torch.cuda.device_count())) or "(none)"
    return info


def get_native_kernels_lib() -> Dict[str, str]:
    """The paths of the compiled kernel libraries (the dyndep analogue of
    lib/utils/env.py get_detectron_ops_lib): 'host', the g++ host kernels
    (sad_tpu_torch/native, built at first use), and 'cuda', the CUDA kernels
    (ops/_build.py), which are built only on a machine with nvcc and a card;
    elsewhere it says so."""
    import torch

    from .. import native
    from ..ops import _build

    out = {"host": native.load()._name}
    if torch.cuda.is_available():
        out["cuda"] = str(_build.load_library().path)
    else:
        out["cuda"] = f"(not built: no CUDA card; sources hash {_build.source_hash()})"
    return out
