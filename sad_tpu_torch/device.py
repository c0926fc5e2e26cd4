"""Device selection and the numeric settings a measurement states.

The port never falls back from the card to the CPU on its own: asking for
``cuda`` on a host without one raises. The CPU is used only when a caller
asks for it (the parity tests do). Over W ranks the rule holds per rank:
each asks for its own card, ``cuda:LOCAL_RANK`` (parallel.rank_device),
and a rank whose card does not exist raises.
"""

from __future__ import annotations

import subprocess

import torch


def get_device(kind: str = "cuda") -> torch.device:
    """``torch.device`` for ``kind`` ('cuda', 'cuda:N' or 'cpu'); raises if a
    GPU is asked for and none is present."""
    dev = torch.device(kind)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {kind!r} requested but torch.cuda.is_available() is "
                "False; sad_tpu_torch does not fall back to the CPU"
            )
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {kind!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) exist"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {kind!r}")
    return dev


def set_tf32(enabled: bool) -> dict:
    """Set both TF32 switches (cuDNN convolutions default to TF32, float32
    matmuls do not) and return them, so a run can print what it used."""
    torch.backends.cudnn.allow_tf32 = enabled
    torch.backends.cuda.matmul.allow_tf32 = enabled
    return {
        "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
        "matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
    }


def nvidia_smi_line() -> str:
    """The first card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
    them: the line that goes beside every number measured on the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]
