"""Parameter summary: the analogue of the reference's first-iter net
printout (lib/utils/net.py:224-263 print_net). A port of
sad_tpu/utils/net_info.py:17 print_model_summary over a state_dict; its
``dump_hlo`` prints an XLA program and has no counterpart here.
"""

from __future__ import annotations

from typing import Dict

import torch


def print_model_summary(state_dict: Dict[str, torch.Tensor], max_rows: int = 0) -> str:
    """Human-readable table: name, shape, #params, dtype. Returns the text
    (also printed)."""
    rows = []
    total = 0
    for name, t in state_dict.items():
        n = t.numel()
        total += n
        rows.append((name, tuple(t.shape), n, str(t.dtype).replace("torch.", "")))
    lines = [f"{'param':<60} {'shape':<22} {'count':>12} dtype"]
    shown = rows if not max_rows else rows[:max_rows]
    for name, shape, n, dt in shown:
        lines.append(f"{name:<60} {str(shape):<22} {n:>12,} {dt}")
    if max_rows and len(rows) > max_rows:
        lines.append(f"... ({len(rows) - max_rows} more)")
    lines.append(f"TOTAL: {total:,} params ({total * 4 / 1e6:.1f} MB fp32)")
    text = "\n".join(lines)
    print(text)
    return text
