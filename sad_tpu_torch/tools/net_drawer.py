"""Render a model's module graph to Graphviz dot and a parameter summary
(ref: sad_tpu/tools/net_drawer.py).

The analogue of the reference's net visualization devtools
(caffe2/python/net_drawer.py GetPydotGraph over NetDef ops, and the mint web
UI caffe2/python/mint/): what a human wants to see is the MODULE graph, body
stages -> FPN laterals / top-down -> heads, with parameter counts a module.
The scopes are sad_tpu's parameter-tree paths (the port's state_dict keys
with Flax's leaf names, sad_tpu_torch/convert.py), so both packages draw the
same graph. The model is built on the meta device: names and shapes only,
no values and no device work.

Usage:
  python -m sad_tpu_torch.tools.net_drawer --cfg cfg.yaml [--out model.dot]
      [--summary] [KEY VALUE ...]

The dot output renders with any graphviz (`dot -Tpdf model.dot -o model.pdf`);
no graphviz python package is needed to WRITE it.
"""

from __future__ import annotations

import argparse
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

from sad_tpu_torch.config import load_cfg
from sad_tpu_torch.utils.logging import setup_logging


def module_table(sd: Dict[str, torch.Tensor], depth: int = 2) -> Dict[str, int]:
    """Parameter counts by module scope, ``depth`` path levels deep, over a
    state_dict (meta tensors will do). A leaf's name is Flax's ('weight' is
    'kernel'), as sad_tpu's table keys its scopes."""
    counts: Dict[str, int] = defaultdict(int)
    for key, t in sd.items():
        keys = key.split(".")
        if keys[-1] == "weight":
            keys[-1] = "kernel"
        scope = "/".join(keys[:depth]) if keys else "?"
        counts[scope] += int(t.numel())
    return dict(counts)


def _wiring_edges(cfg, modules: List[str]) -> List[Tuple[str, str]]:
    """Dataflow edges between top-level modules, from the known builder
    wiring (models/arch.py + models/rcnn.py): body stages feed FPN, FPN
    feeds every head; C4 trunks feed heads directly."""
    edges = []
    has = set(modules)

    def _link(a, b):
        if a in has and b in has:
            edges.append((a, b))

    stage_like = sorted(
        m for m in has
        if m.split("/")[-1].startswith(("res", "conv", "vgg", "body"))
        and not any(k in m.lower() for k in ("lateral", "topdown", "post", "p6", "p7"))
    )
    prev = None
    for m in stage_like:
        if prev is not None:
            _link(prev, m)
        prev = m
    fpn = [
        m for m in has
        if any(k in m.lower() for k in ("lateral", "topdown", "post", "p6", "p7"))
    ]
    heads = [
        m for m in has
        if any(k in m.lower() for k in (
            "cls", "bbox", "retnet", "mask", "kps", "rpn", "head", "score",
        ))
        and m not in fpn
    ]
    src = fpn[0] if fpn else (stage_like[-1] if stage_like else None)
    for f in fpn:
        if stage_like:
            _link(stage_like[-1], f)
    if src:
        for h in heads:
            _link(src, h)
    return edges


def to_dot(cfg, sd: Dict[str, torch.Tensor], title: str = "sad_tpu model") -> str:
    """The module graph as Graphviz dot: a node a module scope with its
    parameter count, the edges of _wiring_edges."""
    counts = module_table(sd)
    modules = sorted(counts)
    lines = [
        "digraph model {",
        "  rankdir=TB;",
        f'  label="{title}  ({sum(counts.values()):,} params)";',
        "  node [shape=box, style=rounded, fontname=Helvetica];",
    ]
    for m in modules:
        lines.append(f'  "{m}" [label="{m}\\n{counts[m]:,} params"];')
    for a, b in _wiring_edges(cfg, modules):
        lines.append(f'  "{a}" -> "{b}";')
    lines.append("}")
    return "\n".join(lines)


def main(argv=None):
    logger = setup_logging("net_drawer")
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cfg", dest="cfg_file", required=True)
    p.add_argument("--out", default="model.dot")
    p.add_argument("--summary", action="store_true",
                   help="also print the per-parameter table")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    args = p.parse_args(argv)

    cfg = load_cfg(args.cfg_file, args.opts or None)
    from sad_tpu_torch.models import create_model

    sd = create_model(cfg, "meta").state_dict()
    dot = to_dot(cfg, sd, title=f"{cfg.MODEL.TYPE}:{cfg.MODEL.CONV_BODY}")
    with open(args.out, "w") as f:
        f.write(dot)
    logger.info("Wrote %s (%d modules)", args.out, len(module_table(sd)))
    if args.summary:
        from sad_tpu_torch.utils.net_info import print_model_summary

        print_model_summary(sd)
    return args.out


if __name__ == "__main__":
    main()
