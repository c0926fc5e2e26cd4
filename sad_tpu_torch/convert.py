"""Weights between sad_tpu's Flax parameter tree and the port's state_dict.

A sad_tpu param tree is nested dicts of numpy arrays, e.g.
``params['fpn']['body']['Bottleneck_0']['res2_0_branch2a']['kernel']``. The
port's modules carry the same names, so a path maps to a state_dict key by
joining with '.', and only the leaves change:

- ``kernel`` (HWIO, grouped ``(k, k, cin/g, cout)``) <-> ``weight`` (OIHW,
  ``(cout, cin/g, k, k)``);
- ``bias`` and the AffineChannel ``s``/``b`` copy as they are.

The Detectron blob name of a leaf is its last module name plus ``_w``,
``_b``, ``_s`` (sad_tpu/train/checkpoint.py:91-112). An unknown or missing
key, or a shape that disagrees, raises.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn


def _walk(tree: Any, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, prefix + (str(k),))
    else:
        yield prefix, tree


def params_to_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """sad_tpu param tree (nested dicts of arrays) -> state_dict (CPU)."""
    sd = {}
    for path, leaf in _walk(params):
        *mods, name = path
        arr = np.asarray(leaf)
        if name == "kernel":
            if arr.ndim != 4:
                raise ValueError(f"{'/'.join(path)}: expected a 4-D HWIO kernel")
            name, arr = "weight", arr.transpose(3, 2, 0, 1)
        elif name not in ("bias", "s", "b"):
            raise KeyError(f"unknown parameter leaf {'/'.join(path)}")
        sd[".".join(mods + [name])] = torch.tensor(arr)  # a contiguous copy
    return sd


def state_dict_to_params(sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """state_dict -> sad_tpu param tree of float32 numpy arrays."""
    tree: Dict[str, Any] = {}
    for key, t in sd.items():
        *mods, name = key.split(".")
        arr = t.detach().to("cpu", torch.float32).numpy()
        if name == "weight":
            name, arr = "kernel", arr.transpose(2, 3, 1, 0)
        elif name not in ("bias", "s", "b"):
            raise KeyError(f"unknown state_dict entry {key}")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[name] = np.ascontiguousarray(arr)
    return tree


def load_params(model: nn.Module, params: Dict[str, Any]) -> nn.Module:
    """Load a sad_tpu param tree into ``model`` in place; raises on any key
    missing on either side or any shape that disagrees."""
    sd = params_to_state_dict(params)
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    unknown = sorted(set(sd) - set(own))
    if missing or unknown:
        raise KeyError(f"param tree does not match the model: missing {missing[:5]}"
                       f" ({len(missing)}), unknown {unknown[:5]} ({len(unknown)})")
    bad = [k for k in sd if tuple(sd[k].shape) != tuple(own[k].shape)]
    if bad:
        raise ValueError(f"shape mismatch for {[(k, tuple(sd[k].shape), tuple(own[k].shape)) for k in bad[:5]]}")
    model.load_state_dict(sd, strict=True)
    return model


class _NoJaxUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] in ("jax", "jaxlib", "flax"):
            raise pickle.UnpicklingError(
                f"checkpoint refers to {module}.{name}; sad_tpu_torch loads "
                "only checkpoints of plain dicts and numpy arrays"
            )
        return super().find_class(module, name)


def load_checkpoint_params(path: str) -> Dict[str, Any]:
    """The param tree of a native sad_tpu checkpoint pickle
    (``{'params': ..., 'velocity': ..., 'iter': ..., 'cfg_yaml': ...}``,
    sad_tpu/train/checkpoint.py:37-59), read without importing jax. Only
    unpickle files this project wrote: unpickling runs code."""
    with open(path, "rb") as f:
        payload = _NoJaxUnpickler(f).load()
    if not isinstance(payload, dict) or "params" not in payload:
        raise KeyError(f"{path}: not a sad_tpu checkpoint (no 'params' entry)")
    return payload["params"]
