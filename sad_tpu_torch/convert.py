"""Weights between sad_tpu's Flax parameter tree and the port's state_dict.

A sad_tpu param tree is nested dicts of numpy arrays, e.g.
``params['fpn']['body']['Bottleneck_0']['res2_0_branch2a']['kernel']``. The
port's modules carry the same names, so a path maps to a state_dict key by
joining with '.', and only the leaves change:

- a 4-D ``kernel`` (HWIO, grouped ``(k, k, cin/g, cout)``) <-> ``weight``
  (OIHW, ``(cout, cin/g, k, k)``);
- a 2-D ``kernel`` of a Flax Dense ``(in, out)`` <-> ``nn.Linear.weight``
  ``(out, in)``;
- the ``kernel`` of a Flax ConvTranspose ``(kh, kw, in, out)`` <->
  ``nn.ConvTranspose2d.weight`` ``(in, out, kh, kw)``, flipped on both
  spatial axes: Flax's ConvTranspose (transpose_kernel=False) correlates the
  dilated input with the kernel as stored, PyTorch's is the gradient of a
  convolution. Which modules are transposed convolutions is known by name
  (``CONV_TRANSPOSE_MODULES``, the reference's blob names);
- ``bias`` and the AffineChannel ``s``/``b`` copy as they are.

The Detectron blob name of a leaf is its last module name plus ``_w``,
``_b``, ``_s`` (sad_tpu/train/checkpoint.py:91-112). An unknown or missing
key, or a shape that disagrees, raises.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn


# modules that are nn.ConvTranspose in sad_tpu (models/rcnn.py: the mask
# head's 2x deconv and the keypoint head's deconv output)
CONV_TRANSPOSE_MODULES = ("conv5_mask", "kps_score_lowres")


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
            name = "weight"
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim != 4:
                raise ValueError(f"{'/'.join(path)}: expected a 2-D Dense or a 4-D conv kernel")
            elif mods and mods[-1] in CONV_TRANSPOSE_MODULES:
                arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)
            else:
                arr = arr.transpose(3, 2, 0, 1)
        elif name not in ("bias", "s", "b"):
            raise KeyError(f"unknown parameter leaf {'/'.join(path)}")
        sd[".".join(mods + [name])] = torch.tensor(np.ascontiguousarray(arr))  # a copy
    return sd


def state_dict_to_params(sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """state_dict -> sad_tpu param tree of float32 numpy arrays."""
    tree: Dict[str, Any] = {}
    for key, t in sd.items():
        *mods, name = key.split(".")
        arr = t.detach().to("cpu", torch.float32).numpy()
        if name == "weight":
            name = "kernel"
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim != 4:
                raise ValueError(f"{key}: expected a 2-D linear or a 4-D conv weight")
            elif mods and mods[-1] in CONV_TRANSPOSE_MODULES:
                arr = arr.transpose(2, 3, 0, 1)[::-1, ::-1]
            else:
                arr = arr.transpose(2, 3, 1, 0)
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
