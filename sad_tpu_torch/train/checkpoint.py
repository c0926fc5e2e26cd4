"""Checkpoints in sad_tpu's native format, and the reference's Caffe2 blob
pickles (ref: sad_tpu/train/checkpoint.py).

On disk a checkpoint is sad_tpu's pickled dict
  {'params': <Flax-layout tree of numpy arrays>, 'velocity': <same>,
   'iter': int, 'cfg_yaml': str}
so a sad_tpu snapshot resumes in the port and a port snapshot loads in
sad_tpu. The port's parameters and its momentum (``TrainState.velocity``,
keyed by parameter name) are written through
``convert.state_dict_to_params`` and read back through
``convert.params_to_state_dict``. AUTO_RESUME scans for model_iter{N}.pkl /
model_final.pkl as train_net.py:208-233 does. The same payload is what
train/async_checkpoint.py (TRAIN.CHECKPOINT_BACKEND 'orbax') writes into
each step's directory.

A reference checkpoint is a flat {'blobs': {unscoped_name: ndarray}, 'cfg':
yaml} (lib/utils/net.py:149-182). Caffe2 keeps convolutions OIHW, transposed
convolutions IOHW with the conv-adjoint semantics, and FC weights (out, in):
PyTorch's own layouts, so a blob maps straight to its state_dict entry. Only
the flattening FCs (fc6, mask_fcn_logits) differ: the reference flattens
NCHW RoI features (CHW order), the port's heads flatten NHWC, so their input
columns are permuted (sad_tpu/train/checkpoint.py:115-163).
"""

from __future__ import annotations

import logging
import os
import pickle
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..convert import load_params, params_to_state_dict, state_dict_to_params

logger = logging.getLogger(__name__)


class _NoJaxUnpickler(pickle.Unpickler):
    """Refuses a pickle that names a jax / flax class: a checkpoint holds
    plain dicts and numpy arrays, and the port reads it without jax."""

    def find_class(self, module, name):
        if module.split(".")[0] in ("jax", "jaxlib", "flax"):
            raise pickle.UnpicklingError(
                f"checkpoint refers to {module}.{name}; sad_tpu_torch loads "
                "only checkpoints of plain dicts and numpy arrays")
        return super().find_class(module, name)


# --------------------------------------------------------------------------- #
# Native checkpoints
# --------------------------------------------------------------------------- #


def checkpoint_payload(state_dict: Dict[str, torch.Tensor],
                       velocity: Optional[Dict[str, torch.Tensor]] = None,
                       iteration: int = 0, cfg_yaml: str = "") -> Dict[str, Any]:
    """The dict a checkpoint holds, from a state_dict and a velocity."""
    return {
        "params": state_dict_to_params(state_dict),
        "velocity": state_dict_to_params(velocity) if velocity is not None else None,
        "iter": int(iteration),
        "cfg_yaml": cfg_yaml,
    }


def write_checkpoint(path: str, payload: Dict[str, Any]) -> None:
    """Pickle ``payload`` to ``path``; atomic: a crash never leaves a torn
    checkpoint."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def save_checkpoint(
    path: str,
    model: nn.Module,
    velocity: Optional[Dict[str, torch.Tensor]] = None,
    iteration: int = 0,
    cfg_yaml: str = "",
) -> None:
    """Write ``model``'s parameters and ``velocity`` in sad_tpu's native
    layout; atomic: a crash never leaves a torn checkpoint."""
    write_checkpoint(path, checkpoint_payload(model.state_dict(), velocity, iteration, cfg_yaml))


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The checkpoint dict as written (Flax-layout numpy trees). Only load
    files this project wrote: unpickling runs code."""
    with open(path, "rb") as f:
        return _NoJaxUnpickler(f).load()


def restore_checkpoint(ck: Dict[str, Any], model: nn.Module,
                       velocity: Dict[str, torch.Tensor]) -> None:
    """Load a checkpoint dict's params into ``model`` and its velocity into
    ``velocity`` (in place). The velocity's key set must be the model's
    parameter set: sad_tpu keeps a momentum for every parameter, frozen
    ones included (they stay zero)."""
    load_params(model, ck["params"])
    if ck.get("velocity") is None:
        return
    vel = params_to_state_dict(ck["velocity"])
    if set(vel) != set(velocity):
        missing, extra = sorted(set(velocity) - set(vel)), sorted(set(vel) - set(velocity))
        raise KeyError(f"checkpoint velocity does not match the model's parameters: missing "
                       f"{missing[:5]} ({len(missing)}), unknown {extra[:5]} ({len(extra)})")
    with torch.no_grad():
        for k, v in vel.items():
            if tuple(v.shape) != tuple(velocity[k].shape):
                raise ValueError(f"velocity {k}: shape {tuple(v.shape)} != "
                                 f"{tuple(velocity[k].shape)}")
            velocity[k].copy_(v)


def find_latest_checkpoint(output_dir: str) -> Tuple[Optional[str], int]:
    """AUTO_RESUME scan (ref: train_net.py:208-233): model_final.pkl wins,
    else the highest model_iter{N}.pkl. Returns (path|None, start_iter)."""
    final = os.path.join(output_dir, "model_final.pkl")
    if os.path.exists(final):
        return final, -1
    best, best_iter = None, -1
    if os.path.isdir(output_dir):
        for fn in os.listdir(output_dir):
            m = re.match(r"model_iter(\d+)\.pkl$", fn)
            if m and int(m.group(1)) > best_iter:
                best_iter = int(m.group(1))
                best = os.path.join(output_dir, fn)
    return best, (best_iter + 1 if best else 0)


# --------------------------------------------------------------------------- #
# Reference (Caffe2 blob) checkpoints
# --------------------------------------------------------------------------- #


def blob_name(key: str) -> Optional[str]:
    """state_dict key -> Caffe2 blob name (conv1_w, res_conv1_bn_s,
    fpn_inner_res5_2_sum_b, ...), or None if it has none."""
    *mods, leaf = key.split(".")
    module = mods[-1] if mods else ""
    if module.endswith("_bn"):
        return f"{module}_{leaf}" if leaf in ("s", "b") else None
    if leaf == "weight":
        return f"{module}_w"
    if leaf == "bias":
        return f"{module}_b"
    return None


def fc_flatten_resolutions(cfg) -> Dict[str, int]:
    """Spatial resolution of the RoI feature entering each flattening FC
    (module name -> square resolution)."""
    return {
        "fc6": cfg.FAST_RCNN.ROI_XFORM_RESOLUTION,
        "mask_fcn_logits": cfg.MRCNN.ROI_XFORM_RESOLUTION,
    }


def _fc_cols_to_port(w: np.ndarray, res: int) -> np.ndarray:
    """(out, C*res*res) with CHW-ordered input columns -> HWC order."""
    c = w.shape[1] // (res * res)
    perm = np.arange(c * res * res).reshape(c, res, res).transpose(1, 2, 0).ravel()
    return w[:, perm]


def _fc_cols_to_ref(w: np.ndarray, res: int) -> np.ndarray:
    """(out, C*res*res) with HWC-ordered input columns -> CHW order (the
    inverse of _fc_cols_to_port)."""
    c = w.shape[1] // (res * res)
    perm = np.arange(res * res * c).reshape(res, res, c).transpose(2, 0, 1).ravel()
    return w[:, perm]


def _is_flattening_fc(arr: np.ndarray, res: Optional[int]) -> bool:
    return bool(arr.ndim == 2 and res and arr.shape[1] % (res * res) == 0
                and arr.shape[1] > res * res)


def state_dict_to_reference_blobs(
    sd: Dict[str, torch.Tensor], fc_resolutions: Optional[Dict[str, int]] = None
) -> Dict[str, np.ndarray]:
    """A state_dict in the reference's blob naming and layout (the
    counterpart of sad_tpu/train/checkpoint.py:166 flax_to_reference_blobs):
    the port's layouts are Caffe2's, so only the flattening FCs of
    ``fc_resolutions`` have their input columns permuted back to CHW order.
    An entry without a blob name raises."""
    blobs: Dict[str, np.ndarray] = {}
    for key, t in sd.items():
        name = blob_name(key)
        if name is None:
            raise ValueError(f"Cannot map state_dict entry {key} to a blob name")
        arr = t.detach().to("cpu", torch.float32).numpy()
        res = (fc_resolutions or {}).get(key.split(".")[-2] if "." in key else "")
        if _is_flattening_fc(arr, res):
            arr = _fc_cols_to_ref(arr, res)
        blobs[name] = np.ascontiguousarray(arr)
    return blobs


def reference_blobs_to_state_dict(
    blobs: Dict[str, np.ndarray],
    model: nn.Module,
    strict: bool = False,
    fc_resolutions: Optional[Dict[str, int]] = None,
) -> Tuple[Dict[str, torch.Tensor], list, list]:
    """``model``'s state_dict with every entry that has a blob of the right
    shape replaced by it. Missing or shape-mismatched blobs are skipped and
    the model's value kept (net.py:108-122), unless ``strict``.
    Returns (state_dict, loaded_names, skipped_keys)."""
    loaded, skipped = [], []
    out = {}
    for key, t in model.state_dict().items():
        name = blob_name(key)
        if name is None or name not in blobs:
            skipped.append(key)
            if strict:
                raise KeyError(f"Missing blob for param {key}")
            out[key] = t.detach().cpu().clone()
            continue
        arr = np.asarray(blobs[name], dtype=np.float32)
        module = key.split(".")[-2] if "." in key else ""
        res = (fc_resolutions or {}).get(module)
        if _is_flattening_fc(arr, res):
            arr = _fc_cols_to_port(arr, res)
        if tuple(arr.shape) != tuple(t.shape):
            skipped.append(f"{key} (shape {arr.shape} != {tuple(t.shape)})")
            if strict:
                raise ValueError(skipped[-1])
            out[key] = t.detach().cpu().clone()
            continue
        loaded.append(name)
        out[key] = torch.tensor(np.ascontiguousarray(arr))
    return out, loaded, skipped


def load_reference_or_native(path: str, model: nn.Module, cfg=None) -> nn.Module:
    """Load weights into ``model`` in place, dispatching on the file: a
    native checkpoint (a dict with 'params') or a reference Caffe2 blob
    pickle ({'blobs': {...}} or a flat dict of blobs, py2 or py3 pickled,
    net.py:50-146). Pass cfg so the flattening FCs get their column
    permutation. A directory is a run of TRAIN.CHECKPOINT_BACKEND 'orbax'
    (its OUTPUT_DIR or the checkpoints/ in it, as sad_tpu's loader takes
    either), whose latest step is loaded, so test_net evaluates straight from
    a run; a directory with no step the port wrote (sad_tpu's orbax format,
    which only a JAX library reads) raises."""
    if os.path.isdir(path):
        from .async_checkpoint import AsyncCheckpointer

        sub = os.path.join(path, "checkpoints")
        ckpt_dir = sub if os.path.isdir(sub) else path
        ck = AsyncCheckpointer(ckpt_dir, create=False)
        step = ck.latest_step()
        if step is None:
            raise NotImplementedError(
                f"{ckpt_dir} holds no checkpoint step written by sad_tpu_torch's 'orbax' "
                "backend: sad_tpu's orbax checkpoints wrap a JAX library and are not read here "
                "(ROADMAP.md \"Not ported\")")
        load_params(model, ck.restore(step)["params"])
        logger.info("Loaded step %d from %s", step, ckpt_dir)
        return model
    with open(path, "rb") as f:
        data = _NoJaxUnpickler(f, encoding="latin1").load()
    if isinstance(data, dict) and "params" in data:
        return load_params(model, data["params"])
    blobs = data.get("blobs", data)
    sd, loaded, skipped = reference_blobs_to_state_dict(
        blobs, model, fc_resolutions=fc_flatten_resolutions(cfg) if cfg is not None else None)
    with torch.no_grad():
        for k, v in model.state_dict().items():
            v.copy_(sd[k])
    logger.info("Reference weights: loaded %d blobs, skipped %d params", len(loaded),
                len(skipped))
    return model
