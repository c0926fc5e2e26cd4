"""Nothing of sad_tpu is left to port, read from sad_tpu's source with ast
(no module of sad_tpu is imported):

- its ``pl.pallas_call`` sites are exactly the eight of PERF.md section 6,
  and the CUDA file that replaces each defines the ``__global__`` kernels
  that do its work;
- every sad_tpu module has a module at the same path under sad_tpu_torch/,
  or a NOT_PORTED entry;
- every public top-level def or class of sad_tpu is defined at the top level
  of some module under sad_tpu_torch/, or has a NOT_PORTED entry.

A NOT_PORTED entry names its counterpart in the port or starts "Not ported"
with the reason (ROADMAP.md "Not ported"); an entry that nothing needs any
more fails too. So a sad_tpu module or name that nobody ported fails by
name."""

import ast
import functools
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX_PKG = REPO / "sad_tpu"
PORT = REPO / "sad_tpu_torch"

NMS_KERNELS = ("nms_order_kernel", "nms_mask_kernel", "nms_sweep_kernel", "nms_run_sort_kernel",
               "nms_merge_kernel", "nms_kept_sweep_kernel")
CLS_FWD_KERNELS = ("cls_losses_fwd_kernel", "cls_losses_sum_kernel")
CLS_BWD_KERNELS = ("cls_losses_bwd_kernel",)
ROI_FWD_KERNELS = ("roi_align_fwd_kernel",)
ROI_BWD_KERNELS = ("roi_bwd_bin_kernel", "roi_bwd_scan_kernel", "roi_align_bwd_gather_kernel")

# (sad_tpu file, line of its pl.pallas_call) -> (the CUDA file that replaces it, its kernels);
# PERF.md section 6, rows #1-#8
PALLAS_CALLS = {
    ("sad_tpu/ops/pallas_nms.py", 191): ("sad_tpu_torch/csrc/nms.cu", NMS_KERNELS),
    ("sad_tpu/ops/pallas_nms.py", 245): ("sad_tpu_torch/csrc/nms.cu", NMS_KERNELS),
    ("sad_tpu/ops/pallas_losses.py", 439): ("sad_tpu_torch/csrc/cls_losses.cu", CLS_FWD_KERNELS),
    ("sad_tpu/ops/pallas_losses.py", 463): ("sad_tpu_torch/csrc/cls_losses.cu", CLS_FWD_KERNELS),
    ("sad_tpu/ops/pallas_losses.py", 513): ("sad_tpu_torch/csrc/cls_losses.cu", CLS_BWD_KERNELS),
    ("sad_tpu/ops/pallas_losses.py", 538): ("sad_tpu_torch/csrc/cls_losses.cu", CLS_BWD_KERNELS),
    ("sad_tpu/ops/pallas_roi_align.py", 487): ("sad_tpu_torch/csrc/roi_align.cu", ROI_FWD_KERNELS),
    ("sad_tpu/ops/pallas_roi_align.py", 662): ("sad_tpu_torch/csrc/roi_align.cu", ROI_BWD_KERNELS),
}

_SHARDINGS = ("Not ported: a jax sharding; the port's data and 'model' axes are "
              "sad_tpu_torch/parallel/mesh.py (shard_batch_tree), distributed.py and spatial.py")

# a sad_tpu module ("ops/topk.py") or a public name of one ("models/fpn.py:upsample_nearest_2x")
# that has no counterpart at the same path or under the same name
NOT_PORTED = {
    "ops/pallas_losses.py": "sad_tpu_torch/ops/cls_loss_kernel.py and "
                            "sad_tpu_torch/csrc/cls_losses.cu",
    "ops/pallas_nms.py": "sad_tpu_torch/ops/nms_kernel.py and sad_tpu_torch/csrc/nms.cu",
    "ops/pallas_roi_align.py": "sad_tpu_torch/ops/roi_align_kernel.py and "
                               "sad_tpu_torch/csrc/roi_align.cu",
    "ops/reference_numpy.py": "Not ported: the port's tests read it as an oracle",
    "ops/grouped_conv.py": "Not ported: TPU layout phrasings of a grouped conv under an unchanged "
                           "parameter tree; the port's convs take groups= "
                           "(sad_tpu_torch/models/resnet.py)",
    "ops/topk.py": "Not ported: approximate top-k (PartialReduce); the exact torch.topk is its "
                   "recall-1.0 case",
    "train/orbax_checkpoint.py": "sad_tpu_torch/train/async_checkpoint.py (TRAIN.CHECKPOINT_BACKEND "
                                 "'orbax'); sad_tpu's orbax files are read only by a JAX library",
    "models/fpn.py:upsample_nearest_2x": "F.interpolate(mode='nearest') in "
                                         "sad_tpu_torch/models/fpn.py",
    "models/model_builder.py:init_model_params": "Not ported: a flax init; the port's modules make "
                                                 "their parameters (sad_tpu_torch/models/"
                                                 "model_builder.py)",
    "models/model_builder.py:param_count": "Not ported: the leaves of a flax tree; "
                                           "model.parameters() in torch",
    "models/resnet.py:GroupedConv": "Not ported: ops/grouped_conv.py's phrasings; "
                                    "sad_tpu_torch/models/resnet.py takes groups=",
    "models/resnet.py:Conv1S2D": "Not ported: S2D_STEM's space-to-depth phrasing of conv1; "
                                 "sad_tpu_torch/models/resnet.py runs the 7x7 stem",
    "ops/proposals.py:dense_multilevel_roi_align": "Not ported: RoIAlign's mode dispatch; "
                                                   "sad_tpu_torch/ops/roi_align.py",
    "parallel/mesh.py:batch_sharding": _SHARDINGS,
    "parallel/mesh.py:replicated_sharding": _SHARDINGS,
    "parallel/mesh.py:spatial_sharding": _SHARDINGS,
    "train/checkpoint.py:convert_reference_pickle": "reference_blobs_to_state_dict in "
                                                    "sad_tpu_torch/train/checkpoint.py",
    "train/checkpoint.py:flax_to_reference_blobs": "state_dict_to_reference_blobs in "
                                                   "sad_tpu_torch/train/checkpoint.py",
    "train/checkpoint.py:load_reference_weights": "load_reference_or_native in "
                                                  "sad_tpu_torch/train/checkpoint.py",
    "train/checkpoint.py:reference_blobs_to_flax": "reference_blobs_to_state_dict in "
                                                   "sad_tpu_torch/train/checkpoint.py",
    "train/optimizer.py:MomentumSGDState": "a dict of velocities, init_velocity in "
                                           "sad_tpu_torch/train/optimizer.py",
    "train/optimizer.py:init_momentum_state": "init_velocity in sad_tpu_torch/train/optimizer.py",
    "train/optimizer.py:fused_momentum_sgd_update": "Not ported: a TPU study of the update that "
                                                    "momentum_sgd_update in "
                                                    "sad_tpu_torch/train/optimizer.py computes",
    "utils/net_info.py:dump_hlo": "Not ported: an XLA program's text",
}

MODULES = sorted(p.relative_to(JAX_PKG).as_posix() for p in JAX_PKG.rglob("*.py"))


def _tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _top_level(tree: ast.Module):
    """Names a module defines at its top level: defs, classes, assignments."""
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            yield node.name
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            yield from (t.id for t in targets if isinstance(t, ast.Name))


def _public_defs(module: str):
    """The public top-level defs and classes of a sad_tpu module."""
    return [node.name for node in _tree(JAX_PKG / module).body
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not node.name.startswith("_")]


@functools.lru_cache(maxsize=None)
def _port_names():
    return frozenset(name for p in PORT.rglob("*.py") if "_build" not in p.parts
                     for name in _top_level(_tree(p)))


def _pallas_sites():
    for module in MODULES:
        for node in ast.walk(_tree(JAX_PKG / module)):
            f = node.func if isinstance(node, ast.Call) else None
            if (isinstance(f, ast.Attribute) and f.attr == "pallas_call"
                    and isinstance(f.value, ast.Name) and f.value.id == "pl"):
                yield f"sad_tpu/{module}", node.lineno


def _global_kernels(cu: Path):
    """Names of the __global__ functions a CUDA file defines, comments left out."""
    text = re.sub(r"//[^\n]*|/\*.*?\*/", "", cu.read_text(), flags=re.S)
    return set(re.findall(r"__global__\s+void\s+(?:__\w+__\s*\([^)]*\)\s*)*(\w+)\s*\(", text))


def test_pallas_call_sites_are_the_eight():
    assert sorted(_pallas_sites()) == sorted(PALLAS_CALLS)


@pytest.mark.parametrize("site", sorted(PALLAS_CALLS), ids=lambda s: f"{s[0]}:{s[1]}")
def test_pallas_call_has_its_cuda_kernels(site):
    cu, kernels = PALLAS_CALLS[site]
    missing = set(kernels) - _global_kernels(REPO / cu)
    assert not missing, f"{cu} defines no __global__ {sorted(missing)} for {site[0]}:{site[1]}"


def test_not_ported_entries_name_sad_tpu_modules():
    assert sorted({k.split(":")[0] for k in NOT_PORTED} - set(MODULES)) == []


@pytest.mark.parametrize("module", MODULES)
def test_module_is_ported(module):
    entries = {k: v for k, v in NOT_PORTED.items() if k.split(":")[0] == module}
    for key, why in entries.items():
        paths = re.findall(r"sad_tpu_torch/[\w/.]+\.(?:py|cu)", why)
        assert why.startswith("Not ported") or paths, f"{key}: names no counterpart"
        assert all((REPO / p).is_file() for p in paths), f"{key}: {paths}"
    if not (PORT / module).is_file():
        assert module in entries, f"sad_tpu/{module} has no sad_tpu_torch/{module}"
        return
    assert module not in entries, f"sad_tpu_torch/{module} exists: NOT_PORTED's entry is stale"
    public = _public_defs(module)
    unported = sorted(n for n in public if n not in _port_names())
    assert unported == sorted(k.split(":")[1] for k in entries), (
        f"sad_tpu/{module}: defined nowhere in sad_tpu_torch/ {unported}, "
        f"NOT_PORTED {sorted(entries)}")
