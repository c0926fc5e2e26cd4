"""Model export for serving: an ahead-of-time program of RetinaNet inference
(ref: sad_tpu/eval/export.py).

sad_tpu serializes its jitted inference function (model, decode and NMS at
fixed shapes) with ``jax.export``, so a serving binary reloads and calls it
without Python model code. The port's counterpart is ``torch.export``: an
``nn.Module`` that wraps the device normalisation, the model and
``decode_detections`` is traced at static shapes, its weights saved inside
the ``.pt2`` with ``torch.export.save``, and ``load_exported`` reloads it with
``torch.export.load(...).module()``.

Two things make the trace work:

- the greedy NMS is the custom op ``sad_tpu_torch::nms_multi``
  (ops/nms.py): the graph holds one op node, which runs the CUDA kernel on
  the card and the plain version on the CPU. Importing this module registers
  the op, so a process that imports only ``torch`` and this module can load
  and serve an exported program;
- the decode's per-level cell anchors come from ``functools.lru_cache``
  (eval/inference.cell_anchors_on, and the R-CNN models' anchor grids). A
  tensor made while tracing is a fake one, and a cache that kept it would
  break live serving later in the same process, so the caches are cleared
  after every trace.

Shapes are static, as sad_tpu's are: a program serves one batch size and
one canvas.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Dict, Tuple

import torch
from torch import nn

from ..ops import nms as _nms  # noqa: F401  (registers sad_tpu_torch::nms_multi)

logger = logging.getLogger(__name__)

OUTPUTS = ("boxes", "scores", "classes", "valid")


class ServedRetinaNet(nn.Module):
    """images -> top-DETECTIONS_PER_IM detections, as ``make_inference_fn``
    computes them: uint8 canvases (with content_hw) are normalised on the
    device, float32 ones are taken as normalised on the host (sad_tpu's
    exported signature: images, im_hw, im_scale)."""

    def __init__(self, cfg, model: nn.Module):
        super().__init__()
        self.cfg, self.model = cfg, model

    def forward(self, images, im_hw, im_scale, content_hw=None) -> Dict[str, torch.Tensor]:
        from .inference import decode_detections, device_normalize

        images = device_normalize(self.cfg, images, content_hw)
        out = self.model(images)
        dets = decode_detections(self.cfg, out, im_hw, im_scale, self.cfg.TEST.BBOX_REG)
        return {k: dets[k] for k in OUTPUTS}


def clear_trace_caches() -> None:
    """Empty the lru caches of device tensors that a trace may have filled
    with fake tensors."""
    from ..models import rcnn, single_scale
    from . import inference

    for fn in (inference.cell_anchors_on, rcnn.rpn_anchor_field_on,
               single_scale.single_scale_anchor_field_on):
        fn.cache_clear()


def _example_inputs(batch_size: int, canvas_hw: Tuple[int, int], device,
                   uint8: bool = True) -> Tuple[torch.Tensor, ...]:
    """Inputs of the exported program's shapes and dtypes (values do not
    matter to the trace)."""
    h, w = canvas_hw
    hw = torch.tensor([[h, w]] * batch_size, dtype=torch.float32, device=device)
    scale = torch.ones((batch_size,), dtype=torch.float32, device=device)
    if uint8:
        return (torch.zeros((batch_size, h, w, 3), dtype=torch.uint8, device=device), hw,
                scale, hw.clone())
    return torch.zeros((batch_size, h, w, 3), dtype=torch.float32, device=device), hw, scale


def export_retinanet_inference(cfg, model: nn.Module, batch_size: int,
                               canvas_hw: Tuple[int, int], path: str,
                               uint8: bool = True) -> str:
    """Trace the end-to-end RetinaNet inference of ``model`` (on its device,
    in its dtype, weights baked in) for batches of ``batch_size`` canvases of
    ``canvas_hw`` and save it to ``path`` (a .pt2). ``uint8``: the program
    takes uint8 canvases and their content_hw; without, sad_tpu's float32
    signature. Returns the path."""
    if cfg.TEST.SAVE_RES:
        raise NotImplementedError("TEST.SAVE_RES: the exported program returns the "
                                  "detections only, as sad_tpu's does")
    device = next(model.parameters()).device
    served = ServedRetinaNet(cfg, model.eval()).eval()
    try:
        with torch.no_grad():
            program = torch.export.export(
                served, _example_inputs(batch_size, canvas_hw, device, uint8), strict=False)
    finally:
        clear_trace_caches()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.export.save(program, path)
    logger.info("Exported inference program (%d graph nodes, %d bytes) -> %s",
                len(program.graph.nodes), os.path.getsize(path), path)
    return path


def load_exported(path: str) -> Callable:
    """Reload an exported program; returns fn(images, im_hw, im_scale[,
    content_hw]) -> {'boxes', 'scores', 'classes', 'valid'} on the device it
    was exported on."""
    module = torch.export.load(path).module()

    def serve(*inputs):
        with torch.no_grad():
            return module(*inputs)

    return serve
