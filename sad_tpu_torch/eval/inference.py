"""RetinaNet inference, batched and on the device (ref:
sad_tpu/eval/inference.py; detectron/lib/core/test_retinanet.py:69-204).

uint8 canvas -> normalise -> ResNet-FPN RetinaNet -> per-level top-k ->
box decode -> class-wise greedy NMS (one call for the whole batch) -> top
DETECTIONS_PER_IM. On CUDA tensors every step stays on the device and no
step waits for the card: the cell anchors are copied to a device once and
cached, and only the (N, 100) results need to come back.

Decode semantics preserved:
- score threshold INFERENCE_TH, relaxed to 0.0 at the coarsest level
  (test_retinanet.py:126-131);
- per-level PRE_NMS_TOP_N candidates by exact ``torch.topk``
  (TEST.EXACT_TOPK is ignored: there is no approximate path);
- box = cell_anchor[a] + grid*stride, delta transform, / image scale, clip
  to the ORIGINAL image extent (test_retinanet.py:146-163);
- class-wise NMS at TEST.NMS, global top DETECTIONS_PER_IM
  (test_retinanet.py:174-194).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Tuple

import torch

from ..data.anchors import retinanet_cell_anchors
from ..ops.box_transforms import bbox_transform
from ..ops.image_norm import normalize_u8_on_device
from ..ops.nms import NEG_INF, batched_nms_multi


@functools.lru_cache(maxsize=None)
def cell_anchors_on(device: torch.device, level: int, anchor_scale: float,
                    aspect_ratios: Tuple[float, ...], scales_per_octave: int
                    ) -> torch.Tensor:
    """(A, 4) float32 cell anchors of one FPN level on ``device``, copied
    from the host once per process: a pageable host-to-device copy in every
    decode would make the host wait for the forward to finish."""
    cells = retinanet_cell_anchors(level, anchor_scale, aspect_ratios, scales_per_octave)
    with torch.inference_mode(False):
        return torch.as_tensor(cells, dtype=torch.float32, device=device)


def _level_candidates(
    probs: torch.Tensor,  # (N, H, W, A, C) float32
    box_pred: torch.Tensor,  # (N, H, W, A, 4)
    cell_anchors: torch.Tensor,  # (A, 4)
    stride: float,
    threshold: float,
    top_n: int,
) -> Tuple[torch.Tensor, ...]:
    """Top candidates of one level for every image. Returns (boxes (N,k,4)
    in network-input coords, scores (N,k), classes (N,k) 0-based fg ids,
    valid (N,k))."""
    n, h, w, a, c = probs.shape
    flat = probs.reshape(n, -1)
    k = min(top_n, flat.shape[1])
    masked = torch.where(flat > threshold, flat, NEG_INF)
    scores, inds = torch.topk(masked, k, dim=1)
    valid = scores > NEG_INF

    cls = inds % c
    cell = inds // c  # index into the (H, W, A) grid
    ai = cell % a
    rem = cell // a
    xi = rem % w
    yi = rem // w

    shift = torch.stack([xi, yi, xi, yi], dim=-1).float() * stride
    anchors = cell_anchors[ai] + shift
    deltas = torch.gather(box_pred.reshape(n, h * w * a, 4), 1,
                          cell[..., None].expand(n, k, 4))
    boxes = bbox_transform(anchors, deltas)
    return boxes, torch.where(valid, scores, NEG_INF), cls, valid


def decode_candidates(
    cfg,
    outputs: Dict[str, Dict[int, torch.Tensor]],
    im_hw: torch.Tensor,  # (N, 2) original image (h, w)
    im_scale: torch.Tensor,  # (N,) network-input / original scale factor
    use_bbox_reg: bool = True,
) -> Tuple[torch.Tensor, ...]:
    """The NMS candidates of a batch, all levels concatenated: boxes (N,K,4)
    in original-image coords and clipped to it, scores (N,K) (NEG_INF where
    not valid), classes (N,K) 0-based, valid (N,K)."""
    if cfg.RETINANET.CLASS_SPECIFIC_BBOX:
        # neither does the reference inference path (test_retinanet.py:120-121)
        raise NotImplementedError(
            "decode_detections does not support RETINANET.CLASS_SPECIFIC_BBOX"
        )
    levels = cfg.fpn_levels()
    a = cfg.num_anchors_per_cell()
    some = outputs["cls_prob"][levels[0]]
    dev = some.device
    im_hw = im_hw.to(dev, torch.float32)
    im_scale = im_scale.to(dev, torch.float32)

    per_level = []
    for lvl in levels:
        prob = outputs["cls_prob"][lvl]
        n, h, w, ac = prob.shape
        prob = prob.reshape(n, h, w, a, ac // a)
        if cfg.RETINANET.SOFTMAX:
            prob = prob[..., 1:]  # drop background (test_retinanet.py:123-124)
        box = outputs["bbox_pred"][lvl].reshape(n, h, w, a, 4)
        if not use_bbox_reg:
            box = torch.zeros_like(box)
        cells = cell_anchors_on(dev, lvl, cfg.RETINANET.ANCHOR_SCALE,
                                tuple(cfg.RETINANET.ASPECT_RATIOS),
                                cfg.RETINANET.SCALES_PER_OCTAVE)
        th = cfg.RETINANET.INFERENCE_TH if lvl < max(levels) else 0.0
        per_level.append(_level_candidates(
            prob, box, cells, float(2.0 ** lvl), th, cfg.RETINANET.PRE_NMS_TOP_N,
        ))
    boxes, scores, classes, valid = (torch.cat(t, dim=1) for t in zip(*per_level))
    boxes = boxes / im_scale[:, None, None]
    # clip to the original image extent (test_retinanet.py:162-163)
    hi = torch.stack([im_hw[:, 1], im_hw[:, 0], im_hw[:, 1], im_hw[:, 0]], dim=-1) - 1.0
    boxes = torch.minimum(torch.clamp(boxes, min=0.0), hi[:, None, :])
    return boxes, scores, classes, valid


def gather_detections(candidates, keep_idx: torch.Tensor, keep_valid: torch.Tensor
                      ) -> Dict[str, torch.Tensor]:
    """The kept candidates as (N, max_out) tensors: 'boxes', 'scores' (0
    where not valid), 'classes' (1-based, 0 where not valid), 'valid'."""
    boxes, scores, classes, _ = candidates
    keep = keep_idx.long()
    kept_boxes = torch.gather(boxes, 1, keep[..., None].expand(-1, -1, 4))
    kept_scores = torch.gather(scores, 1, keep)
    kept_classes = torch.gather(classes, 1, keep)
    return {
        "boxes": kept_boxes,
        "scores": torch.where(keep_valid, kept_scores, 0.0),
        "classes": torch.where(keep_valid, kept_classes + 1, 0),
        "valid": keep_valid,
    }


def decode_detections(cfg, outputs, im_hw, im_scale, use_bbox_reg: bool = True
                      ) -> Dict[str, torch.Tensor]:
    """Decode a batch to (N, DETECTIONS_PER_IM) detections, with ONE
    class-wise NMS call for the whole batch."""
    cands = decode_candidates(cfg, outputs, im_hw, im_scale, use_bbox_reg)
    keep_idx, keep_valid = batched_nms_multi(
        *cands, cfg.TEST.NMS, cfg.TEST.DETECTIONS_PER_IM,
    )
    return gather_detections(cands, keep_idx, keep_valid)


def device_normalize(cfg, images: torch.Tensor, content_hw=None, row0: int = 0
                     ) -> torch.Tensor:
    """uint8 canvases -> normalised float32 on their device, padding outside
    content_hw forced to 0.0 (``images`` rows [row0, row0 + rows) of the
    canvases when they are a band). Float inputs (already normalised on the
    host) pass through."""
    if images.dtype != torch.uint8:
        return images
    return normalize_u8_on_device(
        images, cfg.PIXEL_MEANS, cfg.PIXEL_DIV, cfg.PIXEL_STD, content_hw, row0=row0
    )


SERVING_OUTPUTS = ("cls_prob", "bbox_pred")


def make_inference_fn(cfg, model, mesh=None) -> Callable:
    """images -> top-DETECTIONS_PER_IM detections, end to end.

    fn(images (N,H,W,3), im_hw (N,2), im_scale (N,), content_hw=None) ->
    dict. All tensors on the model's device. uint8 canvases are normalised
    on the device (content_hw required then); float32 inputs are taken as
    already normalised. With TEST.SAVE_RES the raw per-level maps come back
    too (the teacher dump of the pseudo-label pipeline,
    test_retinanet.py:97-101).

    With a ``mesh`` (parallel/mesh.py) of n_model > 1, ``images`` are the
    rank's data shard's canvases: every rank of a model group runs the
    forward on its band of rows (parallel/spatial.py), the group all-gathers
    each level's cls_prob and bbox_pred by rows, and its first rank decodes
    and returns the detections; the others return None."""
    banded = mesh is not None and mesh.n_model > 1
    if banded:
        from ..parallel.halo import gather_rows
        from ..parallel.spatial import spatialize

        run = spatialize(model, mesh)

    @torch.inference_mode()
    def infer(images, im_hw, im_scale, content_hw=None):
        if banded:
            height = images.shape[1]
            r0, r1 = mesh.band(height)
            band = device_normalize(cfg, images[:, r0:r1], content_hw, row0=r0)
            rows = run.level_heights(height, SERVING_OUTPUTS, band.dtype, band.device)
            out = {k: {lvl: gather_rows(t, rows[k][lvl], mesh) for lvl, t in v.items()}
                   for k, v in run(band, outputs=SERVING_OUTPUTS, height=height).items()}
            if not mesh.is_model_first:
                return None
        else:
            out = model(device_normalize(cfg, images, content_hw))
        dets = decode_detections(cfg, out, im_hw, im_scale, cfg.TEST.BBOX_REG)
        if cfg.TEST.SAVE_RES:
            dets["raw_cls_prob"] = out["cls_prob"]
            dets["raw_bbox_pred"] = out["bbox_pred"]
        return dets

    return infer
