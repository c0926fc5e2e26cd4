"""Dataset inference and pseudo-label generation, RetinaNet branch (ref:
sad_tpu/eval/test_engine.py:56-127,631-677; detectron/lib/core/test_engine.py).

Images are batched onto the static test canvases as uint8 with their
content extents, normalised and decoded on the device, and the (N, 100)
results come back as COCO-format detection dicts. Not ported yet (ROADMAP.md
Queue 1): the R-CNN branches with their test-time augmentation, soft-NMS and
box voting (sad_tpu's RetinaNet branch ignores TEST.BBOX_AUG, TEST.SOFT_NMS
and TEST.BBOX_VOTE too, sad_tpu/eval/test_engine.py:160), visualisation
dumps and COCO evaluation.

Dataset I/O is the port's copy of sad_tpu's host modules (sad_tpu_torch.data).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, List

import numpy as np
import torch

from ..data.dataset import CocoDataset
from ..data.minibatch import compute_im_scale, load_image_bgr, resize_bgr_u8
from .inference import make_inference_fn

logger = logging.getLogger(__name__)


def _test_canvas_shapes(cfg):
    """(landscape, portrait) canvases: short side from max(TEST.SCALES),
    long side from TEST.MAX_SIZE, both rounded up to COARSEST_STRIDE."""
    cs = cfg.FPN.COARSEST_STRIDE
    short = int(cs * np.ceil(max(cfg.TEST.SCALES) / float(cs)))
    long = int(cs * np.ceil(cfg.TEST.MAX_SIZE / float(cs)))
    long = max(long, short)
    return (short, long), (long, short)


def prepare_test_batch(cfg, entries: List[dict], canvas) -> Dict[str, np.ndarray]:
    """uint8 BGR canvases plus per-image content extents ('content_hw'),
    original sizes ('im_hw') and scales ('im_scale')."""
    ch, cw = canvas
    n = len(entries)
    data = np.zeros((n, ch, cw, 3), np.uint8)
    im_hw = np.zeros((n, 2), np.float32)
    content_hw = np.zeros((n, 2), np.float32)
    scales = np.zeros((n,), np.float32)
    for i, e in enumerate(entries):
        im_bgr = load_image_bgr(e["image"], False)
        scale = compute_im_scale(e["height"], e["width"], cfg.TEST.SCALES[0],
                                 cfg.TEST.MAX_SIZE)
        scale = min(scale, ch / float(e["height"]), cw / float(e["width"]))
        im = resize_bgr_u8(im_bgr, scale)
        h, w = im.shape[:2]
        data[i, :h, :w] = im
        im_hw[i] = (e["height"], e["width"])
        content_hw[i] = (h, w)
        scales[i] = scale
    return {"data": data, "im_hw": im_hw, "im_scale": scales, "content_hw": content_hw}


def run_inference_on_roidb(cfg, model, roidb: List[dict],
                           contiguous_to_json: Dict[int, int],
                           batch_size: int = 8) -> List[Dict]:
    """COCO-format detection dicts for every image of roidb."""
    if cfg.MODEL.TYPE not in ("retinanet", "distillation"):
        raise NotImplementedError(f"MODEL.TYPE={cfg.MODEL.TYPE!r} inference is not ported")
    infer = make_inference_fn(cfg, model)
    dev = next(model.parameters()).device
    land, port = _test_canvas_shapes(cfg)
    groups = {"l": [], "p": []}
    for e in roidb:
        groups["l" if e["width"] >= e["height"] else "p"].append(e)

    detections: List[Dict] = []
    seconds, batches = 0.0, 0
    for key, canvas in (("l", land), ("p", port)):
        entries = groups[key]
        for i in range(0, len(entries), batch_size):
            chunk = entries[i:i + batch_size]
            # pad the final chunk to the static batch size
            batch_entries = chunk + [chunk[-1]] * (batch_size - len(chunk))
            host = prepare_test_batch(cfg, batch_entries, canvas)
            t0 = time.perf_counter()
            t = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
            out = infer(t["data"], t["im_hw"], t["im_scale"], t["content_hw"])
            boxes, scores, classes, valid = (
                out[k].cpu().numpy() for k in ("boxes", "scores", "classes", "valid"))
            seconds += time.perf_counter() - t0
            batches += 1
            for j, e in enumerate(chunk):
                for b, s, c, v in zip(boxes[j], scores[j], classes[j], valid[j]):
                    if not v:
                        continue
                    x1, y1, x2, y2 = (float(x) for x in b)
                    detections.append({
                        "image_id": e["id"],
                        "category_id": contiguous_to_json[int(c)],
                        # xyxy (legacy +1 extents) -> COCO xywh
                        "bbox": [x1, y1, x2 - x1 + 1.0, y2 - y1 + 1.0],
                        "score": float(s),
                    })
            if (i // batch_size) % 10 == 0:
                logger.info("inference %s: %d/%d (avg %.3fs/batch)", key,
                            i + len(chunk), len(entries), seconds / batches)
    return detections


def generate_pseudo_labels(cfg, model, dataset_name: str, out_json: str,
                           score_thresh: float = 0.5, batch_size: int = 8) -> str:
    """The teacher's pseudo-label writer: a COCO-format annotation json over
    an unlabeled dataset (the reference's semi-supervised flow, SURVEY.md
    §3.4), usable as a catalog entry for DISTILLATION.UNLABEL_DATASETS."""
    ds = CocoDataset(dataset_name)
    roidb = ds.get_roidb(include_gt=False)
    dets = run_inference_on_roidb(cfg, model, roidb, ds.contiguous_to_json, batch_size)
    anns = []
    for i, d in enumerate(dets):
        if d["score"] < score_thresh:
            continue
        x, y, w, h = d["bbox"]
        anns.append({
            "id": i + 1,
            "image_id": d["image_id"],
            "category_id": d["category_id"],
            "bbox": d["bbox"],
            "area": float(w * h),
            "iscrowd": 0,
            "score": d["score"],  # kept for filtering and inspection
        })
    out = {
        "images": ds.dataset["images"],
        "categories": ds.dataset["categories"],
        "annotations": anns,
    }
    os.makedirs(os.path.dirname(out_json) or ".", exist_ok=True)
    with open(out_json, "w") as f:
        json.dump(out, f)
    logger.info("Wrote %d pseudo annotations for %d images -> %s",
                len(anns), len(ds.dataset["images"]), out_json)
    return out_json
