"""RPN proposals over a dataset, attaching them to a roidb, and their recall
(ref: sad_tpu/eval/rpn_generator.py; detectron/lib/core/rpn_generator.py and
json_dataset_evaluator.py evaluate_box_proposals).

``generate_rpn_on_dataset`` runs a model's proposal stage (MODEL.TYPE 'rpn',
or any FPN GeneralizedRCNN) batched on the card over a dataset and writes
the proposals as a pickle {boxes: [per-image (K, 4)], scores: [...], ids:
[...]} in original-image coordinates, the file that TRAIN / TEST
.PROPOSAL_FILES of a Fast R-CNN config read back through
``add_proposals_to_roidb``. ``evaluate_box_proposals`` scores such a set's
recall against a gt roidb. The last two are host numpy.
"""

from __future__ import annotations

import logging
import os
import pickle
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.dataset import CocoDataset
from ..native import bbox_overlaps
from .inference import device_normalize
from .test_engine import _test_canvas_shapes, prepare_test_batch

logger = logging.getLogger(__name__)


def generate_rpn_on_dataset(cfg, model, dataset_name: Optional[str] = None,
                            batch_size: int = 8, output_file: Optional[str] = None
                            ) -> Dict[str, list]:
    """The model's proposals over ``dataset_name`` (cfg.TEST.DATASETS[0] by
    default), landscape images then portrait ones as the test canvases group
    them: {'boxes', 'scores', 'ids'}, each image's valid proposals divided
    back to original-image coordinates, float32 (the TEST-mode RPN; the box
    head does not run). Written as a pickle to ``output_file`` when one is
    given."""
    name = dataset_name or cfg.TEST.DATASETS[0]
    roidb = CocoDataset(name).get_roidb(include_gt=False)
    dev = next(model.parameters()).device
    land, port = _test_canvas_shapes(cfg)
    groups = {"l": [], "p": []}
    for e in roidb:
        groups["l" if e["width"] >= e["height"] else "p"].append(e)

    boxes_out, scores_out, ids_out = [], [], []
    for key, canvas in (("l", land), ("p", port)):
        entries = groups[key]
        for i in range(0, len(entries), batch_size):
            chunk = entries[i:i + batch_size]
            host = prepare_test_batch(cfg, chunk + [chunk[-1]] * (batch_size - len(chunk)),
                                      canvas)
            t = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
            with torch.inference_mode():
                images = device_normalize(cfg, t["data"], t["content_hw"])
                rois, scores, valid, _ = model.proposals(model._features(images), t["im_hw"])
            rois, scores, valid = (x.cpu().numpy() for x in (rois, scores, valid))
            for j, e in enumerate(chunk):
                m = valid[j]
                boxes_out.append((rois[j][m] / host["im_scale"][j]).astype(np.float32))
                scores_out.append(scores[j][m].astype(np.float32))
                ids_out.append(e["id"])
    out = {"boxes": boxes_out, "scores": scores_out, "ids": ids_out}
    if output_file:
        os.makedirs(os.path.dirname(output_file) or ".", exist_ok=True)
        with open(output_file, "wb") as f:
            pickle.dump(out, f, pickle.HIGHEST_PROTOCOL)
        logger.info("Wrote %d images' proposals -> %s", len(ids_out), output_file)
    return out


def _crowd_ioa(boxes: np.ndarray, crowd_boxes: np.ndarray) -> np.ndarray:
    """The largest intersection over the proposal's area with any crowd
    region: COCOmask.iou(..., iscrowd=1) as json_dataset.py
    _filter_crowd_proposals uses it."""
    areas = np.maximum((boxes[:, 2] - boxes[:, 0] + 1) * (boxes[:, 3] - boxes[:, 1] + 1), 1.0)
    out = np.zeros(len(boxes), np.float32)
    for cb in crowd_boxes:
        iw = np.maximum(np.minimum(boxes[:, 2], cb[2]) - np.maximum(boxes[:, 0], cb[0]) + 1, 0)
        ih = np.maximum(np.minimum(boxes[:, 3], cb[3]) - np.maximum(boxes[:, 1], cb[1]) + 1, 0)
        out = np.maximum(out, iw * ih / areas)
    return out


def add_proposals_to_roidb(roidb: List[dict], proposal_file: str, top_k: int = -1,
                           crowd_thresh: float = 0.0, min_size: float = 2.0) -> None:
    """Attach precomputed proposals to the roidb's entries as
    'proposal_boxes' (ref: json_dataset.py _add_proposals_from_file): clip
    to the image, drop duplicates (boxes.py unique_boxes hash) and boxes
    under ``min_size``, keep the first ``top_k``, flip for flipped entries,
    then drop the proposals inside crowd regions when ``crowd_thresh`` > 0
    (the reference marks them overlap -1, sampled as neither fg nor bg:
    dropping them trains the same)."""
    with open(proposal_file, "rb") as f:
        props = pickle.load(f, encoding="latin1")
    id_field = "indexes" if "indexes" in props else "ids"
    by_id = {i: k for k, i in enumerate(props[id_field])}
    for e in roidb:
        k = by_id.get(e["id"])
        boxes = np.asarray(props["boxes"][k] if k is not None else np.zeros((0, 4)),
                           np.float32).copy()
        if len(boxes):
            boxes[:, [0, 2]] = np.clip(boxes[:, [0, 2]], 0, e["width"] - 1.0)
            boxes[:, [1, 3]] = np.clip(boxes[:, [1, 3]], 0, e["height"] - 1.0)
            v = np.array([1, 1e3, 1e6, 1e9])
            _, uniq = np.unique(np.round(boxes).dot(v), return_index=True)
            boxes = boxes[np.sort(uniq)]
            wh = boxes[:, 2:] - boxes[:, :2] + 1.0
            boxes = boxes[(wh[:, 0] >= min_size) & (wh[:, 1] >= min_size)]
        if top_k > 0:
            boxes = boxes[:top_k]
        if e.get("flipped"):
            w = e["width"]
            x1 = boxes[:, 0].copy()
            x2 = boxes[:, 2].copy()
            boxes[:, 0] = w - x2 - 1
            boxes[:, 2] = w - x1 - 1
        # the crowd exclusion AFTER the flip: e['boxes'] is already in the
        # entry's (possibly flipped) frame, so the proposals must be too
        if crowd_thresh > 0 and len(boxes) and "is_crowd" in e:
            crowd = e["boxes"][np.asarray(e["is_crowd"], bool)]
            if len(crowd):
                boxes = boxes[_crowd_ioa(boxes, crowd.astype(np.float32)) <= crowd_thresh]
        e["proposal_boxes"] = boxes


AREA_RANGES = {
    "all": (0.0, 1e5 ** 2),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e5 ** 2),
    "96-128": (96.0 ** 2, 128.0 ** 2),
    "128-256": (128.0 ** 2, 256.0 ** 2),
    "256-512": (256.0 ** 2, 512.0 ** 2),
    "512-inf": (512.0 ** 2, 1e5 ** 2),
}


def evaluate_box_proposals(proposals: Dict[str, list], gt_roidb: List[dict],
                           thresholds: Optional[np.ndarray] = None, area: str = "all",
                           limit: Optional[int] = None) -> Dict[str, object]:
    """Proposal recall and average recall (ref: json_dataset_evaluator.py
    :237-318 evaluate_box_proposals): each image's gt boxes of the ``area``
    range (AREA_RANGES) matched greedily to the proposal that covers them
    best, recall at IoU 0.5:0.05:0.95, AR their mean. ``proposals`` is
    generate_rpn_on_dataset's dict; ``limit`` keeps an image's first
    proposals."""
    lo, hi = AREA_RANGES[area]
    by_id = {i: k for k, i in enumerate(proposals["ids"])}
    gt_overlaps = np.zeros(0, np.float32)
    num_pos = 0
    for e in gt_roidb:
        keep = (e["gt_classes"] > 0) & (~e["is_crowd"])
        gt_boxes = e["boxes"][keep]
        gt_areas = e.get("seg_areas")
        if gt_areas is not None:
            gt_areas = np.asarray(gt_areas)[keep]
        else:
            wh = gt_boxes[:, 2:] - gt_boxes[:, :2] + 1.0
            gt_areas = wh[:, 0] * wh[:, 1]
        sel = (gt_areas >= lo) & (gt_areas <= hi)
        gt_boxes = gt_boxes[sel]
        num_pos += int(sel.sum())
        k = by_id.get(e["id"])
        if k is None or len(gt_boxes) == 0:
            continue
        boxes = np.asarray(proposals["boxes"][k], np.float32)
        if limit is not None and len(boxes) > limit:
            boxes = boxes[:limit]
        if len(boxes) == 0:
            continue
        ov = bbox_overlaps(boxes, gt_boxes.astype(np.float32))
        got = np.zeros(len(gt_boxes), np.float32)
        for j in range(min(len(boxes), len(gt_boxes))):
            gt_ind = ov.max(axis=0).argmax()
            gt_ovr = ov.max(axis=0).max()
            if gt_ovr < 0:
                break
            box_ind = ov[:, gt_ind].argmax()
            got[j] = ov[box_ind, gt_ind]
            ov[box_ind, :] = -1.0
            ov[:, gt_ind] = -1.0
        gt_overlaps = np.concatenate([gt_overlaps, got])
    if thresholds is None:
        thresholds = np.arange(0.5, 0.95 + 1e-5, 0.05)
    recalls = np.asarray([(gt_overlaps >= t).sum() / max(float(num_pos), 1.0)
                          for t in thresholds])
    return {"ar": float(recalls.mean()), "recalls": recalls,
            "thresholds": np.asarray(thresholds), "num_pos": num_pos}
