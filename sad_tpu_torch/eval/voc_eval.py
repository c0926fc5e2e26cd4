"""PASCAL VOC-protocol detection evaluation (a copy of
sad_tpu/eval/voc_eval.py; ref detectron/lib/datasets/voc_eval.py and
voc_dataset_evaluator.py).

Per-class AP at IoU 0.5 with the VOC07 11-point metric or the continuous
(area under the PR curve) one, over the detection dicts of the COCO
evaluator. 'difficult' and crowd ground truth are ignored: a detection
matched to one counts neither as a true nor as a false positive.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Sequence

import numpy as np


def voc_ap(recall: np.ndarray, precision: np.ndarray, use_07_metric: bool = False) -> float:
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = precision[recall >= t].max() if (recall >= t).any() else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([0.0], precision, [0.0]))
    for i in range(len(mpre) - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def voc_eval_boxes(
    gt_dataset: Dict,
    detections: Sequence[Dict],
    iou_thresh: float = 0.5,
    use_07_metric: bool = False,
) -> Dict[str, float]:
    """Per-class VOC AP over COCO-format gt/detections. gt boxes xywh;
    'difficult'/'iscrowd' gt are ignored (neither matched-counted nor FP)."""
    cats = sorted(c["id"] for c in gt_dataset.get("categories", []))
    gts = defaultdict(list)
    for a in gt_dataset.get("annotations", []):
        gts[(a["image_id"], a["category_id"])].append(a)

    aps = {}
    for cat in cats:
        cat_dets = sorted(
            (d for d in detections if d["category_id"] == cat),
            key=lambda d: -d["score"],
        )
        npos = sum(
            1
            for (img, c), anns in gts.items()
            if c == cat
            for a in anns
            if not a.get("difficult", 0) and not a.get("iscrowd", 0)
        )
        matched = defaultdict(set)
        tp = np.zeros(len(cat_dets))
        fp = np.zeros(len(cat_dets))
        for i, det in enumerate(cat_dets):
            anns = gts.get((det["image_id"], cat), [])
            best_iou, best_j = 0.0, -1
            dx, dy, dw, dh = det["bbox"]
            for j, a in enumerate(anns):
                gx, gy, gw, gh = a["bbox"]
                ix = max(0.0, min(dx + dw, gx + gw) - max(dx, gx))
                iy = max(0.0, min(dy + dh, gy + gh) - max(dy, gy))
                inter = ix * iy
                union = dw * dh + gw * gh - inter
                iou = inter / union if union > 0 else 0.0
                if iou > best_iou:
                    best_iou, best_j = iou, j
            if best_iou >= iou_thresh and best_j >= 0:
                ann = anns[best_j]
                if ann.get("difficult", 0) or ann.get("iscrowd", 0):
                    continue  # ignore
                if best_j in matched[det["image_id"]]:
                    fp[i] = 1
                else:
                    matched[det["image_id"]].add(best_j)
                    tp[i] = 1
            else:
                fp[i] = 1
        if npos == 0:
            continue
        tp_c = np.cumsum(tp)
        fp_c = np.cumsum(fp)
        rec = tp_c / npos
        prec = tp_c / np.maximum(tp_c + fp_c, np.finfo(np.float64).eps)
        aps[f"AP_cat{cat}"] = voc_ap(rec, prec, use_07_metric)
    out = dict(aps)
    out["mAP"] = float(np.mean(list(aps.values()))) if aps else 0.0
    return out
