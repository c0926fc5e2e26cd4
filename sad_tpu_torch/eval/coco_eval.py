"""Self-contained COCO-protocol bbox evaluation (numpy).

A copy of sad_tpu/eval/coco_eval.py, whole: bbox, segm and keypoints, with
the segmentation helpers taken from the port's utils/segms.py.

Replaces the reference's pycocotools dependency
(lib/datasets/json_dataset_evaluator.py) with a from-scratch implementation of
the COCO bbox evaluation protocol — pycocotools is not available in this
environment, and the evaluator is part of the framework surface anyway
(SURVEY.md §2.1 'Evaluation'). Implements the standard COCOeval semantics:

- IoU thresholds 0.50:0.05:0.95, 101-point interpolated precision,
- per-category / per-area-range / per-maxDets accumulation,
- crowd regions: IoU = intersection / det-area, matchable many times,
  never counted as FP,
- ignore propagation: dets matched to ignored gt are ignored; unmatched dets
  outside the area range are ignored.

Box convention: COCO xywh, areas w*h (no +1 — evaluation convention differs
from the detector's internal legacy +1 convention on purpose; pycocotools
does the same).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.segms import polygon_area, polys_to_mask, rle_string_to_counts, rle_to_mask

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNGS = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


def _gt_area(g: Dict) -> float:
    """GT area for the small/medium/large split: the annotation's 'area'
    field (segmentation area in COCO) when present, else bbox w*h."""
    a = g.get("area")
    return float(a) if a is not None else float(g["bbox"][2] * g["bbox"][3])


def _iou_xywh(dt: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """(D, G) IoU; crowd gt uses intersection / det area."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    dx1, dy1 = dt[:, 0], dt[:, 1]
    dx2, dy2 = dt[:, 0] + dt[:, 2], dt[:, 1] + dt[:, 3]
    gx1, gy1 = gt[:, 0], gt[:, 1]
    gx2, gy2 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    iw = np.clip(
        np.minimum(dx2[:, None], gx2[None, :]) - np.maximum(dx1[:, None], gx1[None, :]),
        0, None,
    )
    ih = np.clip(
        np.minimum(dy2[:, None], gy2[None, :]) - np.maximum(dy1[:, None], gy1[None, :]),
        0, None,
    )
    inter = iw * ih
    d_area = (dt[:, 2] * dt[:, 3])[:, None]
    g_area = (gt[:, 2] * gt[:, 3])[None, :]
    union = np.where(iscrowd[None, :], d_area, d_area + g_area - inter)
    return np.where(union > 0, inter / union, 0.0)


def _seg_to_mask(seg, h, w):
    """Decode a COCO segmentation — uncompressed RLE dict or polygon list."""
    if isinstance(seg, dict):
        return rle_to_mask(seg).astype(bool)
    return polys_to_mask(seg, h, w).astype(bool)


def _rle_iou(dt_segs, gt_segs, iscrowd, hw):
    """Mask IoU matrix (pycocotools semantics: crowd gt uses
    intersection / det area). Accepts RLE dicts or polygon lists."""
    h, w = hw
    d_masks = [_seg_to_mask(s, h, w) for s in dt_segs]
    g_masks = [_seg_to_mask(s, h, w) for s in gt_segs]
    out = np.zeros((len(d_masks), len(g_masks)))
    for i, dm in enumerate(d_masks):
        da = dm.sum()
        for j, gm in enumerate(g_masks):
            inter = np.logical_and(dm, gm).sum()
            union = da if iscrowd[j] else da + gm.sum() - inter
            out[i, j] = inter / union if union > 0 else 0.0
    return out


# COCO OKS per-keypoint constants (person category; pycocotools sigmas)
COCO_KPT_SIGMAS = np.array([
    .26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62,
    1.07, 1.07, .87, .87, .89, .89,
]) / 10.0


def _oks_iou(dt_kps, gt_anns, sigmas=None):
    """OKS matrix (D, G): exp(-d^2 / (2 s^2 k^2)) averaged over labeled
    keypoints (pycocotools computeOks semantics)."""
    g_count = len(gt_anns)
    d_count = len(dt_kps)
    out = np.zeros((d_count, g_count))
    for j, g in enumerate(gt_anns):
        gk = np.asarray(g["keypoints"], np.float64).reshape(-1, 3)
        k = len(gk)
        sig = sigmas if sigmas is not None else (
            COCO_KPT_SIGMAS if k == 17 else np.full(k, 0.05)
        )
        vars_ = (sig * 2) ** 2
        vis = gk[:, 2] > 0
        area = max(float(g.get("area", 1.0)), 1.0)
        for i, d in enumerate(dt_kps):
            dk = np.asarray(d, np.float64).reshape(-1, 3)[:k]
            dx = dk[:, 0] - gk[:, 0]
            dy = dk[:, 1] - gk[:, 1]
            e = (dx ** 2 + dy ** 2) / vars_ / (area + np.spacing(1)) / 2.0
            if vis.any():
                out[i, j] = np.mean(np.exp(-e[vis]))
    return out


class COCOEvaluator:
    """Evaluate detections against COCO-format ground truth.

    gt_dataset: dict with 'images', 'annotations', 'categories' (COCO json).
    Detections: {'image_id', 'category_id', 'score', 'bbox' xywh} and, for
    iou_type='segm', 'segmentation' as uncompressed RLE. iou_type selects
    box or mask IoU (the reference evaluates both via pycocotools;
    json_dataset_evaluator.py).
    """

    def __init__(self, gt_dataset: Dict, iou_type: str = "bbox",
                 area_rngs: Optional[Dict] = None,
                 max_dets: Optional[Tuple[int, ...]] = None):
        self.iou_type = iou_type
        # overridable for VID-style protocols (ref: vid_eval.py:507-516,
        # same structure with a 1e5^2 area cap)
        if iou_type == "keypoints":
            # pycocotools keypoint-task protocol: maxDets [20], area ranges
            # all/medium/large (no 'small' — OKS sigmas make tiny-person
            # evaluation meaningless)
            default_areas = {
                k: v for k, v in AREA_RNGS.items() if k != "small"
            }
            default_max_dets = (20,)
        else:
            default_areas = dict(AREA_RNGS)
            default_max_dets = MAX_DETS
        self.area_rngs = dict(area_rngs) if area_rngs else default_areas
        self.max_dets = tuple(max_dets) if max_dets else default_max_dets
        self.cat_ids = sorted(c["id"] for c in gt_dataset.get("categories", []))
        self.img_ids = sorted(im["id"] for im in gt_dataset.get("images", []))
        self._img_hw = {
            im["id"]: (im.get("height", 0), im.get("width", 0))
            for im in gt_dataset.get("images", [])
        }
        self._gt = defaultdict(list)  # (img_id, cat_id) -> list of anns
        for ann in gt_dataset.get("annotations", []):
            # every ann stays in the pool; ignore status is derived per
            # area-range in _evaluate_img_cat exactly as pycocotools does
            # (an explicit 'ignore' field is clobbered by iscrowd there)
            self._gt[(ann["image_id"], ann["category_id"])].append(ann)

    # ------------------------------------------------------------- matching

    def _dt_area(self, d: Dict) -> float:
        """Det area for the small/medium/large split: mask area for segm
        (pycocotools maskUtils.area on the det's RLE) — uncompressed RLE,
        compressed RLE string, or polygons (shoelace; pycocotools
        rasterizes, so polygon areas agree to sub-pixel) — else bbox w*h."""
        if self.iou_type == "segm" and "segmentation" in d:
            seg = d["segmentation"]
            if isinstance(seg, dict):
                counts = seg.get("counts")
                if isinstance(counts, (bytes, str)):
                    counts = rle_string_to_counts(counts)
                if counts is not None:
                    return float(sum(counts[1::2]))  # RLE fg area
            elif isinstance(seg, (list, tuple)) and seg:
                return float(sum(polygon_area(p) for p in seg))
        return float(d["bbox"][2] * d["bbox"][3])

    def _evaluate_img_cat(
        self, dts: List[Dict], gts: List[Dict], area_rng: Tuple[float, float],
        max_det: int,
    ) -> Optional[Dict]:
        if len(dts) == 0 and len(gts) == 0:
            return None
        # gt ignore flags, matching pycocotools _prepare EXACTLY: the
        # explicit 'ignore' annotation field is CLOBBERED by iscrowd for
        # bbox/segm (`gt['ignore'] = 'iscrowd' in gt and gt['iscrowd']`) and
        # only contributes through the keypoint branch
        # (`(num_keypoints == 0) or gt['ignore']`, where gt['ignore'] is
        # already the iscrowd value). Outside-area-range gts are ignored in
        # evaluateImg. Area is the annotation's 'area' field when present
        # (for COCO that is the SEGMENTATION area — pycocotools uses it for
        # the gt side of the small/medium/large split), else bbox w*h.
        g_ignore = np.array(
            [
                bool(g.get("iscrowd", 0))
                or _gt_area(g) < area_rng[0]
                or _gt_area(g) > area_rng[1]
                or (
                    self.iou_type == "keypoints"
                    and int(g.get("num_keypoints", 1)) == 0
                )
                for g in gts
            ],
            dtype=bool,
        )
        # sort gts: non-ignored first (pycocotools order)
        g_order = np.argsort(g_ignore, kind="stable")
        gts = [gts[i] for i in g_order]
        g_ignore = g_ignore[g_order]
        iscrowd = np.array([bool(g.get("iscrowd", 0)) for g in gts], dtype=bool)

        dts = sorted(dts, key=lambda d: -d["score"])[:max_det]
        if self.iou_type == "keypoints":
            ious = _oks_iou([d["keypoints"] for d in dts], gts)
        elif self.iou_type == "segm":
            img_id = dts[0]["image_id"] if dts else gts[0]["image_id"]
            ious = _rle_iou(
                [d["segmentation"] for d in dts],
                [g["segmentation"] for g in gts],
                iscrowd,
                self._img_hw.get(img_id, (0, 0)),
            )
        else:
            d_boxes = np.array([d["bbox"] for d in dts], dtype=np.float64).reshape(-1, 4)
            g_boxes = np.array([g["bbox"] for g in gts], dtype=np.float64).reshape(-1, 4)
            ious = _iou_xywh(d_boxes, g_boxes, iscrowd)

        T, D, G = len(IOU_THRS), len(dts), len(gts)
        dt_m = np.zeros((T, D), dtype=np.int64)  # matched gt index + 1, 0 = none
        gt_m = np.zeros((T, G), dtype=np.int64)
        dt_ig = np.zeros((T, D), dtype=bool)

        for ti, t in enumerate(IOU_THRS):
            for di in range(D):
                best_iou = min(t, 1 - 1e-10)
                best_g = -1
                for gi in range(G):
                    if gt_m[ti, gi] > 0 and not iscrowd[gi]:
                        continue
                    # stop at ignored gts once a non-ignored match is found
                    if best_g > -1 and not g_ignore[best_g] and g_ignore[gi]:
                        break
                    if ious[di, gi] < best_iou:
                        continue
                    best_iou = ious[di, gi]
                    best_g = gi
                if best_g == -1:
                    continue
                dt_ig[ti, di] = g_ignore[best_g]
                dt_m[ti, di] = best_g + 1
                gt_m[ti, best_g] = di + 1

        # unmatched dets outside the area range are ignored (pycocotools
        # loadRes: det area = bbox w*h for bbox eval, mask area for segm)
        d_areas = [self._dt_area(d) for d in dts]
        d_out = np.array(
            [a < area_rng[0] or a > area_rng[1] for a in d_areas], dtype=bool
        )
        dt_ig = np.logical_or(dt_ig, (dt_m == 0) & d_out[None, :])
        return {
            "dt_scores": np.array([d["score"] for d in dts]),
            "dt_matches": dt_m,
            "dt_ignore": dt_ig,
            "gt_ignore": g_ignore,
            "num_gt": int((~g_ignore).sum()),
        }

    # ----------------------------------------------------------- accumulate

    def evaluate(
        self, detections: Sequence[Dict], verbose: bool = False
    ) -> Dict[str, float]:
        dts_by_key = defaultdict(list)
        for d in detections:
            dts_by_key[(d["image_id"], d["category_id"])].append(d)

        K = len(self.cat_ids)
        A = len(self.area_rngs)
        M = len(self.max_dets)
        T, R = len(IOU_THRS), len(REC_THRS)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))

        area_items = list(self.area_rngs.items())
        max_md = max(self.max_dets)
        for ki, cat in enumerate(self.cat_ids):
            for ai, (_, rng) in enumerate(area_items):
                # match once per (img, cat, area) at the largest maxDet; the
                # smaller maxDets are per-image prefixes of the same greedy
                # matching (dets are score-sorted), sliced at accumulate —
                # the same structure pycocotools uses.
                full_evals = [
                    self._evaluate_img_cat(
                        dts_by_key.get((img, cat), []),
                        self._gt.get((img, cat), []),
                        rng,
                        max_md,
                    )
                    for img in self.img_ids
                ]
                full_evals = [e for e in full_evals if e is not None]
                if not full_evals:
                    continue
                npig = sum(e["num_gt"] for e in full_evals)
                if npig == 0:
                    continue
                for mi, max_det in enumerate(self.max_dets):
                    evals = full_evals
                    scores = np.concatenate(
                        [e["dt_scores"][:max_det] for e in evals]
                    )
                    order = np.argsort(-scores, kind="mergesort")
                    dtm = np.concatenate(
                        [e["dt_matches"][:, :max_det] for e in evals], axis=1
                    )[:, order]
                    dtig = np.concatenate(
                        [e["dt_ignore"][:, :max_det] for e in evals], axis=1
                    )[:, order]
                    tps = (dtm > 0) & ~dtig
                    fps = (dtm == 0) & ~dtig
                    tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                    for ti in range(T):
                        tp, fp = tp_sum[ti], fp_sum[ti]
                        nd = len(tp)
                        rc = tp / npig
                        pr = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
                        recall[ti, ki, ai, mi] = rc[-1] if nd else 0.0
                        # monotone-decreasing interpolation
                        pr = pr.tolist()
                        for i in range(nd - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        q = np.zeros((R,))
                        for ri, pi in enumerate(inds):
                            if pi < nd:
                                q[ri] = pr[pi]
                        precision[ti, :, ki, ai, mi] = q

        def _summ(prec=True, iou=None, area="all", max_det=100):
            if area not in self.area_rngs:
                return -1.0  # e.g. APs under the keypoint protocol
            if max_det not in self.max_dets:
                # Same treatment as a missing area: never silently summarize
                # at a different maxDets than the key claims (the keypoint
                # protocol has max_dets=(20,), so AR1/AR10/AR100 don't exist).
                return -1.0
            ai = list(self.area_rngs).index(area)
            mi = self.max_dets.index(max_det)
            if prec:
                s = precision[:, :, :, ai, mi]
                if iou is not None:
                    s = s[np.where(np.isclose(IOU_THRS, iou))[0]]
            else:
                s = recall[:, :, ai, mi]
                if iou is not None:
                    s = s[np.where(np.isclose(IOU_THRS, iou))[0]]
            s = s[s > -1]
            return float(np.mean(s)) if s.size else -1.0

        if self.iou_type == "keypoints":
            # pycocotools keypoint protocol (cocoeval.py summarizeKps):
            # everything at maxDets=20; AR50/AR75 instead of AR1/AR10.
            md = self.max_dets[-1]
            results = {
                "AP": _summ(max_det=md),
                "AP50": _summ(iou=0.5, max_det=md),
                "AP75": _summ(iou=0.75, max_det=md),
                "APm": _summ(area="medium", max_det=md),
                "APl": _summ(area="large", max_det=md),
                "AR": _summ(prec=False, max_det=md),
                "AR50": _summ(prec=False, iou=0.5, max_det=md),
                "AR75": _summ(prec=False, iou=0.75, max_det=md),
                "ARm": _summ(prec=False, area="medium", max_det=md),
                "ARl": _summ(prec=False, area="large", max_det=md),
            }
        else:
            results = {
                "AP": _summ(),
                "AP50": _summ(iou=0.5),
                "AP75": _summ(iou=0.75),
                "APs": _summ(area="small"),
                "APm": _summ(area="medium"),
                "APl": _summ(area="large"),
                "AR1": _summ(prec=False, max_det=1),
                "AR10": _summ(prec=False, max_det=10),
                "AR100": _summ(prec=False, max_det=100),
                "ARs": _summ(prec=False, area="small"),
                "ARm": _summ(prec=False, area="medium"),
                "ARl": _summ(prec=False, area="large"),
            }
        if verbose:
            for k, v in results.items():
                print(f"  {k}: {v:.4f}")
        return results


def evaluate_boxes(gt_dataset: Dict, detections: Sequence[Dict]) -> Dict[str, float]:
    return COCOEvaluator(gt_dataset).evaluate(detections)
