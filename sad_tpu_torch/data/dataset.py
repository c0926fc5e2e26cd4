"""COCO-JSON dataset layer (self-contained; no pycocotools).

A copy of sad_tpu/data/dataset.py. Segmentations are kept and flipped for
Mask R-CNN training (utils/segms.py); keypoints are kept, and flipped with
the left/right channel swap of the category's keypoint names, for Keypoint
R-CNN training (utils/keypoints.py).

Capability-equivalent to detectron/lib/datasets/json_dataset.py +
roidb.py, parsing the COCO instance json directly:
- category ids mapped to contiguous [1, C-1] in sorted-id order
  (json_dataset.py builds the same map via the COCO API),
- gt boxes converted xywh -> xyxy with the legacy clip (x2 = x+max(0,w-1),
  clipped to the image), invalid boxes dropped,
- crowd regions kept with is_crowd=1 (excluded from RetinaNet targets at
  assignment time, roi_data/retinanet.py:117-118),
- horizontal-flip augmentation entries (roidb.py:89 extend_with_flipped),
- training filter: RetinaNet requires >=1 non-crowd gt per image
  (retinanet.py:119-120); empty images are dropped (roidb.py:123
  filter_for_training),
- multi-dataset union for the labeled+pseudo-labeled semi-supervised mix
  (roidb.py:37 combined_roidb_for_training): train/train_loop.py takes
  DISTILLATION.UNLABEL_DATASETS through it as the second stream. A
  pseudo-labeled set (eval/test_engine.generate_pseudo_labels, registered
  with is_pseudo_labeled=True) reads as any COCO json (its per-box "score"
  is ignored), and the training filter drops its images with no pseudo box.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence

import numpy as np

from ..config.catalog import DatasetSpec, get_dataset_spec
from ..utils.keypoints import flip_idx_for_names, flip_keypoint_channels

class CocoDataset:
    def __init__(self, spec_or_name):
        self.spec: DatasetSpec = (
            spec_or_name
            if isinstance(spec_or_name, DatasetSpec)
            else get_dataset_spec(spec_or_name)
        )
        with open(self.spec.annotation_file, "r") as f:
            self.dataset = json.load(f)
        cats = self.dataset.get("categories", [])
        self.category_ids = sorted(c["id"] for c in cats)
        # contiguous class ids: 1..C-1 (0 = background)
        self.json_to_contiguous = {
            cid: i + 1 for i, cid in enumerate(self.category_ids)
        }
        self.contiguous_to_json = {v: k for k, v in self.json_to_contiguous.items()}
        self.classes = ["__background__"] + [
            c["name"] for c in sorted(cats, key=lambda c: c["id"])
        ]
        self.num_classes = len(self.classes)

        # keypoint metadata: the flip permutation comes from the category's
        # keypoint-name list (json_dataset.py keeps dataset.keypoints +
        # keypoint_flip_map; roidb.py applies it to every flipped entry)
        self.keypoints = None
        self.keypoint_flip_idx = None
        for c in cats:
            if c.get("keypoints"):
                self.keypoints = list(c["keypoints"])
                self.keypoint_flip_idx = flip_idx_for_names(self.keypoints)
                break

        self._images = {im["id"]: im for im in self.dataset.get("images", [])}
        self._anns_by_image: Dict[int, List[dict]] = {}
        for ann in self.dataset.get("annotations", []):
            self._anns_by_image.setdefault(ann["image_id"], []).append(ann)

    @property
    def name(self) -> str:
        return self.spec.name

    def image_path(self, entry: dict) -> str:
        return os.path.join(self.spec.image_directory, entry["file_name"])

    def get_roidb(
        self, include_gt: bool = True, gt_min_area: float = -1
    ) -> List[dict]:
        roidb = []
        for img_id in sorted(self._images):
            im = self._images[img_id]
            entry = {
                "id": img_id,
                "dataset_name": self.spec.name,
                "file_name": im["file_name"],
                "image": os.path.join(self.spec.image_directory, im["file_name"]),
                "height": im["height"],
                "width": im["width"],
                "flipped": False,
                "boxes": np.zeros((0, 4), np.float32),
                "gt_classes": np.zeros((0,), np.int32),
                "is_crowd": np.zeros((0,), bool),
                "segms": [],
                "gt_keypoints": np.zeros((0, 17, 3), np.float32),
            }
            if include_gt:
                self._add_gt(entry, gt_min_area)
            roidb.append(entry)
        return roidb

    def _add_gt(self, entry: dict, gt_min_area: float = -1) -> None:
        h, w = entry["height"], entry["width"]
        boxes, classes, crowd, segms, kps = [], [], [], [], []
        for ann in self._anns_by_image.get(entry["id"], []):
            if ann.get("ignore", 0):
                continue
            if ann.get("area", 0) < gt_min_area:  # TRAIN.GT_MIN_AREA knob
                continue
            x, y, bw, bh = ann["bbox"]
            x1 = max(0.0, x)
            y1 = max(0.0, y)
            x2 = min(w - 1.0, x + max(0.0, bw - 1.0))
            y2 = min(h - 1.0, y + max(0.0, bh - 1.0))
            if ann.get("area", bw * bh) > 0 and x2 >= x1 and y2 >= y1:
                boxes.append([x1, y1, x2, y2])
                classes.append(self.json_to_contiguous[ann["category_id"]])
                crowd.append(bool(ann.get("iscrowd", 0)))
                seg = ann.get("segmentation", [])
                if isinstance(seg, list):
                    # valid polygons have >= 3 points (json_dataset.py:178-182)
                    segms.append([p for p in seg if len(p) >= 6])
                else:
                    # crowd (and some instance) regions are RLE dicts — kept
                    # as-is like the reference (json_dataset.py:197)
                    segms.append(seg if isinstance(seg, dict) else [])
                k = ann.get("keypoints")
                kps.append(
                    np.asarray(k, np.float32).reshape(-1, 3)
                    if k
                    else np.zeros((0, 3), np.float32)
                )
        if boxes:
            entry["boxes"] = np.asarray(boxes, np.float32)
            entry["gt_classes"] = np.asarray(classes, np.int32)
            entry["is_crowd"] = np.asarray(crowd, bool)
            entry["segms"] = segms
            nk = max((len(k) for k in kps), default=0)
            if nk:
                arr = np.zeros((len(kps), nk, 3), np.float32)
                for i, k in enumerate(kps):
                    arr[i, : len(k)] = k
                entry["gt_keypoints"] = arr
                if (
                    self.keypoint_flip_idx is not None
                    and len(self.keypoint_flip_idx) == nk
                ):
                    entry["kp_flip_idx"] = self.keypoint_flip_idx


def flip_entry(entry: dict) -> dict:
    """Horizontally-flipped copy (roidb.py extend_with_flipped_entries)."""
    w = entry["width"]
    boxes = entry["boxes"].copy()
    x1 = boxes[:, 0].copy()
    x2 = boxes[:, 2].copy()
    boxes[:, 0] = w - x2 - 1
    boxes[:, 2] = w - x1 - 1
    out = dict(entry)
    out["boxes"] = boxes
    out["flipped"] = True
    if entry.get("segms"):
        from ..utils.segms import flip_segm

        out["segms"] = [flip_segm(s, w) for s in entry["segms"]]
    kp = entry.get("gt_keypoints")
    if kp is not None and len(kp):
        # left/right channels swap under a horizontal flip (ref:
        # keypoints.py:71-86 flip_keypoints via the dataset flip map,
        # applied per flipped roidb entry in roidb.py)
        idx = entry.get("kp_flip_idx")
        if idx is None and kp.shape[1] == 17:
            idx = flip_keypoint_channels()
        kp = kp[:, idx].copy() if idx is not None else kp.copy()
        vis = kp[..., 2] > 0
        kp[..., 0] = np.where(vis, w - kp[..., 0] - 1, 0.0)
        out["gt_keypoints"] = kp
    return out


def filter_for_training(
    roidb: List[dict], require_keypoints: bool = False
) -> List[dict]:
    """Keep images with at least one non-crowd gt (retinanet.py:119).
    With keypoint training, the reference additionally drops images with
    no visible keypoints (roidb.py filter_for_training
    `has_visible_keypoints` when cfg.MODEL.KEYPOINTS_ON)."""

    def ok(e):
        valid = (e["gt_classes"] > 0) & (~e["is_crowd"])
        if not valid.any():
            return False
        if require_keypoints:
            kp = e.get("gt_keypoints")
            return kp is not None and len(kp) > 0 and (kp[..., 2] > 0).any()
        return True

    kept = [e for e in roidb if ok(e)]
    return kept


def combined_roidb_for_training(
    dataset_names: Sequence[str],
    use_flipped: bool = True,
    gt_min_area: float = -1,
    require_keypoints: bool = False,
) -> List[dict]:
    """Union of datasets + flips + filtering (roidb.py:37-149)."""
    roidb: List[dict] = []
    for name in dataset_names:
        ds = CocoDataset(name)
        roidb.extend(ds.get_roidb(include_gt=True, gt_min_area=gt_min_area))
    if use_flipped:
        roidb = roidb + [flip_entry(e) for e in roidb]
    return filter_for_training(roidb, require_keypoints=require_keypoints)
