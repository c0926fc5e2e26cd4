"""PASCAL VOC dataset layer (a copy of sad_tpu/data/voc_dataset.py).

The reference's VOC entries (dataset_catalog.py, the input side of
voc_dataset_evaluator.py): a VOC devkit's XML annotations parsed into the
roidb and COCO-style structures the rest of the port consumes, so training
and both evaluators (the COCO protocol and the VOC one) run on VOC data.
``as_coco_gt`` writes the COCO-format ground truth a catalog entry
(config/catalog.py ``voc_<year>_<split>``) points at.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Sequence

import numpy as np

VOC_CLASSES = [
    "__background__", "aeroplane", "bicycle", "bird", "boat", "bottle",
    "bus", "car", "cat", "chair", "cow", "diningtable", "dog", "horse",
    "motorbike", "person", "pottedplant", "sheep", "sofa", "train",
    "tvmonitor",
]


class VOCDataset:
    """devkit_root/VOC{year}/{Annotations,JPEGImages,ImageSets/Main}."""

    def __init__(self, devkit_root: str, year: str = "2007", split: str = "trainval"):
        self.root = os.path.join(devkit_root, f"VOC{year}")
        self.year = year
        self.split = split
        self.classes = list(VOC_CLASSES)
        self.num_classes = len(self.classes)
        self._class_to_id = {n: i for i, n in enumerate(self.classes)}
        list_file = os.path.join(self.root, "ImageSets", "Main", f"{split}.txt")
        with open(list_file) as f:
            self.image_ids = [line.strip() for line in f if line.strip()]
        # COCO-style contiguous mapping (identity for VOC)
        self.json_to_contiguous = {i: i for i in range(1, self.num_classes)}
        self.contiguous_to_json = dict(self.json_to_contiguous)

    def get_roidb(self, include_gt: bool = True) -> List[dict]:
        roidb = []
        for idx, name in enumerate(self.image_ids):
            ann_path = os.path.join(self.root, "Annotations", f"{name}.xml")
            entry = self._parse(ann_path, include_gt)
            entry["id"] = idx + 1
            entry["file_name"] = f"{name}.jpg"
            entry["image"] = os.path.join(self.root, "JPEGImages", f"{name}.jpg")
            entry["dataset_name"] = f"voc_{self.year}_{self.split}"
            entry["flipped"] = False
            roidb.append(entry)
        return roidb

    def _parse(self, ann_path: str, include_gt: bool) -> dict:
        tree = ET.parse(ann_path)
        size = tree.find("size")
        h = int(size.find("height").text)
        w = int(size.find("width").text)
        boxes, classes, crowd, difficult = [], [], [], []
        if include_gt:
            for obj in tree.findall("object"):
                cls = obj.find("name").text.strip().lower()
                if cls not in self._class_to_id:
                    continue
                bb = obj.find("bndbox")
                # VOC coords are 1-based inclusive
                x1 = float(bb.find("xmin").text) - 1
                y1 = float(bb.find("ymin").text) - 1
                x2 = float(bb.find("xmax").text) - 1
                y2 = float(bb.find("ymax").text) - 1
                boxes.append([max(0, x1), max(0, y1), min(w - 1, x2), min(h - 1, y2)])
                classes.append(self._class_to_id[cls])
                d = obj.find("difficult")
                difficult.append(bool(int(d.text)) if d is not None else False)
                crowd.append(False)
        n = len(boxes)
        return {
            "height": h,
            "width": w,
            "boxes": np.asarray(boxes, np.float32).reshape(n, 4),
            "gt_classes": np.asarray(classes, np.int32),
            "is_crowd": np.asarray(crowd, bool),
            "difficult": np.asarray(difficult, bool),
            "segms": [],
            "gt_keypoints": np.zeros((0, 17, 3), np.float32),
        }

    def as_coco_gt(self, roidb: Optional[Sequence[dict]] = None) -> Dict:
        """COCO-format gt dict so the evaluators run on VOC directly
        ('difficult' objects become ignore via the 'difficult' ann flag the
        VOC evaluator honors)."""
        roidb = roidb if roidb is not None else self.get_roidb()
        images, anns = [], []
        aid = 1
        for e in roidb:
            images.append(
                {"id": e["id"], "height": e["height"], "width": e["width"],
                 "file_name": e["file_name"]}
            )
            for b, c, d in zip(e["boxes"], e["gt_classes"], e["difficult"]):
                x1, y1, x2, y2 = (float(v) for v in b)
                anns.append(
                    {
                        "id": aid,
                        "image_id": e["id"],
                        "category_id": int(c),
                        "bbox": [x1, y1, x2 - x1 + 1, y2 - y1 + 1],
                        "area": (x2 - x1 + 1) * (y2 - y1 + 1),
                        "iscrowd": 0,
                        "difficult": bool(d),
                    }
                )
                aid += 1
        cats = [
            {"id": i, "name": n}
            for i, n in enumerate(self.classes)
            if i > 0
        ]
        return {"images": images, "annotations": anns, "categories": cats}
