"""Convert raw Cityscapes gtFine annotations to COCO instance-segmentation
json (a copy of sad_tpu/tools/convert_cityscapes_to_coco.py).

The reference's lib/datasets/cityscapes/tools/convert_cityscapes_to_coco.py:
80-202 walks the gtFine tree and writes the instancesonly_filtered_*.json
that the COCO-json dataset path reads (dataset_catalog.py:40-64). It
rasterizes through cityscapesscripts (instances2dict_with_polygons over the
*_instanceIds.png) and extracts contours again; this tool reads the
*_polygons.json files, the source annotations those PNGs are rendered
from, and so gets the same instances and polygons with no image processing
and no cityscapesscripts. 'area' is the polygon's shoelace area, not the
rendered pixel count; boxes take the polygons' extent as xyxy -> xywh with
the +1 extent (utils/boxes.py xyxy_to_xywh).

Usage:
  python -m sad_tpu_torch.tools.convert_cityscapes_to_coco \
      --datadir /path/to/cityscapes --outdir /path/out \
      [--set gtFine_val gtFine_train]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List

from sad_tpu_torch.utils.logging import setup_logging

logger = setup_logging("convert_cityscapes")

# the 8 instance classes (ref: convert_cityscapes_to_coco.py:108-117)
CATEGORY_INSTANCESONLY = (
    "person", "rider", "car", "truck", "bus", "train", "motorcycle", "bicycle",
)

# annotation subtrees per set name (ref :92-100; only gtFine_val enabled there,
# all are supported here)
ANN_DIRS = {
    "gtFine_val": "gtFine_trainvaltest/gtFine/val",
    "gtFine_train": "gtFine_trainvaltest/gtFine/train",
    "gtFine_test": "gtFine_trainvaltest/gtFine/test",
    "gtCoarse_train": "gtCoarse/train",
    "gtCoarse_train_extra": "gtCoarse/train_extra",
    "gtCoarse_val": "gtCoarse/val",
}


def _poly_area(xy: List[List[float]]) -> float:
    """Shoelace area of one polygon [[x, y], ...]."""
    area = 0.0
    n = len(xy)
    for i in range(n):
        x1, y1 = xy[i]
        x2, y2 = xy[(i + 1) % n]
        area += x1 * y2 - x2 * y1
    return abs(area) / 2.0


def _poly_bbox_xywh(polys: List[List[float]]) -> List[float]:
    """polys (flattened [x0,y0,x1,y1,...] lists) -> xywh box, using the
    reference's xyxy->xywh (+1-free) conversion (utils/boxes.py:97-105)."""
    xs = [p[i] for p in polys for i in range(0, len(p), 2)]
    ys = [p[i] for p in polys for i in range(1, len(p), 2)]
    x0, y0, x1, y1 = min(xs), min(ys), max(xs), max(ys)
    return [x0, y0, x1 - x0 + 1, y1 - y0 + 1]


def convert_cityscapes_instance_only(
    data_dir: str, out_dir: str, sets: List[str]
) -> Dict[str, str]:
    img_id = 0
    ann_id = 0
    cat_id = 1
    category_dict: Dict[str, int] = {}
    written = {}
    for data_set in sets:
        ann_dir = os.path.join(data_dir, ANN_DIRS[data_set])
        gt_prefix = data_set.split("_")[0]  # gtFine | gtCoarse
        ends_in = f"{gt_prefix}_polygons.json"
        images, annotations = [], []
        for root, _, files in sorted(os.walk(ann_dir)):
            for filename in sorted(files):
                if not filename.endswith(ends_in):
                    continue
                with open(os.path.join(root, filename)) as f:
                    src = json.load(f)
                stem = filename[: -len(ends_in)]
                image = {
                    "id": img_id,
                    "width": src["imgWidth"],
                    "height": src["imgHeight"],
                    "file_name": stem + "leftImg8bit.png",
                    "seg_file_name": stem + f"{gt_prefix}_instanceIds.png",
                }
                img_id += 1
                images.append(image)
                for obj in src.get("objects", []):
                    # 'group' suffix marks crowd regions in cityscapes; the
                    # reference's instances2dict path only yields single
                    # instances, so groups are skipped the same way
                    label = obj["label"]
                    if label.endswith("group"):
                        continue
                    if label not in CATEGORY_INSTANCESONLY:
                        continue
                    poly = [float(v) for pt in obj["polygon"] for v in pt]
                    # the reference skips degenerate contours (<=4 coords)
                    if len(poly) <= 4:
                        logger.warning("invalid contour in %s", filename)
                        continue
                    if label not in category_dict:
                        category_dict[label] = cat_id
                        cat_id += 1
                    annotations.append({
                        "id": ann_id,
                        "image_id": image["id"],
                        "category_id": category_dict[label],
                        "segmentation": [poly],
                        "iscrowd": 0,
                        "area": _poly_area(obj["polygon"]),
                        "bbox": _poly_bbox_xywh([poly]),
                    })
                    ann_id += 1
        out = {
            "images": images,
            "categories": [
                {"id": i, "name": n} for n, i in category_dict.items()
            ],
            "annotations": annotations,
        }
        json_name = (
            f"instancesonly_filtered_{data_set}.json"
            if data_set == "gtFine_val"
            else f"instancesonly_{data_set}.json"
        )
        os.makedirs(out_dir, exist_ok=True)
        out_path = os.path.join(out_dir, json_name)
        with open(out_path, "w") as f:
            json.dump(out, f)
        logger.info(
            "%s: %d images, %d annotations, %d categories -> %s",
            data_set, len(images), len(annotations), len(category_dict),
            out_path,
        )
        written[data_set] = out_path
    return written


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--datadir", required=True, help="cityscapes root")
    p.add_argument("--outdir", required=True)
    p.add_argument(
        "--set", nargs="+", default=["gtFine_val"], choices=sorted(ANN_DIRS),
    )
    args = p.parse_args(argv)
    convert_cityscapes_instance_only(args.datadir, args.outdir, args.set)


if __name__ == "__main__":
    main()
