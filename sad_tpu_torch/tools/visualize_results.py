"""Render saved detection results over their dataset's images (a copy of
sad_tpu/tools/visualize_results.py; ref detectron/tools/visualize_results.py)
with the port's utils/vis.py.

Usage:
  python -m sad_tpu_torch.tools.visualize_results --dataset coco_2017_val \
      --results bbox_results.json --output-dir vis/ [--thresh 0.7] [--first 20]
"""

from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict

import numpy as np
from PIL import Image

from sad_tpu_torch.data.dataset import CocoDataset
from sad_tpu_torch.utils.logging import setup_logging
from sad_tpu_torch.utils.vis import vis_one_image

logger = setup_logging("visualize_results")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", required=True)
    p.add_argument("--results", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--thresh", type=float, default=0.7)
    p.add_argument("--first", type=int, default=0, help="limit images (0=all)")
    args = p.parse_args(argv)

    ds = CocoDataset(args.dataset)
    with open(args.results) as f:
        dets = json.load(f)
    by_image = defaultdict(list)
    for d in dets:
        by_image[d["image_id"]].append(d)

    os.makedirs(args.output_dir, exist_ok=True)
    roidb = ds.get_roidb(include_gt=False)
    if args.first:
        roidb = roidb[: args.first]
    json_to_contig = ds.json_to_contiguous
    for e in roidb:
        items = by_image.get(e["id"], [])
        if not items:
            continue
        boxes = np.asarray(
            [
                [d["bbox"][0], d["bbox"][1],
                 d["bbox"][0] + d["bbox"][2] - 1.0,
                 d["bbox"][1] + d["bbox"][3] - 1.0]
                for d in items
            ],
            np.float32,
        )
        scores = np.asarray([d["score"] for d in items], np.float32)
        classes = np.asarray(
            [json_to_contig[d["category_id"]] for d in items], np.int32
        )
        with Image.open(e["image"]) as img:
            rgb = np.asarray(img.convert("RGB"))
        out_path = os.path.join(
            args.output_dir, e["file_name"].rsplit(".", 1)[0] + "_det.png"
        )
        vis_one_image(
            rgb, boxes, scores, classes,
            class_names=ds.classes, thresh=args.thresh, out_path=out_path,
        )
        logger.info("%s: %d dets -> %s", e["file_name"], len(items), out_path)


if __name__ == "__main__":
    main()
