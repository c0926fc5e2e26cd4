"""Synthetic multi-class COCO-format dataset generator.

A copy of sad_tpu/data/synth_coco.py; its mask helpers come from the port's
utils/segms.py. Nothing can be downloaded where the port is tested and
smoked, so the training workflow runs on a generated dataset that exercises
the same COCO-json surface the reference's JsonDataset consumes (ref:
detectron/lib/datasets/json_dataset.py:87-257): multi-class labels, polygon
instance segmentations, iscrowd RLE regions, small objects, ignore flags,
and (optionally) keypoints with a left/right flip map.

Eight polygon shape categories, each with a distinct base color (jittered) so
a small detector can actually learn the task; images are noisy uint8 canvases
with painted shapes. Everything is deterministic in (seed, n_images).

    python -m sad_tpu_torch.data.synth_coco --output-dir DIR [--split train]
        [--num-images 512] [--seed 0] [--unlabeled]
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
from PIL import Image

from ..utils.segms import mask_to_rle, polys_to_mask

# category id -> (name, base BGR-ish color, polygon builder)
_PALETTE = [
    ("rect", (200, 60, 60)),
    ("disc", (60, 200, 60)),
    ("triangle", (60, 60, 220)),
    ("diamond", (220, 200, 40)),
    ("pentagon", (200, 60, 200)),
    ("star", (40, 220, 220)),
    ("hexagon", (240, 140, 40)),
    ("ellipse", (140, 80, 240)),
]

KEYPOINT_NAMES = ["center", "left_tip", "right_tip", "top_tip", "bottom_tip"]


def _regular_polygon(cx, cy, rx, ry, n, phase=0.0):
    ang = phase + np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    xs = cx + rx * np.cos(ang)
    ys = cy + ry * np.sin(ang)
    return np.stack([xs, ys], axis=1)


def _shape_polygon(cat: int, cx, cy, rx, ry, rng) -> np.ndarray:
    phase = rng.uniform(0, 2 * np.pi)
    if cat == 1:  # rect (axis aligned)
        return np.array(
            [[cx - rx, cy - ry], [cx + rx, cy - ry],
             [cx + rx, cy + ry], [cx - rx, cy + ry]]
        )
    if cat == 2:  # disc
        return _regular_polygon(cx, cy, r := min(rx, ry), r, 16, phase)
    if cat == 3:  # triangle
        return _regular_polygon(cx, cy, rx, ry, 3, phase)
    if cat == 4:  # diamond
        return np.array([[cx, cy - ry], [cx + rx, cy], [cx, cy + ry], [cx - rx, cy]])
    if cat == 5:  # pentagon
        return _regular_polygon(cx, cy, rx, ry, 5, phase)
    if cat == 6:  # star
        outer = _regular_polygon(cx, cy, rx, ry, 5, phase)
        inner = _regular_polygon(cx, cy, 0.45 * rx, 0.45 * ry, 5, phase + np.pi / 5)
        pts = np.empty((10, 2))
        pts[0::2] = outer
        pts[1::2] = inner
        return pts
    if cat == 7:  # hexagon
        return _regular_polygon(cx, cy, rx, ry, 6, phase)
    # ellipse (16-gon, strongly anisotropic)
    return _regular_polygon(cx, cy, rx, 0.5 * ry, 16, phase)


def _paint(img: np.ndarray, mask: np.ndarray, color, rng) -> None:
    jitter = rng.randint(-25, 26, 3)
    col = np.clip(np.asarray(color, np.int32) + jitter, 0, 255)
    shade = (rng.rand(*mask.shape) * 20 - 10)[..., None]
    region = np.clip(col[None, None] + shade, 0, 255).astype(np.uint8)
    img[mask > 0] = region[mask > 0]


def _instance_keypoints(poly: np.ndarray, h, w, rng) -> List[float]:
    """5 keypoints: centroid + leftmost/rightmost/topmost/bottommost vertex.
    Visibility: 2 (visible) normally, occasionally 1 (labeled, not visible),
    with one random tip dropped (v=0) 20% of the time."""
    cx, cy = poly.mean(axis=0)
    tips = [
        poly[np.argmin(poly[:, 0])], poly[np.argmax(poly[:, 0])],
        poly[np.argmin(poly[:, 1])], poly[np.argmax(poly[:, 1])],
    ]
    pts = [(cx, cy)] + [tuple(t) for t in tips]
    drop = rng.randint(1, 5) if rng.rand() < 0.2 else -1
    out: List[float] = []
    for i, (x, y) in enumerate(pts):
        v = 0 if i == drop else (1 if rng.rand() < 0.1 else 2)
        if v == 0:
            out += [0.0, 0.0, 0]
        else:
            out += [float(np.clip(x, 0, w - 1)), float(np.clip(y, 0, h - 1)), v]
    return out


def generate_synthetic_coco(
    root: str,
    split: str = "train",
    n_images: int = 512,
    seed: int = 0,
    n_categories: int = 8,
    size_range: Tuple[int, int] = (200, 420),
    objects_per_image: Tuple[int, int] = (2, 10),
    small_frac: float = 0.3,
    crowd_frac: float = 0.06,
    ignore_frac: float = 0.03,
    with_keypoints: bool = False,
    labeled: bool = True,
) -> Tuple[str, str]:
    """Write images + a COCO json under `root`. Returns (img_dir, json_path).

    `labeled=False` writes only the image-info json (no annotations) — the
    analogue of COCO's image_info_unlabeled2017.json used by the teacher
    pseudo-label pass (ref: dataset_catalog.py:201-206).
    """
    if not 1 <= n_categories <= len(_PALETTE):
        raise ValueError(f"n_categories must be in 1..{len(_PALETTE)}; got {n_categories}")
    img_dir = os.path.join(root, f"images_{split}")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    images, annotations = [], []
    ann_id = 1
    for i in range(1, n_images + 1):
        h = int(rng.randint(size_range[0], size_range[1] + 1))
        w = int(rng.randint(size_range[0], size_range[1] + 1))
        img = rng.randint(0, 45, (h, w, 3)).astype(np.uint8)
        fname = f"{split}_{i:06d}.png"
        images.append({"id": i, "file_name": fname, "height": h, "width": w})

        n_obj = int(rng.randint(objects_per_image[0], objects_per_image[1] + 1))
        for _ in range(n_obj):
            cat = int(rng.randint(1, n_categories + 1))
            small = rng.rand() < small_frac
            r_lo, r_hi = (4, 14) if small else (14, min(h, w) // 3)
            rx = float(rng.uniform(r_lo, max(r_lo + 1, r_hi)))
            ry = float(rng.uniform(r_lo, max(r_lo + 1, r_hi)))
            cx = float(rng.uniform(rx * 0.5, w - rx * 0.5))
            cy = float(rng.uniform(ry * 0.5, h - ry * 0.5))
            poly = _shape_polygon(cat, cx, cy, rx, ry, rng)
            poly[:, 0] = np.clip(poly[:, 0], 0, w - 1)
            poly[:, 1] = np.clip(poly[:, 1], 0, h - 1)
            flat = [float(v) for v in poly.reshape(-1)]
            mask = polys_to_mask([flat], h, w)
            area = float(mask.sum())
            if area < 4:
                continue
            _paint(img, mask, _PALETTE[cat - 1][1], rng)
            if not labeled:
                continue
            x1, y1 = poly[:, 0].min(), poly[:, 1].min()
            bw, bh = poly[:, 0].max() - x1, poly[:, 1].max() - y1
            ann = {
                "id": ann_id,
                "image_id": i,
                "category_id": cat,
                "bbox": [float(x1), float(y1), float(bw), float(bh)],
                "area": area,
                "iscrowd": 0,
                "segmentation": [flat],
            }
            if rng.rand() < ignore_frac:
                ann["ignore"] = 1
            if with_keypoints:
                kp = _instance_keypoints(poly, h, w, rng)
                ann["keypoints"] = kp
                ann["num_keypoints"] = sum(1 for v in kp[2::3] if v > 0)
            annotations.append(ann)
            ann_id += 1

        # crowd region: a cluster of many tiny shapes of one category,
        # annotated as a single iscrowd=1 RLE (no polygon) — exercises the
        # crowd-overlap eval semantics and the RLE parse/flip path
        if labeled and rng.rand() < crowd_frac:
            cat = int(rng.randint(1, n_categories + 1))
            ccx = rng.uniform(0.25 * w, 0.75 * w)
            ccy = rng.uniform(0.25 * h, 0.75 * h)
            union = np.zeros((h, w), np.uint8)
            for _ in range(rng.randint(6, 14)):
                r = rng.uniform(3, 7)
                px = np.clip(ccx + rng.uniform(-0.2 * w, 0.2 * w), r, w - r - 1)
                py = np.clip(ccy + rng.uniform(-0.2 * h, 0.2 * h), r, h - r - 1)
                p = _shape_polygon(cat, px, py, r, r, rng)
                m = polys_to_mask([[float(v) for v in p.reshape(-1)]], h, w)
                _paint(img, m, _PALETTE[cat - 1][1], rng)
                union |= m
            if union.sum() >= 4:
                ys, xs = np.where(union)
                rle = mask_to_rle(union)
                annotations.append({
                    "id": ann_id,
                    "image_id": i,
                    "category_id": cat,
                    "bbox": [float(xs.min()), float(ys.min()),
                             float(xs.max() - xs.min()), float(ys.max() - ys.min())],
                    "area": float(union.sum()),
                    "iscrowd": 1,
                    "segmentation": rle,
                })
                ann_id += 1

        Image.fromarray(img).save(os.path.join(img_dir, fname))

    categories: List[Dict] = []
    for cid in range(1, n_categories + 1):
        c: Dict = {"id": cid, "name": _PALETTE[cid - 1][0]}
        if with_keypoints:
            c["keypoints"] = list(KEYPOINT_NAMES)
            c["skeleton"] = [[1, 2], [1, 3], [1, 4], [1, 5]]
        categories.append(c)
    doc = {"images": images, "categories": categories}
    if labeled:
        doc["annotations"] = annotations
        json_path = os.path.join(root, f"instances_{split}.json")
    else:
        json_path = os.path.join(root, f"image_info_{split}.json")
    with open(json_path, "w") as f:
        json.dump(doc, f)
    return img_dir, json_path


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--split", default="train")
    ap.add_argument("--num-images", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--categories", type=int, default=8)
    ap.add_argument("--keypoints", action="store_true")
    ap.add_argument("--unlabeled", action="store_true")
    args = ap.parse_args(argv)
    img_dir, json_path = generate_synthetic_coco(
        args.output_dir, args.split, args.num_images, args.seed,
        n_categories=args.categories, with_keypoints=args.keypoints,
        labeled=not args.unlabeled,
    )
    print(json.dumps({"image_dir": img_dir, "json": json_path}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
