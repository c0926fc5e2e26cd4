"""Seeded synthetic datasets in the raw formats of PASCAL VOC and Cityscapes.

Nothing can be downloaded where the port is tested and smoked, so the VOC
and Cityscapes paths run on files written here from a seed, in the layouts
their tools read:

- ``write_voc_devkit``: ``<root>/VOC<year>/{Annotations,JPEGImages,
  ImageSets/Main}``, one XML a JPEG with 1-based inclusive boxes of the 20
  VOC classes, some marked ``difficult`` (data/voc_dataset.VOCDataset reads
  it);
- ``write_cityscapes_tree``: ``<root>/gtFine_trainvaltest/gtFine/<split>/
  <city>/<stem>gtFine_polygons.json`` and ``<root>/images/<city>/
  <stem>leftImg8bit.png``: polygons of the 8 instance classes beside a crowd
  region (``cargroup``), a class that is no instance (``sky``) and a
  degenerate two-point polygon, the cases
  tools/convert_cityscapes_to_coco.py skips.

Objects are painted in a colour of their class over a smooth noisy
background, so that the images are more than noise. Everything is
deterministic in the seed.
"""

from __future__ import annotations

import json
import os
from typing import List, Tuple

import numpy as np
from PIL import Image, ImageDraw

from .voc_dataset import VOC_CLASSES

CITYSCAPES_INSTANCE_CLASSES = ("person", "rider", "car", "truck", "bus", "train", "motorcycle",
                               "bicycle")


def _background(rng: np.random.RandomState, h: int, w: int) -> Image.Image:
    """A smooth seeded background: coarse noise resized up, plus fine noise."""
    coarse = rng.randint(0, 256, (max(h // 32, 2), max(w // 32, 2), 3)).astype(np.uint8)
    img = np.asarray(Image.fromarray(coarse).resize((w, h), Image.BILINEAR), np.int16)
    img = img + rng.randint(-12, 13, (h, w, 3))
    return Image.fromarray(np.clip(img, 0, 255).astype(np.uint8))


def _colour(cls: int) -> Tuple[int, int, int]:
    return ((53 * cls) % 256, (97 * cls + 80) % 256, (151 * cls + 160) % 256)


def write_voc_devkit(root: str, year: str = "2007", split: str = "test", n_images: int = 16,
                     seed: int = 0, hw: Tuple[int, int] = (375, 500),
                     objects: Tuple[int, int] = (1, 6), difficult_p: float = 0.15) -> str:
    """A VOC devkit of ``n_images`` JPEGs of ``hw`` under ``root``, each with
    ``objects`` (inclusive range) boxes of the 20 classes; a share
    ``difficult_p`` of them difficult. Returns the VOC<year> directory."""
    rng = np.random.RandomState(seed)
    voc = os.path.join(root, f"VOC{year}")
    for sub in ("Annotations", "JPEGImages", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(voc, sub), exist_ok=True)
    h, w = hw
    names = []
    for i in range(n_images):
        name = f"{i + 1:06d}"
        names.append(name)
        img = _background(rng, h, w)
        draw = ImageDraw.Draw(img)
        objs = []
        for _ in range(rng.randint(objects[0], objects[1] + 1)):
            cls = int(rng.randint(1, len(VOC_CLASSES)))
            bw, bh = int(rng.randint(24, w // 2)), int(rng.randint(24, h // 2))
            x1, y1 = int(rng.randint(1, w - bw)), int(rng.randint(1, h - bh))
            x2, y2 = x1 + bw - 1, y1 + bh - 1
            draw.rectangle([x1 - 1, y1 - 1, x2 - 1, y2 - 1], fill=_colour(cls))
            objs.append((VOC_CLASSES[cls], x1, y1, x2, y2, int(rng.rand() < difficult_p)))
        img.save(os.path.join(voc, "JPEGImages", f"{name}.jpg"), quality=90)
        xml = [f"<annotation><folder>VOC{year}</folder><filename>{name}.jpg</filename>",
               f"<size><width>{w}</width><height>{h}</height><depth>3</depth></size>"]
        for cname, x1, y1, x2, y2, diff in objs:
            xml.append(f"<object><name>{cname}</name><pose>Unspecified</pose>"
                       f"<truncated>0</truncated><difficult>{diff}</difficult><bndbox>"
                       f"<xmin>{x1}</xmin><ymin>{y1}</ymin><xmax>{x2}</xmax><ymax>{y2}</ymax>"
                       "</bndbox></object>")
        xml.append("</annotation>")
        with open(os.path.join(voc, "Annotations", f"{name}.xml"), "w") as f:
            f.write("\n".join(xml))
    with open(os.path.join(voc, "ImageSets", "Main", f"{split}.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    return voc


def _polygon(rng: np.random.RandomState, cx: float, cy: float, rx: float, ry: float
             ) -> List[List[int]]:
    """A star-shaped polygon of 6-12 integer vertices around (cx, cy)."""
    n = int(rng.randint(6, 13))
    ang = np.sort(rng.uniform(0.0, 2 * np.pi, n))
    rad = rng.uniform(0.6, 1.0, n)
    return [[int(round(cx + rx * r * np.cos(a))), int(round(cy + ry * r * np.sin(a)))]
            for a, r in zip(ang, rad)]


def write_cityscapes_tree(root: str, split: str = "val", n_images: int = 8, seed: int = 0,
                          hw: Tuple[int, int] = (1024, 2048), city: str = "frankfurt",
                          objects: Tuple[int, int] = (2, 8)) -> Tuple[str, str]:
    """A Cityscapes gtFine ``split`` tree of ``n_images`` PNGs of ``hw``
    under ``root``, each with ``objects`` (inclusive range) instance
    polygons of the 8 classes, one crowd region, one 'sky' region and one
    degenerate polygon. Returns (the images' directory, the annotations'
    directory)."""
    rng = np.random.RandomState(seed)
    ann_dir = os.path.join(root, "gtFine_trainvaltest", "gtFine", split, city)
    img_dir = os.path.join(root, "images", city)
    os.makedirs(ann_dir, exist_ok=True)
    os.makedirs(img_dir, exist_ok=True)
    h, w = hw
    for i in range(n_images):
        stem = f"{city}_{i:06d}_000019_"
        img = _background(rng, h, w)
        draw = ImageDraw.Draw(img)
        objs = [{"label": "sky", "polygon": [[0, 0], [w - 1, 0], [w - 1, h // 8], [0, h // 8]]}]
        for _ in range(rng.randint(objects[0], objects[1] + 1)):
            k = int(rng.randint(len(CITYSCAPES_INSTANCE_CLASSES)))
            rx, ry = rng.uniform(w / 40, w / 8), rng.uniform(h / 20, h / 5)
            cx, cy = rng.uniform(rx, w - 1 - rx), rng.uniform(ry, h - 1 - ry)
            poly = _polygon(rng, cx, cy, rx, ry)
            draw.polygon([tuple(p) for p in poly], fill=_colour(k + 1))
            objs.append({"label": CITYSCAPES_INSTANCE_CLASSES[k], "polygon": poly})
        gw, gh = w // 10, h // 10
        gx, gy = int(rng.randint(0, w - gw)), int(rng.randint(h // 2, h - gh))
        objs.append({"label": "cargroup", "polygon": [[gx, gy], [gx + gw - 1, gy],
                                                      [gx + gw - 1, gy + gh - 1],
                                                      [gx, gy + gh - 1]]})
        objs.append({"label": "car", "polygon": [[5, 5], [9, 9]]})
        with open(os.path.join(ann_dir, f"{stem}gtFine_polygons.json"), "w") as f:
            json.dump({"imgHeight": h, "imgWidth": w, "objects": objs}, f)
        img.save(os.path.join(img_dir, f"{stem}leftImg8bit.png"))
    return img_dir, ann_dir
