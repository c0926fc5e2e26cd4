"""Seeded synthetic batches for runs on the card (no files): test-time
canvases and training entries with their images."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


def random_canvases(rng: np.random.RandomState, batch: int, canvas: Tuple[int, int],
                    device) -> Dict[str, torch.Tensor]:
    """uint8 canvases of random pixels inside varied content extents (half to
    all of the canvas) with zero padding, the per-image scales they were
    resized by, and the original sizes that implies: the inputs of
    make_inference_fn, on ``device``."""
    ch, cw = canvas
    data = np.zeros((batch, ch, cw, 3), np.uint8)
    content = np.zeros((batch, 2), np.float32)
    for i in range(batch):
        h, w = int(rng.randint(ch // 2, ch + 1)), int(rng.randint(cw // 2, cw + 1))
        data[i, :h, :w] = rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
        content[i] = (h, w)
    scale = rng.uniform(0.6, 1.6, batch).astype(np.float32)
    im_hw = np.round(content / scale[:, None]).astype(np.float32)
    return {key: torch.from_numpy(v).to(device) for key, v in
            (("data", data), ("im_hw", im_hw), ("im_scale", scale), ("content_hw", content))}


def random_train_entries(rng: np.random.RandomState, n: int, max_side: int = 1000,
                         num_classes: int = 81, max_boxes: int = 8, polygons: bool = False
                         ) -> Tuple[List[dict], List[np.ndarray]]:
    """``n`` landscape roidb entries with 1..max_boxes gt boxes each, and
    their uint8 BGR images of random pixels: the inputs of
    RetinaNetMinibatchBuilder.build and RCNNMinibatchBuilder.build. Sizes are
    drawn so that some images are upscaled to the training scale and some
    downscaled (short sides of 360..800 px, long sides up to ``max_side``).
    With ``polygons`` every box carries one segmentation polygon, a 12-gon
    inscribed in it (``segms``, as the dataset layer keeps them)."""
    entries, images = [], []
    for _ in range(n):
        h = int(rng.randint(360, 801))
        w = int(rng.randint(h, max(h, max_side) + 1))
        k = int(rng.randint(1, max_boxes + 1))
        x1 = rng.uniform(0, w - 33, k)
        y1 = rng.uniform(0, h - 33, k)
        x2 = np.minimum(x1 + rng.uniform(16, 400, k), w - 1)
        y2 = np.minimum(y1 + rng.uniform(16, 400, k), h - 1)
        entries.append({
            "height": h, "width": w, "flipped": False,
            "boxes": np.stack([x1, y1, x2, y2], axis=1).astype(np.float32),
            "gt_classes": rng.randint(1, num_classes, k).astype(np.int32),
            "is_crowd": np.zeros(k, bool),
        })
        if polygons:
            t = np.linspace(0.0, 2.0 * np.pi, 12, endpoint=False)
            cx, cy, rx, ry = (x1 + x2) / 2, (y1 + y2) / 2, (x2 - x1) / 2, (y2 - y1) / 2
            entries[-1]["segms"] = [
                [np.stack([cx[j] + rx[j] * np.cos(t), cy[j] + ry[j] * np.sin(t)],
                          axis=1).reshape(-1).tolist()] for j in range(k)]
        images.append(rng.randint(0, 256, (h, w, 3), dtype=np.uint8))
    return entries, images
