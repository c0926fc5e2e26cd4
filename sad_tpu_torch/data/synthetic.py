"""Seeded synthetic batches for runs on the card (no files): test-time
canvases and training entries with their images."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

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
                         num_classes: int = 81, max_boxes: int = 8, polygons: bool = False,
                         keypoints: int = 0) -> Tuple[List[dict], List[np.ndarray]]:
    """``n`` landscape roidb entries with 1..max_boxes gt boxes each, and
    their uint8 BGR images of random pixels: the inputs of
    RetinaNetMinibatchBuilder.build and RCNNMinibatchBuilder.build. Sizes are
    drawn so that some images are upscaled to the training scale and some
    downscaled (short sides of 360..800 px, long sides up to ``max_side``).
    With ``polygons`` every box carries one segmentation polygon, a 12-gon
    inscribed in it (``segms``, as the dataset layer keeps them). With
    ``keypoints`` = K every box carries K keypoints drawn inside it, each
    labeled (visibility 2) with probability 0.8 and else (0, 0, 0)
    (``gt_keypoints`` (k, K, 3), as the dataset layer keeps them)."""
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
        if keypoints:
            u = rng.uniform(0.0, 1.0, (k, keypoints, 2))
            labeled = rng.uniform(0.0, 1.0, (k, keypoints)) < 0.8
            kp = np.zeros((k, keypoints, 3), np.float32)
            kp[..., 0] = np.where(labeled, x1[:, None] + u[..., 0] * (x2 - x1)[:, None], 0.0)
            kp[..., 1] = np.where(labeled, y1[:, None] + u[..., 1] * (y2 - y1)[:, None], 0.0)
            kp[..., 2] = np.where(labeled, 2.0, 0.0)
            entries[-1]["gt_keypoints"] = kp
        images.append(rng.randint(0, 256, (h, w, 3), dtype=np.uint8))
    return entries, images


def random_proposals(rng: np.random.RandomState, width: float, height: float, n: int,
                     gt_boxes: Optional[np.ndarray] = None, near_frac: float = 0.25
                     ) -> np.ndarray:
    """``n`` float32 proposals (x1, y1, x2, y2) spread over a width x height
    image, sides log-uniform from 4 px to the image's, clipped to it: the
    stand-in for a Fast R-CNN proposal file. With ``gt_boxes`` the first
    ``near_frac`` of them are gt boxes jittered by up to a fifth of their
    sides, so that a sampler finds foreground among them."""
    xy = rng.uniform(0, [width * 0.95, height * 0.95], (n, 2))
    wh = np.exp(rng.uniform(np.log(4.0), np.log(max(width, height)), (n, 2)))
    boxes = np.concatenate([xy, xy + wh], axis=1)
    if gt_boxes is not None and len(gt_boxes):
        k = int(n * near_frac)
        g = gt_boxes[rng.randint(0, len(gt_boxes), k)].astype(np.float64)
        side = np.repeat(g[:, 2:] - g[:, :2] + 1.0, 2, axis=0).reshape(k, 4)
        boxes[:k] = g + rng.uniform(-0.2, 0.2, (k, 4)) * side
    boxes[:, [0, 2]] = np.clip(boxes[:, [0, 2]], 0, width - 1.0)
    boxes[:, [1, 3]] = np.clip(boxes[:, [1, 3]], 0, height - 1.0)
    boxes[:, 2:] = np.maximum(boxes[:, 2:], boxes[:, :2])
    return boxes.astype(np.float32)
