"""Seeded synthetic test-time batches for runs on the card (no files)."""

from __future__ import annotations

from typing import Dict, Tuple

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
