"""Segmentation masks on the host: polygon rasters, uncompressed and
compressed COCO RLE, horizontal flips (ref: detectron/lib/utils/segms.py).

A copy of what the R-CNN training batches and the dataset's flip need from
sad_tpu/utils/segms.py: ``polys_to_mask``, ``flip_polys``, ``flip_segm``,
``mask_to_rle``, ``rle_to_mask`` and ``rle_string_to_counts``. numpy and PIL
only (no pycocotools). Pasting masks into images and the cv2-exact resize
stay with the evaluation code that needs them.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
from PIL import Image, ImageDraw


def polys_to_mask(polygons: Sequence[Sequence[float]], height: int, width: int) -> np.ndarray:
    """Rasterize COCO polygon(s) -> binary (height, width) mask."""
    img = Image.new("L", (width, height), 0)
    draw = ImageDraw.Draw(img)
    for poly in polygons:
        pts = [(poly[i], poly[i + 1]) for i in range(0, len(poly) - 1, 2)]
        if len(pts) >= 3:
            draw.polygon(pts, outline=1, fill=1)
    return np.asarray(img, dtype=np.uint8)


def flip_polys(polygons: Sequence[Sequence[float]], width: int) -> List[List[float]]:
    """Horizontal flip of polygon coordinates (ref: segms.py flip_segms)."""
    out = []
    for poly in polygons:
        p = np.asarray(poly, np.float64).copy()
        p[0::2] = width - p[0::2] - 1
        out.append(p.tolist())
    return out


def flip_segm(segm, width: int):
    """Horizontal flip of one segmentation — polygon list or RLE dict
    (ref: segms.py flip_segms handles both forms; RLE via
    decode -> column-reverse -> re-encode)."""
    if isinstance(segm, dict):
        return mask_to_rle(rle_to_mask(segm)[:, ::-1])
    return flip_polys(segm, width)


def mask_to_rle(mask: np.ndarray) -> dict:
    """Uncompressed COCO RLE (column-major run lengths starting with the
    count of zeros) — the json-serializable 'segmentation' format for mask
    results (pycocotools maskUtils convention)."""
    h, w = mask.shape
    flat = np.asarray(mask, np.uint8).flatten(order="F")
    changes = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    runs = np.diff(np.concatenate([[0], changes, [len(flat)]]))
    counts = runs.tolist()
    if flat[0] == 1:  # RLE starts with a zero-run
        counts = [0] + counts
    return {"size": [int(h), int(w)], "counts": counts}


def rle_to_mask(rle: dict) -> np.ndarray:
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):  # compressed pycocotools form
        counts = rle_string_to_counts(counts)
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for run in counts:
        flat[pos : pos + run] = val
        pos += run
        val = 1 - val
    return flat.reshape((h, w), order="F")


def rle_string_to_counts(s) -> List[int]:
    """Decode a pycocotools COMPRESSED RLE counts string to the plain
    run-length list (transcribes maskApi.c rleFrString: 5-bit groups in
    ascii chars 48+, sign-extended, delta-coded against counts[i-2])."""
    if isinstance(s, bytes):
        s = s.decode("ascii")
    counts: List[int] = []
    p = 0
    while p < len(s):
        x, k, more = 0, 0, True
        while more:
            c = ord(s[p]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts
