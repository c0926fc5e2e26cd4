"""Segmentation masks on the host: polygon rasters, uncompressed and
compressed COCO RLE, horizontal flips (ref: detectron/lib/utils/segms.py).

A copy of sad_tpu/utils/segms.py: ``polys_to_mask``,
``polys_to_mask_wrt_box`` (the reference's mask-target transform; no path of
the port calls it, its mask targets are RoIAlign crops), ``flip_polys``,
``flip_segm``, ``mask_to_bbox``, ``paste_mask_into_image``, ``mask_to_rle``,
``rle_to_mask``, ``rle_string_to_counts`` and ``polygon_area``. numpy, PIL
and (when it imports) cv2; no pycocotools. The cv2-exact resize is the
port's one copy in data/minibatch.py.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
from PIL import Image, ImageDraw

from ..data.minibatch import _resize_bilinear


def polys_to_mask(polygons: Sequence[Sequence[float]], height: int, width: int) -> np.ndarray:
    """Rasterize COCO polygon(s) -> binary (height, width) mask."""
    img = Image.new("L", (width, height), 0)
    draw = ImageDraw.Draw(img)
    for poly in polygons:
        pts = [(poly[i], poly[i + 1]) for i in range(0, len(poly) - 1, 2)]
        if len(pts) >= 3:
            draw.polygon(pts, outline=1, fill=1)
    return np.asarray(img, dtype=np.uint8)


def polys_to_mask_wrt_box(
    polygons: Sequence[Sequence[float]], box: np.ndarray, resolution: int
) -> np.ndarray:
    """Rasterize polygons in the frame of `box` at resolution^2
    (ref: segms.py polys_to_mask_wrt_box — the mask-target transform)."""
    w = max(box[2] - box[0], 1.0)
    h = max(box[3] - box[1], 1.0)
    scaled = []
    for poly in polygons:
        p = np.asarray(poly, np.float64).copy()
        p[0::2] = (p[0::2] - box[0]) * resolution / w
        p[1::2] = (p[1::2] - box[1]) * resolution / h
        scaled.append(p.tolist())
    return polys_to_mask(scaled, resolution, resolution)


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


def mask_to_bbox(mask: np.ndarray) -> np.ndarray:
    ys, xs = np.where(mask > 0)
    if len(xs) == 0:
        return np.zeros(4, np.float32)
    return np.asarray([xs.min(), ys.min(), xs.max(), ys.max()], np.float32)


def paste_mask_into_image(
    mask_prob: np.ndarray,  # (res, res) float
    box: np.ndarray,  # (4,) xyxy in image coords
    im_h: int,
    im_w: int,
    thresh: float = 0.5,
) -> np.ndarray:
    """Resize a roi-frame mask back into image frame and binarize —
    exact transcription of test.py segm_results:817-861: zero-pad the mask
    by 1 px and expand the box by (M+2)/M (prevents cv2's replicated-border
    "top hat" artifacts), int32-truncate the expanded box, bilinear-resize
    (cv2 INTER_LINEAR semantics), strict > threshold, clipped paste."""
    m = mask_prob.shape[0]
    scale = (m + 2.0) / m
    w_half = (box[2] - box[0]) * 0.5 * scale
    h_half = (box[3] - box[1]) * 0.5 * scale
    x_c = (box[2] + box[0]) * 0.5
    y_c = (box[3] + box[1]) * 0.5
    ref = np.array(
        [x_c - w_half, y_c - h_half, x_c + w_half, y_c + h_half]
    ).astype(np.int32)
    padded = np.zeros((m + 2, m + 2), np.float32)
    padded[1:-1, 1:-1] = mask_prob
    w = max(int(ref[2] - ref[0] + 1), 1)
    h = max(int(ref[3] - ref[1] + 1), 1)
    mask = (_resize_bilinear(padded, h, w) > thresh).astype(np.uint8)

    out = np.zeros((im_h, im_w), np.uint8)
    x0, y0 = max(int(ref[0]), 0), max(int(ref[1]), 0)
    x1, y1 = min(int(ref[2]) + 1, im_w), min(int(ref[3]) + 1, im_h)
    out[y0:y1, x0:x1] = mask[
        y0 - ref[1] : y1 - ref[1], x0 - ref[0] : x1 - ref[0]
    ]
    return out


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


def polygon_area(poly: Sequence[float]) -> float:
    """Shoelace area of one flat [x0,y0,x1,y1,...] polygon."""
    xs = np.asarray(poly[0::2], np.float64)
    ys = np.asarray(poly[1::2], np.float64)
    return float(abs(np.dot(xs, np.roll(ys, -1)) - np.dot(ys, np.roll(xs, -1))) / 2.0)
