"""Detection visualization (ref: detectron/lib/utils/vis.py + colormap.py).

PIL-based (matplotlib-free) box/label rendering for infer_simple and
debugging. Writes PNG/PDF via PIL.

A copy of sad_tpu/utils/vis.py: boxes, labels, mask overlays and keypoint
skeletons.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
from PIL import Image, ImageDraw

from .keypoints import get_keypoints
from .segms import rle_to_mask


def colormap(n: int = 79) -> np.ndarray:
    """Deterministic distinct colors (the familiar Detectron palette idea)."""
    colors = []
    for i in range(n):
        # golden-ratio hue walk, full saturation/value, converted to RGB
        h = (i * 0.61803398875) % 1.0
        x = 1.0 - abs((h * 6) % 2 - 1)
        r, g, b = [
            (1, x, 0), (x, 1, 0), (0, 1, x), (0, x, 1), (x, 0, 1), (1, 0, x)
        ][int(h * 6) % 6]
        colors.append((int(r * 255), int(g * 255), int(b * 255)))
    return np.asarray(colors, np.uint8)


def kp_connections() -> list:
    """COCO keypoint skeleton pairs (ref: vis.py kp_connections:47-65)."""
    names, _ = get_keypoints()
    pairs = [
        ("left_eye", "right_eye"), ("left_eye", "nose"),
        ("right_eye", "nose"), ("right_eye", "right_ear"),
        ("left_eye", "left_ear"),
        ("right_shoulder", "right_elbow"), ("right_elbow", "right_wrist"),
        ("left_shoulder", "left_elbow"), ("left_elbow", "left_wrist"),
        ("right_hip", "right_knee"), ("right_knee", "right_ankle"),
        ("left_hip", "left_knee"), ("left_knee", "left_ankle"),
        ("right_shoulder", "left_shoulder"), ("right_hip", "left_hip"),
    ]
    return [(names.index(a), names.index(b)) for a, b in pairs]


def _blend_mask(
    arr: np.ndarray, mask: np.ndarray, color, alpha: float = 0.4
) -> None:
    """In-place semi-transparent mask fill + 1px white border
    (ref: vis.py vis_mask:97-112)."""
    idx = mask.astype(bool)
    col = np.asarray(color, np.float32)
    arr[idx] = (arr[idx] * (1 - alpha) + col * alpha).astype(np.uint8)
    # border: mask pixels adjacent to a non-mask pixel
    pad = np.pad(idx, 1)
    interior = (
        pad[:-2, 1:-1] & pad[2:, 1:-1] & pad[1:-1, :-2] & pad[1:-1, 2:]
    )
    arr[idx & ~interior] = (255, 255, 255)


def vis_one_image(
    im_rgb: np.ndarray,
    boxes: np.ndarray,  # (K, 4) xyxy
    scores: np.ndarray,  # (K,)
    classes: np.ndarray,  # (K,) int (1-based)
    valid: Optional[np.ndarray] = None,
    class_names: Optional[Sequence[str]] = None,
    thresh: float = 0.5,
    out_path: Optional[str] = None,
    segms: Optional[Sequence] = None,  # per-k RLE dict / binary mask / None
    keypoints: Optional[Sequence] = None,  # per-k flat [x,y,v]*17 or (4,17)
    kp_thresh: float = 2.0,
) -> Image.Image:
    """Boxes + labels, optional mask overlays and keypoint skeletons
    (ref: vis.py vis_one_image_opencv: vis_mask + vis_class + vis_bbox +
    vis_keypoints)."""
    arr = np.ascontiguousarray(im_rgb).copy()
    cmap = colormap()
    if segms is not None:
        for k in range(len(boxes)):
            if valid is not None and not valid[k]:
                continue
            if scores[k] < thresh or k >= len(segms) or segms[k] is None:
                continue
            m = segms[k]
            if isinstance(m, dict):
                m = rle_to_mask(m)
            _blend_mask(
                arr, np.asarray(m), cmap[int(classes[k]) % len(cmap)]
            )
    img = Image.fromarray(arr)
    draw = ImageDraw.Draw(img)
    for k in range(len(boxes)):
        if valid is not None and not valid[k]:
            continue
        if scores[k] < thresh:
            continue
        c = int(classes[k])
        color = tuple(int(v) for v in cmap[c % len(cmap)])
        x1, y1, x2, y2 = (float(v) for v in boxes[k])
        # degenerate decoded boxes (x2<x1 / y2<y1 after clipping) are kept
        # by the decode path like the reference; PIL needs ordered corners
        x1, x2 = min(x1, x2), max(x1, x2)
        y1, y2 = min(y1, y2), max(y1, y2)
        draw.rectangle([x1, y1, x2, y2], outline=color, width=2)
        name = (
            class_names[c]
            if class_names and c < len(class_names)
            else f"cls{c}"
        )
        draw.text((x1 + 2, max(0, y1 - 12)), f"{name} {scores[k]:.2f}", fill=color)
        if keypoints is not None and k < len(keypoints) and (
            keypoints[k] is not None
        ):
            kp = np.asarray(keypoints[k], np.float32)
            if kp.ndim == 1:  # COCO triplets [x, y, v] * K
                kp = kp.reshape(-1, 3).T  # (3, K): x, y, v
                thr = 1.0  # v >= 1: labeled (engine triplets carry v=1)
            else:  # (4, K) decode rows: x, y, logit, prob
                thr = kp_thresh  # logit threshold (ref vis_keypoints)
            vis_row = 2
            for a, b in kp_connections():  # the COCO skeleton; none past K
                if max(a, b) < kp.shape[1] and kp[vis_row, a] >= thr and kp[vis_row, b] >= thr:
                    draw.line(
                        [(kp[0, a], kp[1, a]), (kp[0, b], kp[1, b])],
                        fill=color, width=2,
                    )
            for j in range(kp.shape[1]):
                if kp[vis_row, j] >= thr:
                    draw.ellipse(
                        [kp[0, j] - 2, kp[1, j] - 2,
                         kp[0, j] + 2, kp[1, j] + 2],
                        fill=color,
                    )
    if out_path:
        img.save(out_path)
    return img
