"""Detection visualization (ref: detectron/lib/utils/vis.py + colormap.py).

PIL-based (matplotlib-free) box/label rendering for infer_simple and
debugging. Writes PNG/PDF via PIL.

A copy of sad_tpu/utils/vis.py for boxes and labels. Mask overlays and
keypoint skeletons serve the R-CNN families, which the port does not have
yet: asking for them raises NotImplementedError (ROADMAP.md Queue 1 item 8).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
from PIL import Image, ImageDraw


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


def vis_one_image(
    im_rgb: np.ndarray,
    boxes: np.ndarray,  # (K, 4) xyxy
    scores: np.ndarray,  # (K,)
    classes: np.ndarray,  # (K,) int (1-based)
    valid: Optional[np.ndarray] = None,
    class_names: Optional[Sequence[str]] = None,
    thresh: float = 0.5,
    out_path: Optional[str] = None,
    segms: Optional[Sequence] = None,  # R-CNN masks: not ported
    keypoints: Optional[Sequence] = None,  # R-CNN keypoints: not ported
) -> Image.Image:
    """Boxes + labels (ref: vis.py vis_one_image_opencv: vis_class +
    vis_bbox)."""
    if segms is not None or keypoints is not None:
        raise NotImplementedError(
            "mask and keypoint overlays serve the R-CNN families, which "
            "sad_tpu_torch does not port yet (ROADMAP.md Queue 1 item 8)")
    arr = np.ascontiguousarray(im_rgb).copy()
    cmap = colormap()
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
    if out_path:
        img.save(out_path)
    return img
