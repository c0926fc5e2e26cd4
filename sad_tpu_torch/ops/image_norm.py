"""On-device normalisation of uint8 canvases (ref: sad_tpu/ops/image_norm.py).

The host ships raw uint8 canvases; the device applies (x - mean*div) *
(1/(std*div)) in float32, the same two ops as the host path
(sad_tpu/data/minibatch.normalize_image), and forces the canvas padding
outside each image's content extent to exactly 0.0: the reference pads
after normalising (lib/utils/blob.py:40 im_list_to_blob).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def content_mask(shape, content_hw: torch.Tensor) -> torch.Tensor:
    """(N,H,W,1) float32 mask: 1 inside each image's (h, w) content extent."""
    h, w = shape[1], shape[2]
    dev = content_hw.device
    yy = torch.arange(h, dtype=torch.float32, device=dev).view(1, h, 1, 1)
    xx = torch.arange(w, dtype=torch.float32, device=dev).view(1, 1, w, 1)
    chw = content_hw.float()
    m = (yy < chw[:, 0, None, None, None]) & (xx < chw[:, 1, None, None, None])
    return m.float()


def normalize_u8_on_device(
    images: torch.Tensor,  # (N,H,W,3) uint8
    pixel_means: Sequence[float],
    pixel_div: float,
    pixel_std: Sequence[float],
    content_hw: Optional[torch.Tensor] = None,  # (N,2) resized content h, w
    mask: Optional[torch.Tensor] = None,  # precomputed content_mask
) -> torch.Tensor:
    dev = images.device
    bias = torch.tensor([m * pixel_div for m in pixel_means], dtype=torch.float32, device=dev)
    inv = torch.tensor([1.0 / (s * pixel_div) for s in pixel_std],
                       dtype=torch.float32, device=dev)
    out = (images.float() - bias) * inv
    if mask is None and content_hw is not None:
        mask = content_mask(images.shape, content_hw)
    if mask is not None:
        out = out * mask
    return out
