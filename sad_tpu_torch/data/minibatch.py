"""Minibatch construction: image prep + dense RetinaNet target blobs.

A copy of sad_tpu/data/minibatch.py, with sad_tpu/utils/segms.py's
``_resize_bilinear`` (the cv2-exact downscale that every image with a short
side above the training scale goes through) as a private helper here.

Capability-equivalent to detectron/lib/roi_data/minibatch.py +
lib/utils/blob.py:40-106 with TPU-static shapes:

- pixel pipeline (preprocess order matters): im / PIXEL_DIV - PIXEL_MEANS,
  then / PIXEL_STD, THEN bilinear resize (blob.py:70-96). BGR channel order.
- resize shortest side to TRAIN.SCALES[0], capped so the long side
  <= MAX_SIZE (blob.py:87-99).
- when distilling, a second copy of the image is normalized with the
  *teacher's* pixel constants at the *student's* geometry
  (minibatch.py:74-82 — the teacher always sees the same scale jitter).
- images land on one of two fixed canvases (landscape/portrait), padded to
  FPN.COARSEST_STRIDE multiples — replacing the reference's pad-to-max-in-
  minibatch (im_list_to_blob, blob.py:51-56) with static shapes (two compiled
  programs instead of unbounded shape churn). The reference aspect-groups
  batches already (loader.py:196-218), so per-batch uniformity is preserved.
- anchors are labeled on the full square field of size fpn_max_size
  (data_utils.py:70-73), then cropped to the canvas grid — the reference
  crops to the padded blob too (add_retinanet_blobs receives the blob's
  padded W/H, minibatch.py:88-93), so pad-region anchors count as background
  exactly as in the reference. num_fg is the pre-crop count
  (retinanet.py:244-247). (The reference's bbox-loss location rows falling
  outside the blob would index out of bounds in its CUDA kernel; those are
  excluded here — see tests/test_minibatch.py.)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

try:  # the reference's decoder/resizer; PIL/numpy paths are the fallback
    import cv2 as _cv2
except ImportError:  # pragma: no cover
    _cv2 = None

from ..config import Config

from .anchors import all_field_anchors, assign_retinanet_labels


def _resize_bilinear(m: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """cv2.resize(..., INTER_LINEAR) semantics on a 2-D (or HWC 3-D) float
    map: half-pixel sampling grid, 2-tap linear weights, clamped borders —
    NO antialiasing on downscale (PIL's BILINEAR antialiases; cv2's
    INTER_LINEAR does not). Delegates to real cv2 when importable (verified
    equal to the numpy kernel within float tolerance,
    tests/test_aux_surface.py); the numpy path is the no-cv2 fallback and
    the cross-check oracle."""
    if _cv2 is not None:
        out = _cv2.resize(
            np.ascontiguousarray(m), (out_w, out_h),
            interpolation=_cv2.INTER_LINEAR,
        )
        if m.ndim == 3 and out.ndim == 2:  # cv2 drops a size-1 channel dim
            out = out[:, :, None]
        return out
    in_h, in_w = m.shape[:2]

    def axis(out_n, in_n):
        src = (np.arange(out_n) + 0.5) * in_n / out_n - 0.5
        i0 = np.floor(src).astype(np.int64)
        f = (src - i0).astype(np.float32)
        idx = np.clip(np.stack([i0, i0 + 1], 1), 0, in_n - 1)
        w = np.stack([1.0 - f, f], 1)
        return idx, w

    iy, wy = axis(out_h, in_h)
    ix, wx = axis(out_w, in_w)
    # accumulate per tap (peak memory = one output-sized plane)
    if m.ndim == 3:
        c = m.shape[2]
        tmp = np.zeros((out_h, in_w, c), np.float32)
        for t in range(2):
            tmp += m[iy[:, t]] * wy[:, t, None, None]
        out = np.zeros((out_h, out_w, c), np.float32)
        for t in range(2):
            out += tmp[:, ix[:, t]] * wx[None, :, t, None]
        return out
    tmp = np.zeros((out_h, in_w), np.float32)
    for t in range(2):
        tmp += m[iy[:, t]] * wy[:, t, None]
    out = np.zeros((out_h, out_w), np.float32)
    for t in range(2):
        out += tmp[:, ix[:, t]] * wx[None, :, t]
    return out


def fpn_max_size(cfg: Config) -> int:
    cs = cfg.FPN.COARSEST_STRIDE
    return int(cs * np.ceil(cfg.TRAIN.MAX_SIZE / float(cs)))


def canvas_shapes(cfg: Config) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """(landscape, portrait) static canvases: short side padded from
    max(SCALES), long side from MAX_SIZE, both to COARSEST_STRIDE."""
    cs = cfg.FPN.COARSEST_STRIDE
    short = int(cs * np.ceil(max(cfg.TRAIN.SCALES) / float(cs)))
    long = int(cs * np.ceil(cfg.TRAIN.MAX_SIZE / float(cs)))
    long = max(long, short)
    return (short, long), (long, short)


def load_image_bgr(path: str, flipped: bool = False) -> np.ndarray:
    """uint8 HWC BGR (the reference reads with cv2 => BGR, minibatch.py:116).
    cv2.imread when available — the reference's exact decoder, and it skips
    the RGB->BGR copy; PIL fallback otherwise."""
    if _cv2 is not None:
        bgr = _cv2.imread(path, _cv2.IMREAD_COLOR)
        if bgr is not None:
            return np.ascontiguousarray(bgr[:, ::-1]) if flipped else bgr
    with Image.open(path) as img:
        rgb = np.asarray(img.convert("RGB"))
    if flipped:
        rgb = rgb[:, ::-1, :]
    return rgb[:, :, ::-1].copy()


def compute_im_scale(h: int, w: int, target_size: int, max_size: int) -> float:
    """Shortest-side scale with long-side cap (blob.py:87-93)."""
    size_min, size_max = min(h, w), max(h, w)
    scale = float(target_size) / float(size_min)
    if np.round(scale * size_max) > max_size:
        scale = float(max_size) / float(size_max)
    return scale


def resize_bgr_u8(im_bgr: np.ndarray, scale: float) -> np.ndarray:
    """Bilinear uint8 resize (shared by every normalization stream — the
    teacher sees the student's geometry, only pixel normalization differs,
    ref minibatch.py:74-82).

    Upscale: PIL (2-tap bilinear, identical sampling grid to cv2
    INTER_LINEAR, fast C loop). Downscale: PIL would antialias
    (area-average) where cv2 takes plain 2-tap samples, so the cv2-exact
    numpy kernel is used instead — e.g. COCO images with shortest side
    > TRAIN.SCALES get a <1 scale."""
    new_w = int(round(im_bgr.shape[1] * scale))
    new_h = int(round(im_bgr.shape[0] * scale))
    if (new_h, new_w) == im_bgr.shape[:2]:
        return im_bgr
    if scale >= 1.0:
        return np.asarray(
            Image.fromarray(im_bgr).resize((new_w, new_h), Image.BILINEAR)
        )
    out = _resize_bilinear(im_bgr.astype(np.float32), new_h, new_w)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def normalize_image(
    im: np.ndarray,
    pixel_means: Sequence[float],
    pixel_div: float,
    pixel_std: Sequence[float],
) -> np.ndarray:
    """(x/div - mean)/std fused to one subtract + one multiply:
    (x - mean*div) * (1/(std*div))."""
    bias = (
        np.asarray(pixel_means, np.float32) * np.float32(pixel_div)
    ).reshape(1, 1, 3)
    inv = (
        1.0
        / (np.asarray(pixel_std, np.float32) * np.float32(pixel_div))
    ).reshape(1, 1, 3)
    out = im.astype(np.float32)
    out -= bias
    out *= inv
    return out


def prep_image(
    im_bgr: np.ndarray,
    scale: float,
    pixel_means: Sequence[float],
    pixel_div: float,
    pixel_std: Sequence[float],
    precise: bool = False,
) -> np.ndarray:
    """Normalize + bilinear-resize (ref order: normalize then resize,
    blob.py:70-96).

    Fast path (default): resize the uint8 image once, then normalize —
    valid because per-channel affine normalization commutes with bilinear
    resampling; only the resampler's uint8 rounding differs (<=0.5 LSB).
    ~3x faster on the single-core host than per-channel float resizes.
    precise=True keeps the reference's exact float order."""
    if not precise and im_bgr.dtype == np.uint8:
        return normalize_image(
            resize_bgr_u8(im_bgr, scale), pixel_means, pixel_div, pixel_std
        )

    new_w = int(round(im_bgr.shape[1] * scale))
    new_h = int(round(im_bgr.shape[0] * scale))
    if precise:
        # the reference's EXACT float order (blob.py preprocess_im:
        # x/div, -mean, /std — two true divisions, no fused reciprocal)
        im = im_bgr.astype(np.float32)
        im = im / np.float32(pixel_div)
        im -= np.asarray(pixel_means, np.float32).reshape(1, 1, 3)
        im /= np.asarray(pixel_std, np.float32).reshape(1, 1, 3)
    else:
        im = normalize_image(im_bgr, pixel_means, pixel_div, pixel_std)
    if (new_h, new_w) != im.shape[:2]:
        # exact cv2 INTER_LINEAR semantics (blob.py:94 resizes the float
        # image with cv2; PIL would antialias on downscale)
            im = _resize_bilinear(np.ascontiguousarray(im), new_h, new_w)
    return im


@dataclass
class RetinaNetBatch:
    """Host-side batch matching sad_tpu_torch.train.train_step's batch layout.

    Two storage modes: host-normalized f32 ('data' [+ 'teacher_data']), or
    device-normalized uint8 ('data_u8' + 'content_hw') where ONE raw canvas
    serves both the student and teacher normalization streams on device
    (sad_tpu_torch.ops.image_norm) — 4-8x less host->device traffic."""

    data: Optional[np.ndarray]
    teacher_data: Optional[np.ndarray]
    labels: Dict[int, np.ndarray]
    bbox_targets: Dict[int, np.ndarray]
    fg_mask: Dict[int, np.ndarray]
    fg_num: np.ndarray
    im_hw: np.ndarray  # (B, 2) original sizes (for inference/debug)
    im_scale: np.ndarray  # (B,)
    data_u8: Optional[np.ndarray] = None  # (B,H,W,3) uint8 shared canvas
    content_hw: Optional[np.ndarray] = None  # (B,2) resized content extents
    canvas_h: Optional[int] = None  # the canvas height, when the arrays are bands of rows

    def as_pytree(self) -> Dict:
        d = {
            "labels": self.labels,
            "bbox_targets": self.bbox_targets,
            "fg_mask": self.fg_mask,
            "fg_num": self.fg_num,
        }
        if self.data_u8 is not None:
            d["data_u8"] = self.data_u8
            d["content_hw"] = self.content_hw
        else:
            d["data"] = self.data
            if self.teacher_data is not None:
                d["teacher_data"] = self.teacher_data
        if self.canvas_h is not None:
            d["canvas_h"] = self.canvas_h
        return d


class RetinaNetMinibatchBuilder:
    """Builds static-shape training batches for one canvas orientation.

    device_normalize (default from cfg.DATA_LOADER.DEVICE_NORMALIZE): ship
    ONE raw uint8 canvas per image + content extents; the train step
    normalizes per stream on device. False = host-normalized f32 blobs (the
    reference's layout)."""

    def __init__(
        self,
        cfg: Config,
        teacher_cfg: Optional[Config] = None,
        device_normalize: Optional[bool] = None,
    ):
        self.cfg = cfg
        self.teacher_cfg = teacher_cfg
        self.device_normalize = (
            cfg.DATA_LOADER.DEVICE_NORMALIZE
            if device_normalize is None
            else device_normalize
        )
        self.landscape, self.portrait = canvas_shapes(cfg)
        fms = fpn_max_size(cfg)
        # square assignment field covering every canvas (data_utils.py:70-73)
        self._assign_grid = all_field_anchors(
            cfg.fpn_levels(),
            cfg.RETINANET.ANCHOR_SCALE,
            cfg.RETINANET.ASPECT_RATIOS,
            cfg.RETINANET.SCALES_PER_OCTAVE,
            fms,
            fms,
        )

    def canvas_for(self, entry: dict) -> Tuple[int, int]:
        return self.landscape if entry["width"] >= entry["height"] else self.portrait

    def build(
        self,
        entries: List[dict],
        images_bgr: Optional[List[np.ndarray]] = None,
        seed: int = 0,
        rows: Optional[Tuple[int, int]] = None,
    ) -> RetinaNetBatch:
        """entries must share one canvas orientation (aspect grouping).
        ``rows`` = (start, stop): build only those images of the batch (a
        rank's share), as the whole batch's build would make them."""
        cfg = self.cfg
        # per-image random scale index (ref: roi_data/minibatch.py:48-53
        # _get_image_blob samples scale_inds per image)
        rng = np.random.RandomState(seed)
        scale_inds = rng.randint(0, len(cfg.TRAIN.SCALES), size=len(entries))
        if rows is not None:
            entries, scale_inds = entries[rows[0]:rows[1]], scale_inds[rows[0]:rows[1]]
            if images_bgr is not None:
                images_bgr = images_bgr[rows[0]:rows[1]]
        canvas = self.canvas_for(entries[0])
        assert all(self.canvas_for(e) == canvas for e in entries), (
            "batch mixes canvas orientations; aspect-group upstream"
        )
        ch, cw = canvas
        n = len(entries)
        ims_per_group = cfg.TRAIN.IMS_PER_BATCH
        assert n % ims_per_group == 0, (n, ims_per_group)
        n_groups = n // ims_per_group

        dev_norm = self.device_normalize
        if dev_norm:
            data_u8 = np.zeros((n, ch, cw, 3), np.uint8)
            content_hw = np.zeros((n, 2), np.float32)
            data = teacher_data = None
        else:
            data_u8 = content_hw = None
            data = np.zeros((n, ch, cw, 3), np.float32)
            teacher_data = (
                np.zeros((n, ch, cw, 3), np.float32)
                if self.teacher_cfg
                else None
            )
        im_hw = np.zeros((n, 2), np.float32)
        im_scales = np.zeros((n,), np.float32)

        levels = cfg.fpn_levels()
        lvl_hw = {lvl: (ch // (2 ** lvl), cw // (2 ** lvl)) for lvl in levels}
        A = cfg.num_anchors_per_cell()
        labels = {
            lvl: np.zeros((n, h, w, A), np.int32) for lvl, (h, w) in lvl_hw.items()
        }
        bbox_targets = {
            lvl: np.zeros((n, h, w, A, 4), np.float32)
            for lvl, (h, w) in lvl_hw.items()
        }
        fg_mask = {
            lvl: np.zeros((n, h, w, A), bool) for lvl, (h, w) in lvl_hw.items()
        }
        fg_per_image = np.zeros((n,), np.float32)

        for i, entry in enumerate(entries):
            im_bgr = (
                images_bgr[i]
                if images_bgr is not None
                else load_image_bgr(entry["image"], entry.get("flipped", False))
            )
            scale = compute_im_scale(
                entry["height"], entry["width"],
                cfg.TRAIN.SCALES[scale_inds[i]], cfg.TRAIN.MAX_SIZE,
            )
            # resize ONCE; normalization is per stream and happens either
            # here (f32 mode) or on device (u8 mode) — the teacher always
            # shares the student's geometry, ref minibatch.py:74-82
            if dev_norm:
                if im_bgr.dtype != np.uint8:
                    raise ValueError(
                        "device_normalize needs uint8 source images"
                    )
                im = resize_bgr_u8(im_bgr, scale)
                h, w = im.shape[:2]
                assert h <= ch and w <= cw, (h, w, canvas)
                data_u8[i, :h, :w] = im
                content_hw[i] = (h, w)
            else:
                im_r = (
                    resize_bgr_u8(im_bgr, scale)
                    if im_bgr.dtype == np.uint8
                    else im_bgr
                )
                im = (
                    normalize_image(im_r, cfg.PIXEL_MEANS, cfg.PIXEL_DIV, cfg.PIXEL_STD)
                    if im_bgr.dtype == np.uint8
                    else prep_image(im_bgr, scale, cfg.PIXEL_MEANS, cfg.PIXEL_DIV, cfg.PIXEL_STD)
                )
                h, w = im.shape[:2]
                assert h <= ch and w <= cw, (h, w, canvas)
                data[i, :h, :w] = im
                if teacher_data is not None:
                    tc = self.teacher_cfg
                    tim = (
                        normalize_image(im_r, tc.PIXEL_MEANS, tc.PIXEL_DIV, tc.PIXEL_STD)
                        if im_bgr.dtype == np.uint8
                        else prep_image(im_bgr, scale, tc.PIXEL_MEANS, tc.PIXEL_DIV, tc.PIXEL_STD)
                    )
                    teacher_data[i, :h, :w] = tim
            im_hw[i] = (entry["height"], entry["width"])
            im_scales[i] = scale

            keep = (entry["gt_classes"] > 0) & (~entry["is_crowd"])
            gt_boxes = entry["boxes"][keep] * scale
            gt_classes = entry["gt_classes"][keep]
            lv_labels, lv_targets, lv_masks, num_fg, _ = assign_retinanet_labels(
                self._assign_grid,
                gt_boxes,
                gt_classes,
                im_h=ch,  # crop to the padded canvas, like the reference
                im_w=cw,
                positive_overlap=cfg.RETINANET.POSITIVE_OVERLAP,
                negative_overlap=cfg.RETINANET.NEGATIVE_OVERLAP,
            )
            fg_per_image[i] = num_fg
            for lvl, ll, tt, mm in zip(levels, lv_labels, lv_targets, lv_masks):
                h_l, w_l = lvl_hw[lvl]
                labels[lvl][i] = ll[:h_l, :w_l]
                bbox_targets[lvl][i] = tt[:h_l, :w_l]
                fg_mask[lvl][i] = mm[:h_l, :w_l]

        fg_num = fg_per_image.reshape(n_groups, ims_per_group).sum(axis=1)
        return RetinaNetBatch(
            data=data,
            teacher_data=teacher_data,
            labels=labels,
            bbox_targets=bbox_targets,
            fg_mask=fg_mask,
            fg_num=fg_num.astype(np.float32),
            im_hw=im_hw,
            im_scale=im_scales,
            data_u8=data_u8,
            content_hw=content_hw,
        )
