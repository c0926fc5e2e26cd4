"""What bounds the multilevel RoIAlign forward kernel on the card.

    python -m sad_tpu_torch.tools.profile_roi_align [--iters 50] [--seed 0] \
        [--shapes box,mask,box_train,mask_train,crop] [--out profile_roi_align.json]

At the five shapes the main paths give the kernel (bf16, C = 256, sr 2, on
the four levels P2..P5 of 8 canvases of 800x1344, rois made as an RPN at work
makes them, ``rpn_like_rois``):
  box         R = 8000 (1000 an image), res 7: Faster / Mask R-CNN serving
  mask        R = 800 (100 an image), res 14: Mask R-CNN serving
  box_train   R = 4096 (512 an image), res 7: the training step
  mask_train  R = 1024 (128 an image), res 14: the training step
  crop        R = 1024, res 28, C = 1, float32, one level of 400 rasters of
              200x336 (8 images x 50 gt slots): the mask-target crop
it prints, and writes as JSON, the device time of a call from torch.profiler
(--iters calls after 5 warm-up calls) and the CUDA-event median, beside
yardsticks that tell the candidate causes apart:
- ``store_only``: PyTorch's zero_ over a tensor of the output's size, the
  rate at which the card writes those bytes;
- ``all_invalid``: the same launch with every roi invalid (the kernel only
  writes zeros: its launch, prologue and store path);
- ``one_cell_block``: every roi moved onto one 2x2 block of cells of its own
  level and image (a zero-area roi), so its taps hit the same few cells: the
  kernel's arithmetic and stores with almost no feature bytes to fetch;
- ``level_image_order``: the same rois sorted by (level, image), so that the
  rois of one map run together (L2 locality);
- the bound (bytes: the output written once, every feature cell a valid
  roi's samples touch read once), and ``staged_mb``: the feature bytes a
  kernel that reads each roi's distinct tapped cells once fetches from L2;
- the SM clock and power draw while the box shape runs (nvidia-smi), and the
  registers, stack and spills of every forward instance (ptxas);
- whether the kernel's output equals the plain twin's bit for bit.
It goes through the public wrapper ``roi_align_kernel.roi_align_fwd_cuda``
only, so it times any version of the kernel: run it on another tree with
``PYTHONPATH=<tree> python sad_tpu_torch/tools/profile_roi_align.py``.
Needs a CUDA card; raises without one.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess

import numpy as np
import torch

from sad_tpu_torch.device import nvidia_smi_line
from sad_tpu_torch.ops import _build, roi_align_kernel
from sad_tpu_torch.ops.proposals import map_rois_to_fpn_levels
from sad_tpu_torch.ops.roi_align import multilevel_roi_align_plain, roi_geometry
from sad_tpu_torch.tools.profile_infer import device_ms

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12
CANVAS = (800, 1344)
BATCH = 8
# name: (rois an image, res); the crop is built apart
SHAPES = {"box": (1000, 7), "mask": (100, 14), "box_train": (512, 7), "mask_train": (128, 14),
          "crop": (128, 28)}
CROP_GT, CROP_HW = 50, (200, 336)


def rpn_like_rois(rng, batch, per_im, canvas, device="cuda"):
    """Image-major rois as an RPN at work makes them: log-uniform sizes from
    16 px to the canvas height, aspect ratios 1:3..3:1, anywhere on the
    canvas and clipped to it, 2 % of the slots invalid. Returns (R, 5)
    float32 rois and (R,) bool valid."""
    ch, cw = canvas
    r = batch * per_im
    size = np.exp(rng.uniform(np.log(16.0), np.log(float(ch)), r))
    ar = np.exp(rng.uniform(-np.log(3.0), np.log(3.0), r))
    w, h = size * np.sqrt(ar), size / np.sqrt(ar)
    cx, cy = rng.uniform(0, cw, r), rng.uniform(0, ch, r)
    boxes = np.stack([np.clip(cx - w / 2, 0, cw - 1), np.clip(cy - h / 2, 0, ch - 1),
                      np.clip(cx + w / 2, 0, cw - 1), np.clip(cy + h / 2, 0, ch - 1)], axis=1)
    rois = np.concatenate([np.repeat(np.arange(batch), per_im)[:, None], boxes], axis=1)
    valid = rng.uniform(size=r) > 0.02
    return (torch.from_numpy(rois.astype(np.float32)).to(device),
            torch.from_numpy(valid).to(device))


def roi_align_bound(feats, rois, levels, valid, res, sr):
    """RoIAlign on this data. Bytes: the output written once, every feature
    cell that a valid roi's samples touch read once, the rois, levels and
    valid flags read once. Operations: a multiply and an add per tap, 4 taps
    a sample, sr x sr samples an output element. Returns the bound dict
    (bound_ms, bound_by), the bytes and the cells touched."""
    lvls = sorted(feats)
    b, c = feats[lvls[0]].shape[0], feats[lvls[0]].shape[-1]
    dims = [(feats[l].shape[1], feats[l].shape[2]) for l in lvls]
    li, bi, _, _, (ylo, yhi, wylo, wyhi), (xlo, xhi, wxlo, wxhi) = roi_geometry(
        dims, lvls[0], b, rois, levels, res, sr)
    r = rois.shape[0]
    dev = rois.device
    # a sample outside [-1, n] has weight 0 on both taps and needs no cell
    y_in = ((wylo + wyhi) > 0).float().reshape(r, -1)
    x_in = ((wxlo + wxhi) > 0).float().reshape(r, -1)
    ylo, yhi, xlo, xhi = (t.reshape(r, -1) for t in (ylo, yhi, xlo, xhi))
    touched = 0
    for k, (h, w) in enumerate(dims):
        for img in range(b):
            sel = valid & (li == k) & (bi == img)
            n_sel = int(sel.sum())
            if n_sel == 0:
                continue
            rows = torch.zeros((n_sel, h), device=dev)
            cols = torch.zeros((n_sel, w), device=dev)
            rows.scatter_add_(1, ylo[sel], y_in[sel]).scatter_add_(1, yhi[sel], y_in[sel])
            cols.scatter_add_(1, xlo[sel], x_in[sel]).scatter_add_(1, xhi[sel], x_in[sel])
            touched += int((((rows > 0).float().T @ (cols > 0).float()) > 0).sum())
    esize = feats[lvls[0]].element_size()
    out_elems = r * res * res * c
    nbytes = out_elems * esize + touched * c * esize + r * (20 + 4 + 1)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = 2 * 4 * sr * sr * out_elems / F32_OPS_PER_S * 1e3
    return ({"bound_ms": max(by_bytes, by_ops),
             "bound_by": "bytes" if by_bytes >= by_ops else "operations"}, nbytes, touched)


def staged_bytes(feats, rois, levels, valid, res, sr):
    """The feature bytes a kernel fetches that reads each valid roi's
    distinct tapped rows x distinct tapped columns once."""
    lvls = sorted(feats)
    b, c = feats[lvls[0]].shape[0], feats[lvls[0]].shape[-1]
    dims = [(feats[l].shape[1], feats[l].shape[2]) for l in lvls]
    _, _, _, _, (ylo, yhi, _, _), (xlo, xhi, _, _) = roi_geometry(
        dims, lvls[0], b, rois, levels, res, sr)
    r = rois.shape[0]

    def distinct(lo, hi):
        v = torch.sort(torch.cat([lo.reshape(r, -1), hi.reshape(r, -1)], 1), dim=1).values
        return 1 + (v[:, 1:] != v[:, :-1]).sum(dim=1)

    cells = distinct(ylo, yhi) * distinct(xlo, xhi)
    return int(cells[valid].sum()) * c * feats[lvls[0]].element_size()


def shape_case(name, rng, gen, device="cuda"):
    """feats {level: (B, H, W, C)}, rois, levels, valid, res of one shape."""
    per_im, res = SHAPES[name]
    if name == "crop":
        # gt rasters at stride 4 (level 2): 8 images x 50 slots of 200x336, C = 1
        maps = {2: (torch.rand((BATCH * CROP_GT, *CROP_HW, 1), generator=gen, device=device)
                    > 0.5).float()}
        rois, _ = rpn_like_rois(rng, BATCH, per_im, CANVAS, device)
        n_gt = rng.randint(1, 9, BATCH)  # 1-8 gt boxes an image
        which = np.concatenate([i * CROP_GT + rng.randint(0, n_gt[i], per_im)
                                for i in range(BATCH)])
        rois[:, 0] = torch.from_numpy(which.astype(np.float32)).to(device)
        n = rois.shape[0]
        return (maps, rois, torch.full((n,), 2, dtype=torch.int32, device=device),
                torch.ones((n,), dtype=torch.bool, device=device), res)
    feats = {l: torch.randn((BATCH, CANVAS[0] >> l, CANVAS[1] >> l, 256), generator=gen,
                            device=device).to(torch.bfloat16) for l in range(2, 6)}
    rois, valid = rpn_like_rois(rng, BATCH, per_im, CANVAS, device)
    return feats, rois, map_rois_to_fpn_levels(rois[:, 1:], 2, 5), valid, res


def event_median_ms(fn, iters, warmup=5):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _fwd(feats, rois, levels, valid, res, sr=2):
    lvls = sorted(feats)
    fl = [feats[l] for l in lvls]
    return lambda: roi_align_kernel.roi_align_fwd_cuda(fl, lvls[0], rois, levels, valid, res, sr)


def _clock_under_load(fn, launches):
    for _ in range(launches):
        fn()
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    torch.cuda.synchronize()
    return out.stdout.strip()


def ptxas_lines(log):
    """ptxas's registers, stack and spills of every roi_align_fwd instance."""
    regs, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
        elif name and "roi_align_fwd" in name and ("registers" in ln or "spill" in ln):
            regs[name] = (regs.get(name, "") + " " + ln.strip()).strip()
    return regs


def profile_shape(name, rng, gen, iters):
    feats, rois, levels, valid, res = shape_case(name, rng, gen)
    run = _fwd(feats, rois, levels, valid, res)
    out = run()
    equal = torch.equal(out, multilevel_roi_align_plain(feats, rois, levels, valid, res, 2))
    kernel = "roi_align_fwd"
    t = {"device_ms": sum(device_ms(run, iters, 5, kernel).values()),
         "event_ms": event_median_ms(run, iters)}
    t["store_only_ms"] = sum(device_ms(lambda: out.zero_(), iters, 5).values())
    t["all_invalid_ms"] = sum(device_ms(_fwd(feats, rois, levels, torch.zeros_like(valid), res),
                                        iters, 5, kernel).values())
    # a zero-area roi at one interior point of its own map: taps on a 2x2 block
    point = rois.clone()
    point[:, 1:] = torch.tensor([40.0, 40.0, 40.0, 40.0], device=rois.device)
    t["one_cell_block_ms"] = sum(device_ms(_fwd(feats, point, levels, valid, res), iters, 5,
                                           kernel).values())
    key = levels.long() * (1 << 20) + rois[:, 0].long()
    order = torch.sort(key, stable=True).indices
    t["level_image_order_ms"] = sum(device_ms(
        _fwd(feats, rois[order].contiguous(), levels[order].contiguous(),
             valid[order].contiguous(), res), iters, 5, kernel).values())
    b, nbytes, touched = roi_align_bound(feats, rois, levels, valid, res, 2)
    counts = torch.bincount(levels[valid].long(), minlength=6)[2:].tolist()
    f0 = feats[min(feats)]
    info = {"R": rois.shape[0], "res": res, "C": f0.shape[-1], "dtype": str(f0.dtype),
            "bit_equal_to_plain": equal,
            "rois_per_level_P2_P5": counts, "bytes_mb": nbytes / 1e6, "cells_touched": touched,
            "output_mb": out.numel() * out.element_size() / 1e6,
            "staged_mb": staged_bytes(feats, rois, levels, valid, res, 2) / 1e6, **b, **t}
    if name == "box":
        info["clock_power_under_load"] = _clock_under_load(run, 2000)
    return info


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--shapes", default=",".join(SHAPES))
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_roi_align needs a CUDA card")

    lib = _build.load_library()
    result = {"gpu": nvidia_smi_line(), "ptxas": ptxas_lines(lib.log), "shapes": {}}
    for k, v in result["ptxas"].items():
        print(f"[ptxas] {k}: {v}", flush=True)
    for name in args.shapes.split(","):
        rng = np.random.RandomState(args.seed + 7)
        gen = torch.Generator(device="cuda").manual_seed(args.seed + 7)
        info = profile_shape(name, rng, gen, args.iters)
        result["shapes"][name] = info
        print(f"[{name}] " + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                                       for k, v in info.items()), flush=True)
        torch.cuda.empty_cache()
    print(result["gpu"])
    print(json.dumps(result))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
