"""Where the time of batched inference goes, on the card.

    python -m sad_tpu_torch.tools.profile_infer --cfg sad_tpu_torch/configs/retinanet_R-50-FPN_student.yaml \
        [--batch 8] [--iters 20] [--seed 0] [--out profile_student.json]

Seeded random weights in the config's compute dtype and seeded uint8 canvases
of the config's landscape test canvas. Prints, and writes as JSON:
- imgs/s: median and quartiles of --iters timed batches (host clock around
  torch.cuda.synchronize(), profiler off);
- per-stage device ms (CUDA events, medians): normalise, forward, decode
  before NMS, NMS, gather;
- from a torch.profiler run of 5 batches: kernel time by category (conv,
  elementwise, top-k/sort, NMS kernel, other), the top kernels by name, and
  the device idle share = 1 - kernel time / wall time, against the wall time
  of the profiled run and of the unprofiled timed batches.
Needs a CUDA card; raises without one. chip_smoke.py builds its inference
runs with ``seeded_inference`` and times them with ``wall_seconds``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time

import numpy as np
import torch

from sad_tpu_torch.config import load_cfg
from sad_tpu_torch.data.synthetic import random_canvases
from sad_tpu_torch.device import get_device, nvidia_smi_line, set_tf32
from sad_tpu_torch.eval.inference import (
    decode_candidates, device_normalize, gather_detections, make_inference_fn,
)
from sad_tpu_torch.eval.test_engine import _test_canvas_shapes
from sad_tpu_torch.models import compute_dtype, create_model
from sad_tpu_torch.ops.nms import batched_nms_multi

_CATEGORIES = (
    ("nms_kernel", ("nms_kernel",)),
    ("conv", ("conv", "xmma", "cutlass", "implicit_gemm", "cudnn", "nchwToNhwc", "nhwcToNchw")),
    ("topk_sort", ("topk", "sort", "radix", "mbtopk")),
    ("elementwise", ("elementwise", "reduce_kernel", "index")),
)


def _category(name: str) -> str:
    low = name.lower()
    for cat, keys in _CATEGORIES:
        if any(k.lower() in low for k in keys):
            return cat
    return "other"


def _quartiles(xs):
    q = statistics.quantiles(xs, n=4)
    return {"median": statistics.median(xs), "q1": q[0], "q3": q[2], "n": len(xs)}


def seeded_inference(cfg_path: str, seed: int, batch: int, device):
    """The config, its model with random weights from ``seed`` in the
    compute dtype, make_inference_fn of it, and the arguments of one batch
    of seeded uint8 canvases of the config's landscape test canvas."""
    cfg = load_cfg(cfg_path)
    model = create_model(cfg, device, torch.Generator(device=device).manual_seed(seed))
    model.to(compute_dtype(cfg))
    (ch, cw), _ = _test_canvas_shapes(cfg)
    b = random_canvases(np.random.RandomState(seed), batch, (ch, cw), device)
    args = (b["data"], b["im_hw"], b["im_scale"], b["content_hw"])
    return cfg, model, make_inference_fn(cfg, model), args


def wall_seconds(fn, iters: int, warmup: int):
    """Host-clock seconds of each of ``iters`` calls of fn after ``warmup``
    untimed calls, each timed call between two torch.cuda.synchronize()."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cfg", required=True)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    dev = get_device("cuda")
    set_tf32(False)
    gpu = nvidia_smi_line()
    cfg, model, infer, x = seeded_inference(args.cfg, args.seed, args.batch, dev)
    n = args.batch
    ch, cw = x[0].shape[1:3]
    walls = wall_seconds(lambda: infer(*x), args.iters, 5)

    stages = {k: [] for k in ("normalize", "forward", "decode_pre_nms", "nms", "gather")}
    with torch.inference_mode():
        for _ in range(args.iters):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
            ev[0].record()
            im = device_normalize(cfg, x[0], x[3])
            ev[1].record()
            out = model(im)
            ev[2].record()
            cands = decode_candidates(cfg, out, x[1], x[2], cfg.TEST.BBOX_REG)
            ev[3].record()
            keep = batched_nms_multi(*cands, cfg.TEST.NMS, cfg.TEST.DETECTIONS_PER_IM)
            ev[4].record()
            gather_detections(cands, *keep)
            ev[5].record()
            torch.cuda.synchronize()
            for i, k in enumerate(stages):
                stages[k].append(ev[i].elapsed_time(ev[i + 1]))
        n_valid = int(cands[3].sum())

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            infer(*x)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    by_cat = {}
    for e in kernels:
        cat = _category(e.key)
        by_cat[cat] = by_cat.get(cat, 0.0) + e.self_device_time_total / 1e3 / 5
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]

    med = statistics.median(walls)
    result = {
        "gpu": gpu,
        "cfg": args.cfg,
        "batch": n,
        "canvas": [ch, cw],
        "compute_dtype": cfg.COMPUTE_DTYPE,
        "imgs_per_s": n / med,
        "batch_ms": {k: v * 1e3 for k, v in _quartiles(walls).items() if k != "n"},
        "iters": args.iters,
        "stage_ms": {k: statistics.median(v) for k, v in stages.items()},
        "valid_candidates_per_batch": n_valid,
        "profiled_batches": 5,
        "kernel_ms_per_batch": busy_ms / 5,
        "kernel_ms_by_category_per_batch": by_cat,
        "profiled_wall_ms_per_batch": prof_wall_ms / 5,
        "device_idle_share_profiled": 1.0 - busy_ms / prof_wall_ms,
        "device_idle_share_vs_unprofiled_wall": 1.0 - busy_ms / 5 / (med * 1e3),
        "top_kernels_ms_per_batch": [[e.key[:90], e.self_device_time_total / 1e3 / 5, e.count // 5]
                                     for e in top],
    }
    print(json.dumps(result, indent=1))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
