#!/usr/bin/env python3
"""Smoke run of sad_tpu_torch on one CUDA card: build the kernels, check each
against its plain PyTorch version, and drive the serving path end to end.

    python3 chip_smoke.py [--seed 0] [--batch 8] [--iters 10] [--warmup 3]

Run from the root of the repository, on a machine with one NVIDIA Hopper
card, nvcc and PyTorch built for CUDA. Inputs and weights are made from
--seed in memory; nothing is read from disk but the repository. Phases, one
line each (name, what was checked, time):

  env            card name and power limit (nvidia-smi), torch / CUDA
                 versions, TF32 switches, kernel build time
  nms_kernel     csrc/nms.cu against ops.nms.nms_multi_plain on the card:
                 idx and valid exactly equal on every case; median times of
                 both at the decode shape (N=8, K=5000, max_out=100)
  student_infer  R-50-FPN student config, random bf16 weights, a batch of
                 uint8 640x1024 canvases through make_inference_fn; output
                 shapes, finite boxes, classes in 1..80, NMS kernel launched,
                 and detections equal to a decode of the same per-level
                 outputs with the plain NMS on the card; imgs/s
  teacher_infer  the same for the R-101-FPN teacher config (the forward and
                 decode of pseudo-labelling)

Then a JSON line with every kernel of the path, the card's name and power
limit, and as the last line {"ok": true, "device": {...}}. Any failure
raises and the exit code is not 0; without a CUDA card the script exits 2
and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
STUDENT_CFG = "sad_tpu_torch/configs/retinanet_R-50-FPN_student.yaml"
TEACHER_CFG = "sad_tpu_torch/configs/retinanet_R-101-FPN_teacher.yaml"
DECODE_SHAPE = (8, 5000, 100, 0.5)  # N images, K = 5 levels x 1000, max_out, TEST.NMS


def _phase(name: str, checked: str, seconds: float) -> None:
    print(f"[{name}] {checked} ({seconds:.3f} s)", flush=True)


def _median_ms(torch, fn, iters: int, warmup: int) -> float:
    """Median of per-call device times from CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _nms_case(torch, rng, n, k, clusters=60, invalid_from=None, tie_step=None,
              all_invalid_rows=()):
    """Clustered boxes on a 1024x640 canvas so real suppression happens."""
    centers = rng.uniform(0, [1024, 640], (n, clusters, 2))
    which = rng.randint(0, clusters, (n, k))
    xy = np.take_along_axis(centers, which[..., None], axis=1) + rng.uniform(-12, 12, (n, k, 2))
    wh = rng.uniform(8, 120, (n, k, 2))
    boxes = np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)
    scores = rng.uniform(0.0, 1.0, (n, k)).astype(np.float32)
    if tie_step:
        scores = (np.round(scores / tie_step) * tie_step).astype(np.float32)
    if invalid_from is not None:
        scores[:, invalid_from:] = np.float32(-1e30)
    for r in all_invalid_rows:
        scores[r] = np.float32(-1e30)
    dev = "cuda"
    return torch.from_numpy(boxes).to(dev), torch.from_numpy(scores).to(dev)


def phase_nms(torch, rng, iters, warmup):
    from sad_tpu_torch.ops import nms, nms_kernel

    t0 = time.perf_counter()
    n, k, max_out, thr = DECODE_SHAPE
    cases = {
        "decode N=8 K=5000 thr=0.5": (_nms_case(torch, rng, n, k, invalid_from=4600), thr, max_out),
        "N=1 (nms_fixed)": (_nms_case(torch, rng, 1, 3000), 0.5, max_out),
        "K=1500 not a multiple of 1024, thr=0.3": (_nms_case(torch, rng, 3, 1500), 0.3, max_out),
        "invalid tail from 2000, thr=0.7": (_nms_case(torch, rng, 4, 5000, invalid_from=2000), 0.7, max_out),
        "all-invalid problem": (_nms_case(torch, rng, 3, 700, all_invalid_rows=(1,)), 0.5, max_out),
        "fewer valid than max_out": (_nms_case(torch, rng, 2, 300, invalid_from=40), 0.5, max_out),
        "exact score ties": (_nms_case(torch, rng, 8, 5000, tie_step=0.05), 0.5, max_out),
        "K=20000": (_nms_case(torch, rng, 2, 20000, clusters=300), 0.5, max_out),
    }
    max_err = 0.0
    for name, ((boxes, scores), t, m) in cases.items():
        if name.startswith("N=1"):
            ik, vk = nms.nms_fixed(boxes[0], scores[0], t, m)
            ik, vk = ik[None], vk[None]
        else:
            ik, vk = nms.nms_multi(boxes, scores, t, m)
        ip, vp = nms.nms_multi_plain(boxes, scores, t, m)
        torch.cuda.synchronize()
        if not torch.equal(vk, vp) or not torch.equal(ik, ip):
            bad = int((ik != ip).sum()) + int((vk != vp).sum())
            raise AssertionError(f"nms kernel != plain on case {name!r}: {bad} entries differ")
        if name == "all-invalid problem" and (bool(vk[1].any()) or bool(ik[1].any())):
            raise AssertionError("all-invalid problem emitted a detection")
        max_err = max(max_err, float((ik - ip).abs().max()))
    (boxes, scores), _, _ = cases["decode N=8 K=5000 thr=0.5"]
    ms = _median_ms(torch, lambda: nms_kernel.nms_cuda(boxes, scores, thr, max_out), iters * 5, warmup)
    plain_ms = _median_ms(torch, lambda: nms.nms_multi_plain(boxes, scores, thr, max_out), iters, warmup)
    _phase("nms_kernel", f"{len(cases)} cases, idx and valid exactly equal to the plain "
           f"version; decode shape N={n} K={k} max_out={max_out}: kernel {ms:.4f} ms, "
           f"plain {plain_ms:.4f} ms (median)", time.perf_counter() - t0)
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


def phase_infer(torch, name, cfg_path, seed, batch, iters, warmup):
    from sad_tpu_torch.eval.inference import decode_candidates, device_normalize, gather_detections
    from sad_tpu_torch.ops import nms_kernel
    from sad_tpu_torch.ops.nms import nms_multi_plain, offset_by_class
    from sad_tpu_torch.tools.profile_infer import seeded_inference, wall_seconds

    t0 = time.perf_counter()
    cfg, model, infer, args = seeded_inference(os.path.join(REPO, cfg_path), seed, batch, "cuda")
    if tuple(args[0].shape) != (batch, 640, 1024, 3):
        raise AssertionError(f"{name}: canvas {tuple(args[0].shape)}, want {batch}x640x1024x3")
    data, im_hw, im_scale, content_hw = args
    before = nms_kernel.launches
    dets = infer(*args)
    torch.cuda.synchronize()
    launched = nms_kernel.launches - before
    max_out = cfg.TEST.DETECTIONS_PER_IM
    n_fg = cfg.MODEL.NUM_CLASSES - 1
    for key in ("boxes", "scores", "classes", "valid"):
        want = (batch, max_out, 4) if key == "boxes" else (batch, max_out)
        if tuple(dets[key].shape) != want:
            raise AssertionError(f"{name}: {key} shape {tuple(dets[key].shape)} != {want}")
    valid = dets["valid"]
    if not bool(torch.isfinite(dets["boxes"]).all()):
        raise AssertionError(f"{name}: non-finite boxes")
    cls = dets["classes"][valid]
    if cls.numel() == 0 or int(cls.min()) < 1 or int(cls.max()) > n_fg:
        raise AssertionError(f"{name}: {cls.numel()} detections, classes outside 1..{n_fg}")
    if launched < 1:
        raise AssertionError(f"{name}: the NMS kernel was not launched")

    # the same per-level outputs through decode with the plain NMS, on the card
    with torch.inference_mode():
        out = model(device_normalize(cfg, data, content_hw))
        cands = decode_candidates(cfg, out, im_hw, im_scale, cfg.TEST.BBOX_REG)
        ref = gather_detections(cands, *nms_multi_plain(
            *offset_by_class(*cands), cfg.TEST.NMS, max_out))
    for key in ("boxes", "scores", "classes", "valid"):
        if not torch.equal(dets[key], ref[key]):
            raise AssertionError(f"{name}: {key} differs from the plain-NMS decode")

    times = wall_seconds(lambda: infer(*args), iters, warmup)
    med = statistics.median(times)
    _phase(name, f"{cfg_path}: {batch}x640x1024 uint8, {int(valid.sum())} detections, "
           f"classes in 1..{n_fg}, finite boxes, NMS kernel launched {launched}x, equal to "
           f"the plain-NMS decode; {batch / med:.2f} imgs/s, {1000 * med / batch:.3f} ms/img "
           f"(median of {iters} after {warmup} warm-up)", time.perf_counter() - t0)
    return batch / med


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--warmup", type=int, default=3)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke run "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        import sad_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: sad_tpu_torch is not importable from {REPO}: {e}", file=sys.stderr)
        return 3
    from sad_tpu_torch.device import nvidia_smi_line, set_tf32
    from sad_tpu_torch.ops import _build, nms_kernel

    t0 = time.perf_counter()
    gpu = nvidia_smi_line()
    tf32 = set_tf32(False)
    lib = _build.load_library()
    regs = [ln.strip() for ln in lib.log.splitlines() if "registers" in ln]
    _phase("env", f"{gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
           f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; TF32 {tf32}; "
           f"kernels built in {lib.build_seconds:.2f} s ({'cached' if lib.cached else 'nvcc'}, "
           f"{os.path.relpath(lib.path, REPO)}); ptxas: {regs}", time.perf_counter() - t0)

    rng = np.random.RandomState(args.seed)
    nms_stats = phase_nms(torch, rng, args.iters, args.warmup)

    nms_kernel.launches = 0  # count only the main path's launches from here
    phase_infer(torch, "student_infer", STUDENT_CFG, args.seed, args.batch,
                args.iters, args.warmup)
    phase_infer(torch, "teacher_infer", TEACHER_CFG, args.seed + 1, args.batch,
                args.iters, args.warmup)
    main_path_launches = nms_kernel.launches

    print(json.dumps({"kernels": [{
        "name": "greedy_nms",
        "route": "cuda",
        "source": "sad_tpu_torch/csrc/nms.cu",
        "replaces": "sad_tpu/ops/pallas_nms.py:45 (_nms_kernel) and :103 (_nms_kernel_batched)",
        "launches": main_path_launches,
        **nms_stats,
    }]}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
