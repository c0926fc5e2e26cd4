"""Where the time of the training feed goes, on the card's host: the
minibatch builder, the loader's processes and the copy onto the card.

    python -m sad_tpu_torch.tools.profile_feed [--cfg <yaml>] [--images 48] \
        [--workers 2,4,6] [--batches 12] [--seed 0] [--out profile_feed.json]

Writes a synthetic COCO (``--images`` labeled images, sides 480-800, as
chip_smoke.py's loop phases) into a temporary directory and, for the config
(default the R-50 student with profile_train's BENCH_OPTS at bs 8; an R-CNN
YAML builds R-CNN batches), prints and writes as JSON:
- the host: CPUs the process may use, physical cores, torch's intra-op
  threads, whether cv2 is present;
- one process building batches: host ms a batch (median of 4) and, from
  cProfile over 2 more, the share of label assignment, image decode, resize
  and the rest;
- the loader alone, no step: batches/s through MultiprocessTrainingLoader at
  each ``--workers`` count (after 2 warm-up batches);
- a built batch onto the card three ways, ms (median of 10) and the
  process's CPU ms: ``torch.from_numpy(a).pin_memory().to(non_blocking)``
  (DevicePrefetcher's), ``np.copyto`` into a pinned buffer then the same
  copy, and a synchronous ``.to(device)`` from pageable memory.
Needs a CUDA card for the copies; raises without one.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import statistics
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
STUDENT_CFG = os.path.join(REPO, "sad_tpu_torch/configs/retinanet_R-50-FPN_student.yaml")
TEACHER_CFG = os.path.join(REPO, "sad_tpu_torch/configs/retinanet_R-101-FPN_teacher.yaml")

# cProfile function names -> the stage they belong to
_STAGES = (("label_assignment", ("assign_retinanet_labels", "assign_rpn_labels")),
           ("decode", ("load_image_bgr",)),
           ("resize", ("resize_bgr_u8", "_resize_bilinear")),
           ("masks", ("polys_to_mask", "rle_to_mask")))


def host_facts() -> dict:
    cores = set()
    try:
        with open("/proc/cpuinfo") as f:
            phys = core = None
            for line in f:
                if line.startswith("physical id"):
                    phys = line.split(":")[1].strip()
                elif line.startswith("core id"):
                    core = line.split(":")[1].strip()
                    cores.add((phys, core))
    except OSError:
        pass
    try:
        import cv2  # noqa: F401
        has_cv2 = True
    except ImportError:
        has_cv2 = False
    return {"cpus_usable": len(os.sched_getaffinity(0)), "physical_cores": len(cores) or None,
            "torch_threads": torch.get_num_threads(), "cv2": has_cv2}


def _builder_and_roidb(cfg_path, n_images, seed, root):
    from sad_tpu_torch.config import load_cfg, register_dataset
    from sad_tpu_torch.data.dataset import combined_roidb_for_training
    from sad_tpu_torch.data.minibatch import RetinaNetMinibatchBuilder
    from sad_tpu_torch.data.rpn_minibatch import RCNNMinibatchBuilder
    from sad_tpu_torch.data.synth_coco import generate_synthetic_coco
    from sad_tpu_torch.tools.profile_train import BENCH_OPTS

    img_dir, js = generate_synthetic_coco(root, "feed", n_images, seed=seed,
                                          size_range=(480, 800))
    register_dataset("profile_feed", img_dir, js, allow_override=True)
    cfg = load_cfg(cfg_path, BENCH_OPTS + ["NUM_GPUS", "4"])
    if cfg.MODEL.TYPE == "generalized_rcnn":
        builder = RCNNMinibatchBuilder(cfg, device_normalize=True)
    else:
        builder = RetinaNetMinibatchBuilder(cfg, load_cfg(TEACHER_CFG, BENCH_OPTS))
    return cfg, builder, combined_roidb_for_training(["profile_feed"], True)


def build_profile(builder, roidb, batch_images) -> dict:
    land = [e for e in roidb if e["width"] >= e["height"]]
    batches = [land[i * batch_images:(i + 1) * batch_images] for i in range(6)]
    batches = [b for b in batches if len(b) == batch_images]
    times = []
    for i, b in enumerate(batches[:4]):
        t0 = time.perf_counter()
        builder.build(b, seed=i)
        times.append(time.perf_counter() - t0)
    prof = cProfile.Profile()
    prof.enable()
    for i, b in enumerate(batches[4:6] or batches[:2]):
        builder.build(b, seed=10 + i)
    prof.disable()
    st = pstats.Stats(prof)
    total = st.total_tt
    shares = {}
    for stage, names in _STAGES:
        shares[stage] = sum(v[3] for (_, _, fn), v in st.stats.items() if fn in names) / total
    shares["rest"] = 1.0 - sum(shares.values())
    return {"build_ms_median": 1e3 * statistics.median(times),
            "build_ms": [1e3 * t for t in times], "cprofile_share": shares}


def loader_rates(cfg, builder, roidb, workers, n_batches) -> dict:
    from sad_tpu_torch.data.mp_loader import MultiprocessTrainingLoader

    out = {}
    for w in workers:
        loader = MultiprocessTrainingLoader(cfg, roidb, builder=builder, num_workers=w).start()
        try:
            for _ in range(2):
                loader.get_next_batch(timeout=600)
            t0 = time.perf_counter()
            for _ in range(n_batches):
                loader.get_next_batch(timeout=600)
            out[w] = n_batches / (time.perf_counter() - t0)
        finally:
            loader.shutdown()
    return out


def copy_ms(batch, device, reps=10) -> dict:
    arrays = []

    def walk(v):
        if isinstance(v, dict):
            for x in v.values():
                walk(x)
        elif isinstance(v, np.ndarray):
            arrays.append(np.ascontiguousarray(v))

    walk(batch)
    nbytes = sum(a.nbytes for a in arrays)
    pinned = [torch.empty(a.shape, dtype=torch.from_numpy(a[:0]).dtype, pin_memory=True)
              for a in arrays]
    stream = torch.cuda.Stream(device)

    def pin_then_copy():
        with torch.cuda.stream(stream):
            out = [torch.from_numpy(a).pin_memory().to(device, non_blocking=True)
                   for a in arrays]
        stream.synchronize()
        return out

    def copyto_then_copy():
        with torch.cuda.stream(stream):
            out = []
            for a, p in zip(arrays, pinned):
                np.copyto(p.numpy(), a)
                out.append(p.to(device, non_blocking=True))
        stream.synchronize()
        return out

    def pageable():
        out = [torch.from_numpy(a).to(device) for a in arrays]
        torch.cuda.synchronize(device)
        return out

    res = {"bytes": nbytes}
    for name, fn in (("pin_memory", pin_then_copy), ("copyto_pinned", copyto_then_copy),
                     ("pageable", pageable)):
        fn()
        walls, cpus = [], []
        for _ in range(reps):
            t0, c0 = time.perf_counter(), time.process_time()
            fn()
            walls.append(time.perf_counter() - t0)
            cpus.append(time.process_time() - c0)
        res[name] = {"ms": 1e3 * statistics.median(walls),
                     "process_cpu_ms": 1e3 * statistics.median(cpus)}
    return res


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cfg", default=STUDENT_CFG)
    p.add_argument("--images", type=int, default=48)
    p.add_argument("--workers", default="2,4,6")
    p.add_argument("--batches", type=int, default=12)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    from sad_tpu_torch.device import get_device, nvidia_smi_line

    device = get_device("cuda")
    result = {"gpu": nvidia_smi_line(), "cfg": os.path.relpath(args.cfg, REPO),
              "host": host_facts()}
    with tempfile.TemporaryDirectory(prefix="profile_feed_") as root:
        cfg, builder, roidb = _builder_and_roidb(args.cfg, args.images, args.seed, root)
        n = cfg.TRAIN.IMS_PER_BATCH * cfg.NUM_GPUS
        result["batch_images"] = n
        result["one_process"] = build_profile(builder, roidb, n)
        result["loader_batches_per_s"] = loader_rates(
            cfg, builder, roidb, [int(w) for w in args.workers.split(",")], args.batches)
        built = builder.build([e for e in roidb if e["width"] >= e["height"]][:n], seed=0)
        result["copy"] = copy_ms(built.as_pytree() if hasattr(built, "as_pytree") else built,
                                 device)
    print(json.dumps(result, indent=1))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
