"""Where the time of a training step goes, on the card: the joint SAD step,
or with --cfg an R-CNN YAML the Faster / Mask R-CNN step.

    python -m sad_tpu_torch.tools.profile_train [--groups 4] [--iters 10] \
        [--warmup 3] [--seed 0] [--out profile_train.json] \
        [--cfg sad_tpu_torch/configs/e2e_mask_rcnn_R-50-FPN.yaml]

The R-50-FPN student and the frozen R-101-FPN teacher of
sad_tpu_torch/configs/ at full width and depth, random weights from --seed,
bf16 compute, PIXEL_STD (57.375, 57.12, 58.395) and LR 1e-6 (the settings
of bench.py, which keep a randomly initialised step finite), and one batch
of --groups x TRAIN.IMS_PER_BATCH seeded training images with gt boxes,
built by the port's RetinaNetMinibatchBuilder on the 640x1024 canvas.
Prints, and writes as JSON:
- imgs/s: median and quartiles of --iters timed steps after --warmup
  (host clock around torch.cuda.synchronize(), profiler off);
- per-stage device ms (CUDA events, medians): normalise, teacher forward,
  student forward, losses forward, backward, SGD;
- from a torch.profiler run of 3 steps: kernel time by category (conv,
  cls-loss kernels, optimizer, elementwise, other), the top kernels by name,
  and the device idle share = 1 - kernel time / wall time;
- the peak device memory of a step.
With --cfg sad_tpu_torch/configs/e2e_{faster,mask}_rcnn_R-50-FPN.yaml: the
R-50-FPN R-CNN at full width and depth with the same overrides, --groups x
TRAIN.IMS_PER_BATCH seeded images with 1-8 gt boxes and a polygon each on
the 800x1344 canvas, built by the port's RCNNMinibatchBuilder, the output
layers rescaled by profile_infer.spread_rcnn_outputs so that the RPN fills
its slots; stages: normalise, backbone+FPN, RPN head + losses, proposals,
sampling, RoIAlign + box head + losses, mask branch, backward, SGD.

Needs a CUDA card; raises without one. chip_smoke.py builds its training
runs with ``seeded_train_step`` and ``seeded_rcnn_train_step``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time
from dataclasses import dataclass
from typing import Any, Dict, Sequence

import numpy as np
import torch

from sad_tpu_torch.config import load_cfg
from sad_tpu_torch.data.minibatch import RetinaNetMinibatchBuilder
from sad_tpu_torch.data.rpn_minibatch import RCNNMinibatchBuilder
from sad_tpu_torch.data.synthetic import random_train_entries
from sad_tpu_torch.device import get_device, nvidia_smi_line, set_tf32
from sad_tpu_torch.models import create_model
from sad_tpu_torch.tools.profile_infer import (
    _quartiles, is_rcnn, spread_rcnn_outputs, wall_seconds,
)
from sad_tpu_torch.train import (
    TrainState, batch_to_torch, make_rcnn_train_step, make_train_step,
)
from sad_tpu_torch.train.rcnn_train import RCNNTrainStep
from sad_tpu_torch.train.train_step import TrainStep

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
STUDENT_CFG = os.path.join(REPO, "sad_tpu_torch/configs/retinanet_R-50-FPN_student.yaml")
TEACHER_CFG = os.path.join(REPO, "sad_tpu_torch/configs/retinanet_R-101-FPN_teacher.yaml")
# bench.py:40-50: bf16, and unit-scale inputs so a random init stays finite
BENCH_OPTS = ["COMPUTE_DTYPE", "bfloat16", "PIXEL_STD", "(57.375,57.12,58.395)",
              "TRAIN.WEIGHTS", ""]
BENCH_LR = 1e-6

_CATEGORIES = (
    ("cls_loss_kernels", ("cls_losses",)),
    # the backward's binning (count, scan, fill) and gather kernels
    ("roi_align_bwd_kernel", ("roi_align_bwd_gather_kernel", "roi_bwd_")),
    ("roi_align_fwd_kernel", ("roi_align_fwd_kernel",)),
    ("nms_kernel", ("nms_order_kernel", "nms_mask_kernel", "nms_sweep_kernel",
                    "nms_argmax_kernel")),
    ("optimizer", ("multi_tensor_apply", "foreach")),
    ("conv", ("conv", "xmma", "cutlass", "implicit_gemm", "cudnn", "nchwToNhwc", "nhwcToNchw",
              "wgrad", "dgrad", "sm90_", "gemm")),
    ("elementwise", ("elementwise", "reduce_kernel", "index", "upsample", "max_pool")),
)


def _category(name: str) -> str:
    low = name.lower()
    for cat, keys in _CATEGORIES:
        if any(k.lower() in low for k in keys):
            return cat
    return "other"


@dataclass
class SeededTrainStep:
    student_cfg: Any
    teacher_cfg: Any
    student: torch.nn.Module
    teacher: torch.nn.Module
    step: TrainStep
    state: TrainState
    batch: Dict[str, Any]  # tensors on the device
    n_images: int


def seeded_train_step(student_yaml: str = STUDENT_CFG, teacher_yaml: str = TEACHER_CFG,
                      seed: int = 0, n_groups: int = 4, device="cuda",
                      opts: Sequence[str] = ()) -> SeededTrainStep:
    """Both models with random float32 weights from ``seed``, the joint SAD
    step of the student, its zero momentum, and one batch of n_groups x
    TRAIN.IMS_PER_BATCH seeded images with gt boxes built by
    RetinaNetMinibatchBuilder.build into one uint8 canvas per image, on
    ``device``."""
    dev = get_device(device)
    opts = BENCH_OPTS + ["NUM_GPUS", str(n_groups)] + list(opts)
    scfg = load_cfg(student_yaml, opts)
    tcfg = load_cfg(teacher_yaml, opts)
    student = create_model(scfg, dev, torch.Generator(device=dev).manual_seed(seed))
    teacher = create_model(tcfg, dev, torch.Generator(device=dev).manual_seed(seed + 1))
    n_images = n_groups * scfg.TRAIN.IMS_PER_BATCH
    entries, images = random_train_entries(np.random.RandomState(seed), n_images,
                                           max_side=scfg.TRAIN.MAX_SIZE,
                                           num_classes=scfg.MODEL.NUM_CLASSES)
    built = RetinaNetMinibatchBuilder(scfg, tcfg, device_normalize=True).build(
        entries, images, seed=seed)
    batch = batch_to_torch(built.as_pytree(), dev)
    step = make_train_step(scfg, student, teacher, n_groups=n_groups, teacher_cfg=tcfg)
    return SeededTrainStep(scfg, tcfg, student, teacher, step, TrainState.create(student),
                           batch, n_images)


@dataclass
class SeededRCNNTrainStep:
    cfg: Any
    model: torch.nn.Module
    step: RCNNTrainStep
    state: TrainState
    batch: Dict[str, Any]  # tensors on the device
    n_images: int


def seeded_rcnn_train_step(cfg_yaml: str, seed: int = 0, n_groups: int = 4, device="cuda",
                           opts: Sequence[str] = ()) -> SeededRCNNTrainStep:
    """The R-CNN of ``cfg_yaml`` with random float32 weights from ``seed``
    and its four output layers rescaled (profile_infer.spread_rcnn_outputs,
    so that the RPN spreads its scores and fills its slots), its training
    step and zero momentum, and one batch of n_groups x TRAIN.IMS_PER_BATCH
    seeded images with 1-8 gt boxes and a polygon each, built by
    RCNNMinibatchBuilder.build into one uint8 canvas per image, on
    ``device``. The sampler draws from a generator seeded with ``seed``."""
    dev = get_device(device)
    cfg = load_cfg(cfg_yaml, BENCH_OPTS + ["NUM_GPUS", str(n_groups)] + list(opts))
    model = create_model(cfg, dev, torch.Generator(device=dev).manual_seed(seed))
    n_images = n_groups * cfg.TRAIN.IMS_PER_BATCH
    entries, images = random_train_entries(
        np.random.RandomState(seed), n_images, max_side=cfg.TRAIN.MAX_SIZE,
        num_classes=cfg.MODEL.NUM_CLASSES, polygons=cfg.MODEL.MASK_ON)
    built = RCNNMinibatchBuilder(cfg, device_normalize=True).build(
        entries, seed=seed, images_bgr=images)
    batch = batch_to_torch(built, dev)
    with torch.no_grad():
        spread_rcnn_outputs(cfg, model, batch["data_u8"], batch["im_hw"], batch["content_hw"])
    step = make_rcnn_train_step(cfg, model, n_groups=n_groups,
                                generator=torch.Generator(device=dev).manual_seed(seed))
    return SeededRCNNTrainStep(cfg, model, step, TrainState.create(model), batch, n_images)


RCNN_STAGES = ("normalize", "backbone_fpn", "rpn_head_losses", "proposals", "sample",
               "roi_align_box_head_losses", "mask_branch", "backward", "sgd")


def rcnn_stage_ms(run: SeededRCNNTrainStep, lr: float) -> Dict[str, float]:
    """Device ms of each stage of one R-CNN step, from CUDA events."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(RCNN_STAGES) + 1)]
    step, batch = run.step, run.batch
    ev[0].record()
    data = step.inputs(batch)
    ev[1].record()
    nchw = step.backbone(data)
    ev[2].record()
    logits, deltas, total, _ = step.rpn(nchw, batch)
    ev[3].record()
    boxes, valid = step.proposals(logits, deltas, batch)
    ev[4].record()
    sampled = step.sample(boxes, valid, batch)
    ev[5].record()
    feats = run.model.roi_features({l: f.permute(0, 2, 3, 1) for l, f in nchw.items()})
    total = total + step.box_branch(feats, sampled)[0]
    ev[6].record()
    if run.cfg.MODEL.MASK_ON:
        total = total + step.mask_branch(feats, sampled, batch)
    ev[7].record()
    grads = step.grads(total)
    ev[8].record()
    step.apply(run.state, grads, lr)
    ev[9].record()
    torch.cuda.synchronize()
    return {k: ev[i].elapsed_time(ev[i + 1]) for i, k in enumerate(RCNN_STAGES)}


def stage_ms(run: SeededTrainStep, lr: float) -> Dict[str, float]:
    """Device ms of each stage of one step, from CUDA events."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
    step, batch = run.step, run.batch
    ev[0].record()
    s_data, t_data = step.inputs(batch)
    ev[1].record()
    probs = step.teacher_probs(t_data)
    ev[2].record()
    out = step.forward(s_data)
    ev[3].record()
    total, _ = step.losses(out, probs, batch)
    ev[4].record()
    grads = step.grads(total)
    ev[5].record()
    step.apply(run.state, grads, lr)
    ev[6].record()
    torch.cuda.synchronize()
    names = ("normalize", "teacher_forward", "student_forward", "losses_forward",
             "backward", "sgd")
    return {k: ev[i].elapsed_time(ev[i + 1]) for i, k in enumerate(names)}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--groups", type=int, default=4)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None)
    p.add_argument("--cfg", default=None, help="an R-CNN YAML: profile its training step "
                   "instead of the joint SAD step")
    args = p.parse_args(argv)

    set_tf32(False)
    gpu = nvidia_smi_line()
    rcnn = args.cfg is not None
    if rcnn:
        if not is_rcnn(load_cfg(args.cfg)):
            raise ValueError(f"--cfg {args.cfg}: not a generalized_rcnn config; the joint SAD "
                             "step is profiled without --cfg")
        run = seeded_rcnn_train_step(args.cfg, seed=args.seed, n_groups=args.groups,
                                     device="cuda")
    else:
        run = seeded_train_step(seed=args.seed, n_groups=args.groups, device="cuda")
    losses = []
    torch.cuda.reset_peak_memory_stats()
    walls = wall_seconds(lambda: losses.append(run.step(run.state, run.batch, BENCH_LR)["loss"]),
                         args.iters, args.warmup)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)):
        raise FloatingPointError(f"non-finite loss in the timed steps: {losses}")

    stages = [(rcnn_stage_ms if rcnn else stage_ms)(run, BENCH_LR) for _ in range(args.iters)]

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n_prof = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            run.step(run.state, run.batch, BENCH_LR)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    by_cat: Dict[str, float] = {}
    for e in kernels:
        cat = _category(e.key)
        by_cat[cat] = by_cat.get(cat, 0.0) + e.self_device_time_total / 1e3 / n_prof
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]

    med = statistics.median(walls)
    result = {
        "gpu": gpu,
        "batch": run.n_images,
        "groups": args.groups,
        "canvas": list(run.batch["data_u8"].shape[1:3]),
        "cfg": args.cfg,
        "compute_dtype": (run.cfg if rcnn else run.student_cfg).COMPUTE_DTYPE,
        "imgs_per_s": run.n_images / med,
        "step_ms": {k: v * 1e3 for k, v in _quartiles(walls).items() if k != "n"},
        "iters": args.iters,
        "loss_first_last": [losses[0], losses[-1]],
        "peak_memory_gib": peak / 2**30,
        "stage_ms": {k: statistics.median(s[k] for s in stages) for k in stages[0]},
        "profiled_steps": n_prof,
        "kernel_ms_per_step": busy_ms / n_prof,
        "kernel_ms_by_category_per_step": by_cat,
        "profiled_wall_ms_per_step": prof_wall_ms / n_prof,
        "device_idle_share_profiled": 1.0 - busy_ms / prof_wall_ms,
        "device_idle_share_vs_unprofiled_wall": 1.0 - busy_ms / n_prof / (med * 1e3),
        "top_kernels_ms_per_step": [[e.key[:90], e.self_device_time_total / 1e3 / n_prof,
                                     e.count // n_prof] for e in top],
    }
    print(json.dumps(result, indent=1))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
