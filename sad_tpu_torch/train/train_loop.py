"""Training driver: the tools/train_net.py ``train_model`` equivalent (ref:
sad_tpu/train/train_loop.py; detectron/tools/train_net.py:104-266).

- teacher + student config pair; teacher weights loaded frozen,
- AUTO_RESUME checkpoint scan (:208-233): model_final.pkl means the run is
  complete and the call is a no-op; otherwise the newest model_iter{N}.pkl
  gives the parameters, the momentum and start_iter, and the loader
  fast-forwards its batch schedule, so a resumed run is bit-identical to an
  uninterrupted one; TRAIN.WEIGHTS initialises the student only at iter 0,
- the loop: LR schedule feed + momentum correction on LR change (cur_lr
  starts at lr(start_iter - 1), so a schedule step that lands exactly on
  start_iter still rescales the momentum), the joint SAD step or the R-CNN
  step, smoothed JSON stats, periodic checkpoints (SNAPSHOT_ITERS /
  NUM_GPUS), NaN-loss abort (:186-189),
- the host feed: the threaded or multi-process loader (DATA_LOADER.
  NUM_PROCESSES), with DISTILLATION.UNLABEL_DATASETS as a second stream that
  alternates with the labeled one by batch parity, behind DevicePrefetcher's
  pinned ``non_blocking`` copies.

Data parallelism (sad_tpu's mesh block, train_loop.py:199-245): launched
by ``torchrun --nnodes N --nproc_per_node W / N``, each rank trains on its
card (``parallel.rank_device``) on its block of each batch, built from the
shared schedule, on any world W that divides the batch's images, as
sad_tpu's loop trains on any device count. With W dividing NUM_GPUS on one
node a rank holds G / W whole loss groups (the steps' ``world``); when
groups span ranks, or over N > 1 nodes, the loop builds
``create_multislice_mesh()`` (one slice a node) and both steps run on it:
each group's normalizers are counted over the ranks, and over nodes the
gradients are summed in two levels. The gradients are summed over the
ranks, the packed metrics made global, so every rank reads the same loss
and a NaN aborts all of them at the same iteration; parameters and momentum
are broadcast from rank 0 after the resume scan and TRAIN.WEIGHTS; rank 0
alone writes stats.jsonl,
cfg.yaml, the snapshots, model_final.pkl, model_nan_abort.pkl and the
profiler's trace. Without torchrun there is one process on
``device.get_device``'s device and no collective.

TRAIN.CHECKPOINT_BACKEND 'orbax' (sad_tpu train_loop.py:90-120, 383-408)
snapshots through train/async_checkpoint.AsyncCheckpointer under
OUTPUT_DIR/checkpoints/<step>/ instead of model_iter{N}.pkl: the copies are
queued behind the step and a thread writes them while training goes on; the
newest 5 steps are kept, the last at MAX_ITER, and no model_final.pkl is
written. AUTO_RESUME restores the latest step on every rank; the step is the
resume iteration, and MAX_ITER's makes the call a no-op. The writer is waited
for and closed on the way out, error or not.

Nothing in the loop waits for the card but the metrics: each step's metrics
are packed on the device into one float32 vector, copied with
``non_blocking`` into pinned host memory behind an event, and read one
step late, after the next step has been launched. R-CNN batches are
normalised on the device (DATA_LOADER.DEVICE_NORMALIZE), as the RetinaNet
ones are.
"""

from __future__ import annotations

import json
import logging
import os
import statistics
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..config import Config
from ..config.config import cfg_to_yaml, get_output_dir
from ..data.dataset import combined_roidb_for_training
from ..data.loader import DevicePrefetcher, TrainingLoader
from ..models import create_model, trainable_mask
from ..parallel.distributed import (
    RCNN_TYPES, all_reduce_metrics, barrier, broadcast_module, broadcast_tensors,
    check_group_layout, init_distributed, rank_device,
)
from ..parallel.mesh import create_multislice_mesh
from ..utils.net_info import print_model_summary
from ..utils.stats import TrainingStats
from .checkpoint import (
    find_latest_checkpoint, load_checkpoint, load_reference_or_native, restore_checkpoint,
    save_checkpoint,
)
from .async_checkpoint import AsyncCheckpointer
from .lr_policy import get_lr_at_iter, lr_change_correction
from .optimizer import rescale_momentum
from .rcnn_train import make_rcnn_train_step
from .train_step import TrainState, make_train_step

logger = logging.getLogger(__name__)


@dataclass
class TrainResult:
    """What a ``train_model`` call leaves: the student (its parameters are
    the final ones), the momentum, the iterations run with the host time
    and the CPU time of each, and the host feed's records
    (``feed_summary``)."""

    model: nn.Module
    state: TrainState
    start_iter: int
    max_iter: int
    iter_seconds: List[float] = field(default_factory=list)
    iter_thread_cpu: List[float] = field(default_factory=list)  # the loop thread's CPU s
    iter_process_cpu: List[float] = field(default_factory=list)  # the process's CPU s
    feed: Optional[DevicePrefetcher] = None
    loader: Any = None
    # the first step's per-group normalizer counts, by name (the R-CNN step's
    # ``counts``, a mesh step's fg_num / PowSum), on the device
    first_counts: Dict[str, torch.Tensor] = field(default_factory=dict)
    # TRAIN.CHECKPOINT_BACKEND 'orbax': the closed checkpointer (its ``stats``)
    checkpointer: Optional[AsyncCheckpointer] = None

    def feed_summary(self, first: int = 0, last: Optional[int] = None) -> Dict[str, Any]:
        """The host feed over this run's iterations first..last-1 (counted
        from start_iter): host ms to build a batch of each stream (all
        batches built), ms from a batch's arrival at the prefetcher to the
        end of its copy onto the device, the share of gets that found no
        batch ready and the ms they blocked, the queue depth (the loader's
        built batches and the prefetcher's copied ones) at each get, and the
        stream of each batch."""
        if self.feed is None:
            return {}
        gets = self.feed.gets[first:last]
        built = list(self.loader.build_seconds)

        def med_ms(xs):
            return 1e3 * statistics.median(xs) if xs else None

        return {
            "workers": self.loader.num_workers,
            "batches_built": len(built),
            "build_ms_median": med_ms([t for _, t in built]),
            "build_ms_median_by_stream": {
                name: med_ms([t for n, t in built if n == name])
                for name in sorted({n for n, _ in built})},
            "copy_ms_median": med_ms(list(self.feed.copy_seconds)),
            "gets": len(gets),
            "waited_share": sum(g[0] for g in gets) / len(gets) if gets else None,
            "wait_ms_median": med_ms([g[1] for g in gets]),
            "wait_ms_total": 1e3 * sum(g[1] for g in gets),
            "queue_depth_median": statistics.median(g[2] for g in gets) if gets else None,
            "queue_depth_min": min(g[2] for g in gets) if gets else None,
            "served": list(self.loader.served[:len(self.feed.gets)][first:last]),
        }


def rcnn_step_seed(cfg, it: int) -> int:
    """The R-CNN sampler's seed at iteration ``it``: a function of
    (RNG_SEED + 7, it) alone, as sad_tpu's fold_in(PRNGKey(RNG_SEED + 7), it)
    is, so a resumed run draws what the uninterrupted one drew."""
    return ((cfg.RNG_SEED + 7) * 1_000_003 + it) % (2 ** 63)


def host_rss_mb() -> float:
    """Host resident set size in MB (/proc/self/statm), logged with each
    stats line: an hour-scale run that leaks host memory shows it here."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return round(pages * os.sysconf("SC_PAGE_SIZE") / 1e6, 1)
    except (OSError, ValueError, IndexError):
        return -1.0


def device_memory_stats(device) -> Dict[str, float]:
    """Peak device memory in MB (the reference's caffe2_gpu_memory_tracking
    analogue, train_net.py:106-108); nothing on the CPU."""
    if torch.device(device).type != "cuda":
        return {}
    return {"mem_peak_mb": round(torch.cuda.max_memory_allocated(device) / 1e6, 1)}


class _Profiler:
    """torch.profiler over PROFILE_DIR's iterations: the Chrome trace and a
    summary (kernel time, wall time, device idle share) in PROFILE_DIR."""

    def __init__(self, out_dir: str, device: torch.device):
        from torch.profiler import ProfilerActivity, profile

        self.out_dir = out_dir
        self.device = device
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(device)
        os.makedirs(out_dir, exist_ok=True)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.t0 = time.perf_counter()
        self.iters = 0

    def stop(self) -> Dict[str, Any]:
        from torch.autograd import DeviceType

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall_ms = (time.perf_counter() - self.t0) * 1e3
        self.prof.stop()
        self.prof.export_chrome_trace(os.path.join(self.out_dir, "trace.json"))
        kernel_ms = sum(e.self_device_time_total for e in self.prof.key_averages()
                        if e.device_type == DeviceType.CUDA) / 1e3
        summary = {"iters": self.iters, "wall_ms": wall_ms, "kernel_ms": kernel_ms,
                   "device_idle_share": (1.0 - kernel_ms / wall_ms
                                         if self.device.type == "cuda" else None)}
        with open(os.path.join(self.out_dir, "profile_summary.json"), "w") as f:
            json.dump(summary, f, indent=1)
        return summary


def _make_loader(cfg, teacher_cfg, distill: bool, is_rcnn: bool, start_iter: int,
                 rank: int = 0, world: int = 1):
    roidb = combined_roidb_for_training(
        cfg.TRAIN.DATASETS, cfg.TRAIN.USE_FLIPPED,
        gt_min_area=cfg.TRAIN.GT_MIN_AREA,
        require_keypoints=cfg.MODEL.KEYPOINTS_ON,
    )
    if is_rcnn and cfg.TRAIN.PROPOSAL_FILES and not cfg.MODEL.FASTER_RCNN:
        # Fast R-CNN: each dataset's precomputed proposals, one file a
        # dataset (sad_tpu/train/train_loop.py:145-166; ref roidb.py
        # combined_roidb_for_training zips TRAIN.DATASETS with the files)
        from ..eval.rpn_generator import add_proposals_to_roidb

        for dname, pf in zip(cfg.TRAIN.DATASETS, cfg.TRAIN.PROPOSAL_FILES):
            add_proposals_to_roidb([e for e in roidb if e.get("dataset_name") == dname], pf,
                                   crowd_thresh=cfg.TRAIN.CROWD_FILTER_THRESH)
    unlabeled = None
    if distill and cfg.DISTILLATION.UNLABEL_DISTILLATION:
        # the pseudo-labeled sets: images without a pseudo box are dropped
        # by the training filter (roidb.py filter_for_training)
        unlabeled = combined_roidb_for_training(
            cfg.DISTILLATION.UNLABEL_DATASETS, cfg.TRAIN.USE_FLIPPED,
            gt_min_area=cfg.TRAIN.GT_MIN_AREA,
        )
    builder = None
    if is_rcnn:
        from ..data.rpn_minibatch import RCNNMinibatchBuilder

        builder = RCNNMinibatchBuilder(cfg, device_normalize=cfg.DATA_LOADER.DEVICE_NORMALIZE)
    if cfg.DATA_LOADER.NUM_PROCESSES:
        from ..data.mp_loader import MultiprocessTrainingLoader

        n_procs = cfg.DATA_LOADER.NUM_PROCESSES
        loader = MultiprocessTrainingLoader(
            cfg, roidb, teacher_cfg if distill else None, unlabeled, builder=builder,
            num_workers=None if n_procs < 0 else n_procs, skip_batches=start_iter,
            rank=rank, world=world)
    else:
        loader = TrainingLoader(
            cfg, roidb, teacher_cfg if distill else None, unlabeled, builder=builder,
            num_threads=cfg.DATA_LOADER.NUM_THREADS, skip_batches=start_iter,
            rank=rank, world=world)
    try:
        return loader.start(prefill=True)
    except BaseException:
        loader.shutdown()
        raise


def train_model(
    cfg: Config,
    teacher_cfg: Optional[Config] = None,
    max_iters: Optional[int] = None,
    output_dir: Optional[str] = None,
    device="cuda",
) -> TrainResult:
    """Run the training loop on ``device`` (the card unless the caller asks
    for the CPU; under torchrun this rank's card, or the CPU for 'cpu');
    returns the final student, momentum and the loop's measurements."""
    dist_info = init_distributed(device=device)
    check_group_layout(cfg, dist_info.world)
    main = dist_info.is_main
    distill = cfg.DISTILLATION.DISTILLATION_ON and teacher_cfg is not None
    is_rcnn = cfg.MODEL.TYPE in RCNN_TYPES
    output_dir = output_dir or get_output_dir(cfg, training=True)
    os.makedirs(output_dir, exist_ok=True)
    max_iters = max_iters or cfg.SOLVER.MAX_ITER
    dev = rank_device(device)
    # embed the active config in checkpoints (ref: net.py:149-182 stores
    # 'cfg' yaml in every weights pkl) and in the run dir
    cfg_yaml = cfg_to_yaml(cfg)
    if main:
        with open(os.path.join(output_dir, "cfg.yaml"), "w") as f:
            f.write(cfg_yaml)

    if cfg.TRAIN.CHECKPOINT_BACKEND not in ("pickle", "orbax"):
        raise ValueError(
            "TRAIN.CHECKPOINT_BACKEND must be 'pickle' or 'orbax'; got "
            f"{cfg.TRAIN.CHECKPOINT_BACKEND!r}")
    ckptr = None
    if cfg.TRAIN.CHECKPOINT_BACKEND == "orbax":
        ckptr = AsyncCheckpointer(os.path.join(output_dir, "checkpoints"))
    if is_rcnn and cfg.TRAIN.PROPOSAL_FILES and not cfg.MODEL.FASTER_RCNN and (
            len(cfg.TRAIN.PROPOSAL_FILES) != len(cfg.TRAIN.DATASETS)):
        raise ValueError(
            "TRAIN.PROPOSAL_FILES must pair 1:1 with TRAIN.DATASETS (got "
            f"{len(cfg.TRAIN.PROPOSAL_FILES)} files for {len(cfg.TRAIN.DATASETS)} datasets; "
            "ref roidb.py combined_roidb_for_training asserts the same)")

    # ----- models
    student = create_model(cfg, dev, torch.Generator(device=dev).manual_seed(cfg.RNG_SEED))
    teacher = None
    if distill:
        teacher = create_model(teacher_cfg, dev,
                               torch.Generator(device=dev).manual_seed(cfg.RNG_SEED + 1))
        if teacher_cfg.TRAIN.WEIGHTS:
            load_reference_or_native(teacher_cfg.TRAIN.WEIGHTS, teacher, teacher_cfg)
            logger.info("Loaded teacher weights: %s", teacher_cfg.TRAIN.WEIGHTS)
        teacher.requires_grad_(False)
    state = TrainState.create(student)

    # ----- resume / init weights (train_net.py:208-233, net.py:50)
    start_iter = 0
    if cfg.TRAIN.AUTO_RESUME and ckptr is not None:
        step_ = ckptr.latest_step()
        if step_ is not None:
            restore_checkpoint(ckptr.restore(step_), student, state.velocity)
            # the step is the resume iteration; MAX_ITER means a finished run
            start_iter = step_
            logger.info("Auto-resumed from %s at iter %d", ckptr.step_dir(step_), start_iter)
    elif cfg.TRAIN.AUTO_RESUME:
        ckpt_path, start_iter_ = find_latest_checkpoint(output_dir)
        if ckpt_path:
            ck = load_checkpoint(ckpt_path)
            restore_checkpoint(ck, student, state.velocity)
            # model_final.pkl => training already complete (train_net.py:213)
            start_iter = ck.get("iter", max(start_iter_, 0))
            if start_iter_ < 0:
                start_iter = max(start_iter, max_iters)
            logger.info("Auto-resumed from %s at iter %d", ckpt_path, start_iter)
    if start_iter == 0 and cfg.TRAIN.WEIGHTS:
        load_reference_or_native(cfg.TRAIN.WEIGHTS, student, cfg)
        logger.info("Initialized student from %s", cfg.TRAIN.WEIGHTS)
    if dist_info.world > 1:
        # every rank has scanned the directory before rank 0 writes to it;
        # then rank 0's parameters and momentum on all (net.py:185-208)
        barrier()
        broadcast_module(student)
        broadcast_tensors(state.velocity.values())
    result = TrainResult(student, state, start_iter, max_iters, checkpointer=ckptr)
    if start_iter >= max_iters:
        logger.info("Training already complete at iter %d: nothing to do", start_iter)
        return result

    # ----- step: the loss scaled by 1 / NUM_GPUS; whole groups a rank on one
    # node, else sad_tpu's multislice mesh (one slice a node)
    mesh = None
    if dist_info.world > 1 and (cfg.NUM_GPUS % dist_info.world or dist_info.nodes > 1):
        mesh = create_multislice_mesh()
        logger.info("loss groups and gradients over %s (%d ranks, %d slices)", mesh,
                    dist_info.world, mesh.n_slices)
    if mesh is not None:
        step = (make_rcnn_train_step(cfg, student, mesh=mesh) if is_rcnn else
                make_train_step(cfg, student, teacher, teacher_cfg=teacher_cfg, mesh=mesh))
    elif is_rcnn:
        step = make_rcnn_train_step(cfg, student, n_groups=cfg.NUM_GPUS // dist_info.world,
                                    rank=dist_info.rank, world=dist_info.world)
    else:
        step = make_train_step(cfg, student, teacher, n_groups=cfg.NUM_GPUS // dist_info.world,
                               teacher_cfg=teacher_cfg, world=dist_info.world)
    trainable = trainable_mask(student, cfg.TRAIN.FREEZE_AT, cfg.TRAIN.FREEZE_CONV_BODY)
    if main:
        logger.info("Model parameter summary (net.py:224 print_net analogue):")
        print_model_summary(student.state_dict(), max_rows=12)

    stats_path = os.path.join(output_dir, "stats.jsonl")
    if main and start_iter == 0 and os.path.exists(stats_path):
        # fresh run into a reused dir: truncate, don't concatenate runs
        # (a resume appends, keeping one continuous series)
        os.remove(stats_path)
    stats = TrainingStats(max_iters, log_file=stats_path if main else None)
    snapshot_period = max(1, cfg.TRAIN.SNAPSHOT_ITERS // max(cfg.NUM_GPUS, 1))
    cur_lr = get_lr_at_iter(cfg.SOLVER, max(start_iter - 1, 0))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    metric_names: List[str] = []

    def _pack(m: Dict[str, torch.Tensor]):
        """One float32 vector of the metrics, reduced over the ranks, on its
        way to pinned host memory behind an event (CUDA), or the vector
        itself (CPU)."""
        if not metric_names:
            metric_names.extend(sorted(m))
        vec = torch.stack([m[k].float() for k in metric_names])
        if not step.global_metrics:
            vec = all_reduce_metrics(vec, metric_names)
        if dev.type != "cuda":
            return vec, None
        host = torch.empty(vec.shape, dtype=torch.float32, pin_memory=True)
        host.copy_(vec, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    loader = _make_loader(cfg, teacher_cfg, distill, is_rcnn, start_iter, dist_info.rank,
                          dist_info.world)
    feed = DevicePrefetcher(loader, dev)

    def _consume_metrics(p_it, p_lr, packed):
        host, event = packed
        if event is not None:
            event.synchronize()
        vals = host.numpy()
        metrics = dict(zip(metric_names, (float(v) for v in vals)))
        stats.iter_toc()
        stats.update_iter_stats(p_it, metrics)
        will_log = main and (p_it % stats.log_period == 0 or p_it == stats.max_iter - 1)
        if main:
            stats.log_iter_stats(
                p_it, p_lr,
                extra=({"queue": feed.queue_depth(), **device_memory_stats(dev),
                        "host_rss_mb": host_rss_mb()} if will_log else None),
            )
        # the loss is the ranks' sum: every rank aborts at this iteration
        if not np.isfinite(metrics["loss"]):
            if main:
                save_checkpoint(os.path.join(output_dir, "model_nan_abort.pkl"), student,
                                state.velocity, p_it, cfg_yaml=cfg_yaml)
            raise FloatingPointError(
                f"Loss is {metrics['loss']} at iter {p_it}; aborting (train_net.py:186-189)")

    profiler: Optional[_Profiler] = None
    pending = None
    # host clock, the loop thread's CPU time and the process's (all its
    # threads: the prefetcher's copies, the loader's collector) at each
    # iteration's start
    marks: List[tuple] = []
    try:
        for it in range(start_iter, max_iters):
            marks.append((time.perf_counter(), time.thread_time(), time.process_time()))
            if main and cfg.PROFILE_DIR and it == cfg.PROFILE_START_ITER:
                profiler = _Profiler(cfg.PROFILE_DIR, dev)
                logger.info("profiler trace started -> %s", cfg.PROFILE_DIR)
            stats.iter_tic()
            new_lr = get_lr_at_iter(cfg.SOLVER, it)
            if new_lr != cur_lr:
                corr = lr_change_correction(cfg.SOLVER, cur_lr, new_lr)
                if corr is not None:
                    rescale_momentum(state.velocity, corr, trainable)
                    logger.info("Scaled momentum by %.6f at iter %d", corr, it)
                cur_lr = new_lr

            batch = feed.get_next_batch()
            if is_rcnn:
                # a fresh generator each iteration (see rcnn_step_seed)
                step.generator = torch.Generator(device=dev).manual_seed(rcnn_step_seed(cfg, it))
            metrics = step(state, batch, cur_lr)
            del batch
            if it == start_iter:
                found = getattr(step, "counts", None) or getattr(step, "normalizers", {})
                result.first_counts = {k: v.detach().clone() for k, v in found.items()}
            packed = _pack(metrics)
            # Lagged stats: reading step it's metrics would wait for the
            # card; read step it-1's while step it runs
            if pending is not None:
                _consume_metrics(*pending)
            pending = (it, cur_lr, packed)

            if profiler is not None:
                profiler.iters += 1
                if it == cfg.PROFILE_START_ITER + cfg.PROFILE_NUM_ITERS:
                    logger.info("profiler trace stopped: %s", profiler.stop())
                    profiler = None

            if main and (it + 1) % snapshot_period == 0 and it + 1 < max_iters:
                if ckptr is not None:  # the write overlaps the next steps
                    ckptr.save(it + 1, student, state.velocity, cfg_yaml=cfg_yaml)
                else:
                    save_checkpoint(os.path.join(output_dir, f"model_iter{it}.pkl"), student,
                                    state.velocity, it + 1, cfg_yaml=cfg_yaml)
        if pending is not None:
            _consume_metrics(*pending)
        marks.append((time.perf_counter(), time.thread_time(), time.process_time()))
        if main and ckptr is not None:  # written before the ranks go on
            ckptr.save(max_iters, student, state.velocity, cfg_yaml=cfg_yaml)
            ckptr.wait()
        elif main:
            save_checkpoint(os.path.join(output_dir, "model_final.pkl"), student,
                            state.velocity, max_iters, cfg_yaml=cfg_yaml)
        barrier()
    finally:
        if profiler is not None:
            profiler.prof.stop()
        feed.shutdown()
        if ckptr is not None:
            ckptr.close()
    steps = np.diff(np.asarray(marks, np.float64), axis=0) if len(marks) > 1 else np.zeros((0, 3))
    result.iter_seconds, result.iter_thread_cpu, result.iter_process_cpu = (
        [float(x) for x in steps[:, k]] for k in range(3))
    result.feed, result.loader = feed, loader
    logger.info("host feed: %s",
                {k: v for k, v in result.feed_summary().items() if k != "served"})
    return result
