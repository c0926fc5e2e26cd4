"""Data parallelism held against one process: the rank functions that
chip_smoke.py and the CPU tests hand to ``parallel.launch.spawn``
(``rank_steps``: the joint SAD step or a Faster / Mask R-CNN step on the
rank's share of one seeded batch; ``rank_cli``: train_net or test_net), the
comparison of W ranks with one process (``run_compare``, ``compare``), and
the cuDNN witness (``cudnn_witness``), which is the command line:

    python -m sad_tpu_torch.tools.profile_ddp [--groups 4] [--steps 2] \
        [--seed 0] [--out witness.json]

The models, weights and batch are tools/profile_train's seeded ones at full
width (``seeded_train_step``, ``seeded_rcnn_train_step``), at float32 with
TF32 off. A rank builds the whole batch and keeps its contiguous block
(``parallel.shard_batch``), holds G / W loss groups scaled by 1 / G, and
sums the gradients over the ranks. The one process is a world of 1 in a
process group of its own (NCCL on the card). With fewer cards than ranks
the ranks share cuda:0 over gloo (NCCL refuses two ranks on one card).

The witness runs in one process, with no process group: the joint step
over the whole batch and as two halves whose gradients it sums
(``local_steps``), with cuDNN and without, and prints, beside the card's
name and power limit, how far apart the parameters are after --steps
steps.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sad_tpu_torch.parallel.distributed import (
    all_reduce_metrics, current, grad_bytes, shard_batch,
)

def _counts() -> Dict[str, Any]:
    from sad_tpu_torch.ops import cls_loss_kernel, nms_kernel, roi_align_kernel

    return {"nms": nms_kernel.launches, "roi_align_fwd": roi_align_kernel.launches,
            "roi_align_bwd": roi_align_kernel.bwd_launches,
            "cls_fwd": cls_loss_kernel.fwd_launches, "cls_bwd": cls_loss_kernel.bwd_launches,
            "cls_fwd_by_rows": dict(cls_loss_kernel.fwd_by_rows),
            "cls_bwd_by_rows": dict(cls_loss_kernel.bwd_by_rows)}


def reset_counts() -> None:
    from sad_tpu_torch.ops import cls_loss_kernel, nms_kernel, roi_align_kernel

    nms_kernel.launches = roi_align_kernel.launches = roi_align_kernel.bwd_launches = 0
    cls_loss_kernel.fwd_launches = cls_loss_kernel.bwd_launches = 0
    cls_loss_kernel.fwd_by_rows, cls_loss_kernel.bwd_by_rows = {}, {}


def shard_run(run, rank: int, world: int):
    """A seeded run (profile_train.SeededTrainStep or SeededRCNNTrainStep)
    built for the whole batch, cut to rank ``rank``'s share: its block of
    the batch, its G / W groups, the step's world (and for the R-CNN step its
    rank, whose rows of the sampler's draws it takes)."""
    if world == 1:
        return run
    run.batch = shard_batch(run.batch, rank, world)
    step = run.step
    if step.n_groups is not None:
        step.n_groups //= world
    step.world = world
    if hasattr(step, "rank"):
        step.rank = rank
    run.n_images //= world
    return run


def load_run(path: str):
    """A run object (SeededTrainStep or SeededRCNNTrainStep, with its models,
    step, state and batch) that ``torch.save`` wrote: a ``build`` for
    ``rank_steps`` when the run is not made from a seed (a test's weights)."""
    return torch.load(path, weights_only=False)


def _model(run) -> torch.nn.Module:
    return run.model if hasattr(run, "model") else run.student


def _losses(run):
    step, batch = run.step, run.batch
    if hasattr(run, "model"):
        return step.losses(batch)
    s_data, t_data = step.inputs(batch)
    return step.losses(step.forward(s_data), step.teacher_probs(t_data), batch)


def _step(run, lr: float, events=None) -> Dict[str, torch.Tensor]:
    """One step through the step's stages; ``events`` (3 CUDA events) are
    recorded before the gradient all-reduce, after it and after the update."""
    step = run.step
    total, metrics = _losses(run)
    grads = step.grads(total)
    if events:
        events[0].record()
    grads = step.reduce(grads)
    if events:
        events[1].record()
    step.apply(run.state, grads, lr)
    if events:
        events[2].record()
    names = sorted(metrics)
    vec = all_reduce_metrics(torch.stack([metrics[k].detach().float() for k in names]), names)
    return dict(zip(names, vec.cpu().numpy().tolist()))


def _trees(run) -> Dict[str, Dict[str, np.ndarray]]:
    return {"params": {n: p.detach().cpu().numpy() for n, p in _model(run).named_parameters()},
            "velocity": {n: v.detach().cpu().numpy() for n, v in run.state.velocity.items()}}


def rank_steps(build: Callable, build_kwargs: Dict[str, Any], steps: int, lr: float,
               iters: int = 0) -> Dict[str, Any]:
    """On this rank: ``build(**build_kwargs)`` (a seeded run of the whole
    batch), cut to the rank's share, ``steps`` compared steps (after each:
    the metrics reduced over the ranks, the parameters and momentum, the
    R-CNN sampler's generator state; and this rank's kernel launches), then
    ``iters`` timed steps. TF32 is off: the comparison holds float32
    arithmetic. The compared steps run PyTorch's own convolutions (cuDNN
    off): cuDNN's float32 convolutions do not sum a batch of 4 as they sum
    one of 8 (``cudnn_witness``, PERF.md section 6); the timed steps run
    cuDNN's."""
    from sad_tpu_torch.device import set_tf32

    set_tf32(False)
    info = current()
    run = shard_run(build(**build_kwargs), info.rank, info.world)
    cuda = next(_model(run).parameters()).device.type == "cuda"
    gen = getattr(run.step, "generator", None)
    reset_counts()
    metrics, trees, gen_states = [], [], []
    torch.backends.cudnn.enabled = False
    try:
        for _ in range(steps):
            metrics.append(_step(run, lr))
            trees.append(_trees(run))
            if gen is not None:
                gen_states.append(gen.get_state().numpy())
    finally:
        torch.backends.cudnn.enabled = True
    out = {
        "rank": info.rank, "world": info.world, "backend": info.backend,
        "n_images": run.n_images, "n_groups": run.step.n_groups, "metrics": metrics,
        "launches": _counts(), "trees": trees, **trees[-1], "generator": gen_states,
        "grad_bytes": grad_bytes(run.step.params),
    }
    host_ms, reduce_ms, cpu_s = [], [], []
    for _ in range(iters):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)] if cuda else None
        if cuda:
            torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.process_time()
        _step(run, lr, ev)
        if cuda:
            torch.cuda.synchronize()
            reduce_ms.append(ev[0].elapsed_time(ev[1]))
        host_ms.append(1e3 * (time.perf_counter() - t0))
        cpu_s.append(time.process_time() - c0)
    out.update(step_ms=host_ms, reduce_ms=reduce_ms, cpu_s=cpu_s)
    return out


def rel_l2(got: np.ndarray, want: np.ndarray) -> float:
    """|got - want|_2 / |want|_2 (0 when both are zero)."""
    d = float(np.linalg.norm((got.astype(np.float64) - want).ravel()))
    n = float(np.linalg.norm(want.astype(np.float64).ravel()))
    return d / n if n else d


def _worst(d: Dict[str, float]) -> Tuple[float, str, List]:
    k = max(d, key=d.get)
    return d[k], k, sorted(d.items(), key=lambda kv: -kv[1])[:6]


def _tree_rel(one_tree, rank_tree) -> Dict[str, float]:
    return {k: rel_l2(rank_tree[k], ref) for k, ref in one_tree.items()}


def compare(one: Dict[str, Any], ranks: Sequence[Dict[str, Any]],
            held: Optional[int] = None) -> Dict[str, Any]:
    """The W-rank run against one process over its first ``held`` compared
    steps (all by default): the worst metric's relative difference, the
    worst parameter tensor's and the worst momentum tensor's relative L2
    difference after step ``held`` (rank 0's); the same readings over the
    later steps (``later_*``, None without any); and over every step the
    tensors that are not bit-equal across the ranks and the steps after
    which a rank's sampler generator is not in the one process's state."""
    held = held or len(one["metrics"])
    m = [{k: abs(mw[k] - ref) / max(abs(ref), 1e-30) for k, ref in m1.items()}
         for m1, mw in zip(one["metrics"], ranks[0]["metrics"])]

    def metric_reading(lo, hi):
        return _worst({f"step {i} {k}": v for i in range(lo, hi) for k, v in m[i].items()})

    out = {}
    out["metric_rel"], out["metric_key"], out["metric_worst"] = metric_reading(0, held)
    for tree, key in (("params", "param"), ("velocity", "velocity")):
        d = _tree_rel(one["trees"][held - 1][tree], ranks[0]["trees"][held - 1][tree])
        out[f"{key}_rel_l2"], out[f"{key}_key"], out[f"{key}_worst"] = _worst(d)
    later = len(m) > held
    out["later_metric_rel"], out["later_metric_key"], _ = (
        metric_reading(held, len(m)) if later else (None, None, None))
    out["later_param_rel_l2"], out["later_param_key"], _ = (
        _worst(_tree_rel(one["params"], ranks[0]["params"])) if later else (None, None, None))
    out["unequal_across_ranks"] = [
        f"rank {r['rank']} step {i} {tree}:{k}" for r in ranks[1:]
        for i, (t, t0) in enumerate(zip(r["trees"], ranks[0]["trees"]))
        for tree in ("params", "velocity")
        for k, v in t[tree].items() if not np.array_equal(v, t0[tree][k])]
    out["generator_unequal"] = [
        f"rank {r['rank']} after step {i}" for r in ranks
        for i, (g, g1) in enumerate(zip(r["generator"], one["generator"]))
        if not np.array_equal(g, g1)]
    if any(len(r["generator"]) != len(one["generator"]) for r in ranks):
        out["generator_unequal"].append("a rank drew from no generator")
    return out


def rank_cli(tool: str, argv: Sequence[str], datasets: Sequence[Tuple[str, str, str, bool]] = (),
             deterministic: bool = False, nan_abort_ok: bool = False) -> Dict[str, Any]:
    """On this rank: ``sad_tpu_torch.tools.<tool>.main(argv)`` (train_net or
    test_net) after registering ``datasets`` = (name, image dir, json,
    pseudo-labeled) in the catalog (a rank starts with only the built-in
    entries), with TF32 off as the comparisons of chip_smoke.py run; with
    ``deterministic``, under deterministic algorithms. Returns
    this rank's kernel launches and, for train_net, each iteration's host ms
    and process CPU ms and the final parameters and momentum; with ``nan_abort_ok`` a NaN abort is returned as
    ``nan_abort`` (its message) instead of raised, so that every rank's
    abort can be checked."""
    import importlib

    from sad_tpu_torch.config import register_dataset
    from sad_tpu_torch.device import set_tf32

    set_tf32(False)
    for name, img_dir, js, pseudo in datasets:
        register_dataset(name, img_dir, js, is_pseudo_labeled=pseudo, allow_override=True)
    if deterministic:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        torch.use_deterministic_algorithms(True, warn_only=True)
    main = importlib.import_module(f"sad_tpu_torch.tools.{tool}").main
    reset_counts()
    try:
        result = main(list(argv))
    except FloatingPointError as e:
        if not nan_abort_ok:
            raise
        return {"rank": current().rank, "nan_abort": str(e)}
    out: Dict[str, Any] = {"rank": current().rank, "launches": _counts()}
    if tool == "train_net":
        out.update(start_iter=result.start_iter, iters=len(result.iter_seconds),
                   iter_ms=[1e3 * t for t in result.iter_seconds],
                   iter_process_cpu_ms=[1e3 * t for t in result.iter_process_cpu],
                   params={n: p.detach().cpu().numpy()
                           for n, p in result.model.named_parameters()},
                   velocity={n: v.detach().cpu().numpy()
                             for n, v in result.state.velocity.items()})
    return out


def card_layout(world: int) -> Tuple[str, List[int], str]:
    """(backend, local ranks, note) of ``world`` ranks on this host's cards:
    NCCL with a card a rank, else every rank on cuda:0 over gloo."""
    n = torch.cuda.device_count()
    if n >= world:
        return "nccl", list(range(world)), f"{world} ranks on {world} cards over NCCL"
    return "gloo", [0] * world, (f"{world} ranks sharing cuda:0 over gloo (broadcast and "
                                 "all_reduce of CUDA tensors)")


def run_compare(build: Callable, build_kwargs: Dict[str, Any], world: int, steps: int,
                lr: float, iters: int, timeout_s: float, device: str = "cuda",
                one_backend: Optional[str] = None, threads: Optional[int] = None,
                held: Optional[int] = None) -> Dict[str, Any]:
    """``rank_steps`` on one process (a world of 1 with ``one_backend``,
    NCCL on the card by default) and on ``world`` ranks, both within
    ``timeout_s``; their comparison (``compare``, over ``held`` steps)."""
    from sad_tpu_torch.parallel.launch import spawn

    deadline = time.monotonic() + timeout_s

    if device == "cuda":
        backend, local, note = card_layout(world)
    else:
        backend, local, note = "gloo", [0] * world, f"{world} ranks on the CPU over gloo"
    args = (build, build_kwargs, steps, lr, iters)
    (one,) = spawn(rank_steps, 1, args, device=device, backend=one_backend,
                   local_ranks=[0], timeout_s=timeout_s, threads=threads)
    ranks = spawn(rank_steps, world, args, device=device, backend=backend, local_ranks=local,
                  timeout_s=deadline - time.monotonic(), threads=threads)
    return {"one": one, "ranks": ranks, "layout": note, **compare(one, ranks, held)}


def summary(res: Dict[str, Any]) -> Dict[str, Any]:
    """The numbers of a run_compare worth printing."""
    def med(xs):
        return statistics.median(xs) if xs else None

    return {
        "layout": res["layout"], "metric_rel": res["metric_rel"],
        "param_rel_l2": res["param_rel_l2"], "param_key": res["param_key"],
        "velocity_rel_l2": res["velocity_rel_l2"], "velocity_key": res["velocity_key"],
        "param_worst": res["param_worst"], "velocity_worst": res["velocity_worst"],
        "metric_worst": res["metric_worst"],
        "later_metric_rel": res["later_metric_rel"], "later_metric_key": res["later_metric_key"],
        "later_param_rel_l2": res["later_param_rel_l2"],
        "later_param_key": res["later_param_key"],
        "ranks_bit_equal": not res["unequal_across_ranks"],
        "generator_equal": not res["generator_unequal"],
        "one_step_ms": med(res["one"]["step_ms"]),
        "rank_step_ms": [med(r["step_ms"]) for r in res["ranks"]],
        "allreduce_ms": [med(r["reduce_ms"]) for r in res["ranks"]],
        "allreduce_bytes": res["ranks"][0]["grad_bytes"],
        "rank_cpu_s_per_step": [med(r["cpu_s"]) for r in res["ranks"]],
        "one_cpu_s_per_step": med(res["one"]["cpu_s"]),
        "rank_images": [r["n_images"] for r in res["ranks"]],
        "rank_launches": [{k: v for k, v in r["launches"].items()} for r in res["ranks"]],
    }


def local_steps(run, steps: int, lr: float, shards: int) -> Dict[str, np.ndarray]:
    """``steps`` steps of ``run`` in this process, each computed as
    ``shards`` contiguous blocks of its batch (a block's losses over its
    G / shards groups scaled by 1 / G, the gradients summed in rank order,
    then one update): the arithmetic of ``shards`` ranks without a process
    group, collective or second process. The parameters after them."""
    step, full, groups = run.step, run.batch, run.step.n_groups
    step.n_groups, step.world = groups // shards, shards
    try:
        for _ in range(steps):
            grads = None
            for r in range(shards):
                run.batch = shard_batch(full, r, shards)
                g = step.grads(_losses(run)[0])
                grads = list(g) if grads is None else [a + b for a, b in zip(grads, g)]
            step.apply(run.state, grads, lr)
    finally:
        run.batch, step.n_groups, step.world = full, groups, 1
    return _trees(run)["params"]


# the runs: (name, batch shards, cuDNN on, cuDNN deterministic)
WITNESS_RUNS = (
    ("bs 8, cuDNN", 1, True, False),
    ("bs 8, cuDNN, again", 1, True, False),
    ("2 x bs 4, cuDNN", 2, True, False),
    ("bs 8, cuDNN deterministic", 1, True, True),
    ("2 x bs 4, cuDNN deterministic", 2, True, True),
    ("bs 8, no cuDNN", 1, False, False),
    ("2 x bs 4, no cuDNN", 2, False, False),
)
# the readings: a run against another
WITNESS_READINGS = (
    ("bs 8, cuDNN, again", "bs 8, cuDNN"),
    ("2 x bs 4, cuDNN", "bs 8, cuDNN"),
    ("2 x bs 4, cuDNN deterministic", "bs 8, cuDNN deterministic"),
    ("2 x bs 4, no cuDNN", "bs 8, no cuDNN"),
    ("bs 8, cuDNN", "bs 8, no cuDNN"),
    ("2 x bs 4, cuDNN", "bs 8, no cuDNN"),
)


def cudnn_witness(build: Callable, build_kwargs: Dict[str, Any], steps: int,
                  lr: float) -> Dict[str, Any]:
    """Without data parallelism: ``build(**build_kwargs)``'s step in this
    process from one initial state, ``steps`` steps over the whole batch
    and as two halves (``local_steps``), with cuDNN (its defaults, then
    deterministic) and without it, at float32 with TF32 off (WITNESS_RUNS).
    Each of WITNESS_READINGS, a run against another: the worst parameter
    tensor's relative L2 difference, its name and whether all are
    bit-equal."""
    from sad_tpu_torch.device import set_tf32

    set_tf32(False)
    run = build(**build_kwargs)
    named = dict(_model(run).named_parameters())
    init = {n: p.detach().clone() for n, p in named.items()}
    vel = {n: v.clone() for n, v in run.state.velocity.items()}
    prior = (torch.backends.cudnn.enabled, torch.backends.cudnn.deterministic)
    params, out = {}, {}
    try:
        for name, shards, on, det in WITNESS_RUNS:
            with torch.no_grad():
                for n, p in named.items():
                    p.copy_(init[n])
                for n, v in run.state.velocity.items():
                    v.copy_(vel[n])
            torch.backends.cudnn.enabled, torch.backends.cudnn.deterministic = on, det
            params[name] = local_steps(run, steps, lr, shards)
    finally:
        torch.backends.cudnn.enabled, torch.backends.cudnn.deterministic = prior
    for name, against in WITNESS_READINGS:
        worst, key, _ = _worst(_tree_rel(params[against], params[name]))
        out[f"{name} vs {against}"] = {
            "param_rel_l2": worst, "param_key": key,
            "bit_equal": all(np.array_equal(v, params[against][k])
                             for k, v in params[name].items())}
    return out


def main(argv=None):
    """The cuDNN witness (``cudnn_witness``) of the joint SAD step at full
    width on the card."""
    from sad_tpu_torch.device import nvidia_smi_line
    from sad_tpu_torch.tools import profile_train

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--groups", type=int, default=4)
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_ddp needs a CUDA card")
    kw = {"seed": args.seed, "n_groups": args.groups, "opts": ["COMPUTE_DTYPE", "float32"]}
    out = {"gpu": nvidia_smi_line(), "steps": args.steps,
           **cudnn_witness(profile_train.seeded_train_step, kw, args.steps,
                           profile_train.BENCH_LR)}
    print(json.dumps(out, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
