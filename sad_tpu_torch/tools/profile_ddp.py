"""Data parallelism held against one process: the rank functions that
chip_smoke.py and the CPU tests hand to ``parallel.launch.spawn``
(``rank_steps``: the joint SAD step or an R-CNN step on the rank's share of
one seeded batch, whole loss groups a rank or, on sad_tpu's multislice mesh,
groups that span ranks and nodes; ``rank_cli``: train_net or test_net), the
comparison of W ranks with one process (``run_compare``, ``compare``; with
``nodes=N`` the ranks' environment is torchrun's over N nodes), and the
cuDNN witness (``cudnn_witness``), which is the command line:

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
import contextlib
import json
import os
import shutil
import statistics
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sad_tpu_torch.parallel import distributed
from sad_tpu_torch.parallel.distributed import (
    all_reduce_grads, all_reduce_metrics, barrier, current, grad_bytes, reduction_transport,
    shard_batch, shard_rows,
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
    _shard_uniforms(run, rank, world)
    step = run.step
    if step.n_groups is not None:
        step.n_groups //= world
    step.world = world
    if hasattr(step, "rank"):
        step.rank = rank
    run.n_images //= world
    return run


def _shard_uniforms(run, index: int, parts: int) -> None:
    """A run's uniforms (``_losses``), if any, cut to block ``index`` of
    ``parts`` of their image rows."""
    if getattr(run, "uniforms", None):
        run.uniforms = [tuple(shard_rows(u, index, parts) for u in pair)
                        for pair in run.uniforms]


def mesh_run(run, mesh):
    """A seeded run of the whole batch cut to this rank's piece on ``mesh``
    (n_model = 1): its data shard's images (``shard_batch_tree``), its step
    a mesh step of the batch's G groups (for the R-CNN step with the run's
    sampler generator)."""
    if not hasattr(run, "model"):
        from sad_tpu_torch.tools.profile_spatial import mesh_piece

        return mesh_piece(run, mesh)
    from sad_tpu_torch.parallel.mesh import shard_batch_tree
    from sad_tpu_torch.train.rcnn_train import make_rcnn_train_step

    step = run.step
    run.batch = shard_batch_tree(run.batch, mesh)
    _shard_uniforms(run, mesh.data_index, mesh.n_data)
    run.step = make_rcnn_train_step(run.cfg, run.model, n_groups=step.n_groups,
                                    generator=step.generator, mesh=mesh)
    run.n_images //= mesh.n_data
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
        # a run may carry the sampler's uniforms of its first steps (the
        # rank's rows of the whole batch's, one pair a step)
        given = getattr(run, "uniforms", None)
        return step.losses(batch, given.pop(0) if given else None)
    s_data, t_data = step.inputs(batch)
    return step.losses(step.forward(s_data), step.teacher_probs(t_data), batch)


def _step(run, lr: float, events=None, flat: bool = False) -> Dict[str, torch.Tensor]:
    """One step through the step's stages; ``events`` (3 CUDA events) are
    recorded before the gradient all-reduce, after it and after the update.
    With ``flat`` the gradients are also summed by one flat all-reduce over
    the world first, for ``distributed.stats`` to time beside the step's own
    sum (whose result the step applies)."""
    step = run.step
    total, metrics = _losses(run)
    grads = step.grads(total)
    if flat:
        all_reduce_grads(grads)
    if events:
        events[0].record()
    grads = step.reduce(grads)
    if events:
        events[1].record()
    step.apply(run.state, grads, lr)
    if events:
        events[2].record()
    names = sorted(metrics)
    vec = torch.stack([metrics[k].detach().float() for k in names])
    if not run.step.global_metrics:
        vec = all_reduce_metrics(vec, names)
    return dict(zip(names, vec.cpu().numpy().tolist()))


def _trees(run) -> Dict[str, Dict[str, np.ndarray]]:
    """Copies of the parameters and momenta (a CPU tensor's numpy view would
    follow later steps)."""
    return {"params": {n: p.detach().cpu().numpy().copy()
                       for n, p in _model(run).named_parameters()},
            "velocity": {n: v.detach().cpu().numpy().copy()
                         for n, v in run.state.velocity.items()}}


def rank_steps(build: Callable, build_kwargs: Dict[str, Any], steps: int, lr: float,
               iters: int = 0, mesh: bool = False) -> Dict[str, Any]:
    """On this rank: ``build(**build_kwargs)`` (a seeded run of the whole
    batch), cut to the rank's share (with ``mesh``, its piece on
    ``create_multislice_mesh()``: loss groups may span ranks, and over nodes
    the gradients are summed in two levels), ``steps`` compared steps (after
    each: the metrics reduced over the ranks, the parameters and momentum,
    the R-CNN sampler's generator state and the step's global per-group
    counts; and this rank's kernel launches and peak memory), then ``iters``
    timed steps and, with ``mesh``, as many instrumented ones
    (``distributed.stats`` timed: each level of the gradient sum, a flat
    all-reduce of the same gradients beside a two-level one, the count
    all-reduce). TF32 is off: the
    comparison holds float32 arithmetic. The compared steps run PyTorch's
    own convolutions (cuDNN off): cuDNN's float32 convolutions do not sum a
    batch of 4 as they sum one of 8 (``cudnn_witness``, PERF.md section 6);
    the timed steps run cuDNN's."""
    from sad_tpu_torch.device import set_tf32
    from sad_tpu_torch.parallel.mesh import create_multislice_mesh

    set_tf32(False)
    info = current()
    layout = create_multislice_mesh() if mesh else None
    run = (mesh_run(build(**build_kwargs), layout) if mesh else
           shard_run(build(**build_kwargs), info.rank, info.world))
    cuda = next(_model(run).parameters()).device.type == "cuda"
    gen = getattr(run.step, "generator", None)
    reset_counts()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    metrics, trees, gen_states, counts = [], [], [], []
    torch.backends.cudnn.enabled = False
    try:
        for _ in range(steps):
            metrics.append(_step(run, lr))
            trees.append(_trees(run))
            if gen is not None:
                gen_states.append(gen.get_state().numpy())
            found = getattr(run.step, "counts", None) or getattr(run.step, "normalizers", {})
            counts.append({k: v.cpu().numpy() for k, v in found.items()})
    finally:
        torch.backends.cudnn.enabled = True
    out = {
        "rank": info.rank, "world": info.world, "backend": info.backend,
        "node": info.node, "local_world": info.local_world,
        "reduction_transport": reduction_transport(layout), "n_images": run.n_images,
        "n_groups": run.step.n_groups, "metrics": metrics, "counts": counts,
        "launches": _counts(), "trees": trees, **trees[-1], "generator": gen_states,
        "grad_bytes": grad_bytes(run.step.params),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda else None,
    }
    host_ms, reduce_ms, cpu_s, levels = [], [], [], []
    two_level = out["reduction_transport"] != "flat"
    for timed in [False] * iters + [True] * (iters if mesh else 0):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)] if cuda else None
        distributed.reset_stats(timed)
        if cuda:
            torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.process_time()
        _step(run, lr, ev, flat=timed and two_level)
        if cuda:
            torch.cuda.synchronize()
        if timed:
            levels.append(dict(distributed.stats))
            continue
        if cuda:
            reduce_ms.append(ev[0].elapsed_time(ev[1]))
        host_ms.append(1e3 * (time.perf_counter() - t0))
        cpu_s.append(time.process_time() - c0)
    distributed.reset_stats()
    out.update(step_ms=host_ms, reduce_ms=reduce_ms, cpu_s=cpu_s, reduction=levels)
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


@contextlib.contextmanager
def kernel_inputs(into: Dict[str, Any]):
    """The NMS and RoIAlign wrappers (``nms_kernel.nms_cuda``,
    ``roi_align_kernel.roi_align_fwd_cuda`` / ``roi_align_bwd_cuda``, which
    their callers read at each call) recording into ``into``, as CPU
    copies, the arguments of their first call at each shape: 'nms',
    'roi_fwd_<res>', 'roi_bwd_<res>'; each call then runs as it would."""
    from sad_tpu_torch.ops import nms_kernel
    from sad_tpu_torch.ops import roi_align_kernel as k

    saved = nms_kernel.nms_cuda, k.roi_align_fwd_cuda, k.roi_align_bwd_cuda

    def cpu(x):
        if torch.is_tensor(x):
            return x.detach().cpu().clone()
        return [cpu(y) for y in x] if isinstance(x, (list, tuple)) else x

    def nms(*args):
        into.setdefault("nms", cpu(args))
        return saved[0](*args)

    def fwd(*args):
        into.setdefault(f"roi_fwd_{args[5]}", cpu(args))
        return saved[1](*args)

    def bwd(*args):
        into.setdefault(f"roi_bwd_{args[0].shape[1]}", cpu(args))
        return saved[2](*args)

    nms_kernel.nms_cuda, k.roi_align_fwd_cuda, k.roi_align_bwd_cuda = nms, fwd, bwd
    try:
        yield into
    finally:
        nms_kernel.nms_cuda, k.roi_align_fwd_cuda, k.roi_align_bwd_cuda = saved


def rank_cli(tool: str, argv: Sequence[str], datasets: Sequence[Tuple[str, str, str, bool]] = (),
             deterministic: bool = False, nan_abort_ok: bool = False,
             capture: bool = False, cudnn: bool = True,
             seed_files: Sequence[Tuple[str, str]] = ()) -> Dict[str, Any]:
    """On this rank: ``sad_tpu_torch.tools.<tool>.main(argv)`` (train_net or
    test_net) after registering ``datasets`` = (name, image dir, json,
    pseudo-labeled) in the catalog (a rank starts with only the built-in
    entries), with TF32 off as the comparisons of chip_smoke.py run; with
    ``deterministic``, under deterministic algorithms; without ``cudnn``,
    on PyTorch's own convolutions (whose results for an image do not depend
    on the batch beside it). Returns
    this rank's kernel launches, the bytes it handed each level of the
    gradient sum and the count all-reduces (``distributed.stats``, untimed)
    and, for train_net, each iteration's host ms
    and process CPU ms, the first step's per-group counts and the final
    parameters and momentum; with ``nan_abort_ok`` a NaN abort is returned
    as ``nan_abort`` (its message) instead of raised, so that every rank's
    abort can be checked; with ``capture`` rank 0 also returns the inputs
    of the kernels' first calls (``kernel_inputs``). ``seed_files`` =
    (file, directory) pairs that rank 0 copies before the tool runs (a
    snapshot to resume from), every rank waiting for it."""
    import importlib

    from sad_tpu_torch.config import register_dataset
    from sad_tpu_torch.device import set_tf32

    set_tf32(False)
    for name, img_dir, js, pseudo in datasets:
        register_dataset(name, img_dir, js, is_pseudo_labeled=pseudo, allow_override=True)
    if deterministic:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.enabled = cudnn
    if seed_files:
        if current().rank == 0:
            for src, dst in seed_files:
                os.makedirs(dst, exist_ok=True)
                shutil.copy(src, dst)
        barrier()
    main = importlib.import_module(f"sad_tpu_torch.tools.{tool}").main
    reset_counts()
    distributed.reset_stats()
    captured: Dict[str, Any] = {}
    try:
        with kernel_inputs(captured) if capture and current().rank == 0 else \
                contextlib.nullcontext():
            result = main(list(argv))
    except FloatingPointError as e:
        if not nan_abort_ok:
            raise
        return {"rank": current().rank, "nan_abort": str(e)}
    out: Dict[str, Any] = {"rank": current().rank, "launches": _counts(),
                           "captured": captured,
                           "reduction_bytes": {k: v for k, v in distributed.stats.items()
                                               if k.endswith("_bytes")}}
    if tool == "train_net":
        out.update(start_iter=result.start_iter, iters=len(result.iter_seconds),
                   first_counts={k: v.cpu().numpy() for k, v in result.first_counts.items()},
                   iter_ms=[1e3 * t for t in result.iter_seconds],
                   iter_process_cpu_ms=[1e3 * t for t in result.iter_process_cpu],
                   params={n: p.detach().cpu().numpy()
                           for n, p in result.model.named_parameters()},
                   velocity={n: v.detach().cpu().numpy()
                             for n, v in result.state.velocity.items()})
    return out


def rank_layout(n_slices: Optional[int] = None) -> Dict[str, Any]:
    """On this rank: torchrun's variables as the rank's environment holds
    them, ``current()``'s place and ``create_multislice_mesh(n_slices)``'s
    (slice, local index, data index, transport)."""
    from sad_tpu_torch.parallel.mesh import create_multislice_mesh

    info = current()
    mesh = create_multislice_mesh(n_slices)
    names = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "GROUP_RANK")
    return {"env": {k: os.environ.get(k) for k in names},
            "info": (info.rank, info.world, info.local_world, info.node, info.nodes),
            "mesh": (mesh.n_slices, mesh.per_slice, mesh.slice_index, mesh.local_index,
                     mesh.data_index), "reduction_transport": reduction_transport(mesh)}


def reduction_parity(sizes: Sequence[int], seed: int, n_slices: Optional[int] = None
                     ) -> Dict[str, Any]:
    """On this rank of ``create_multislice_mesh(n_slices)``: one bucket of
    each of ``sizes`` elements, rank r's values seeded by (seed, r), summed
    over the ranks by each sum this process group can run (the flat
    all-reduce, the gloo two-level, and on a backend with reduce-scatter
    the NCCL form), at float32 and float64. Returns them by (how, dtype)."""
    from sad_tpu_torch.parallel.mesh import create_multislice_mesh

    mesh = create_multislice_mesh(n_slices)
    rng = np.random.RandomState([seed, current().rank])
    dev = torch.device("cuda", torch.cuda.current_device()) if mesh.backend == "nccl" else "cpu"
    hows = ["flat", "gloo two-level", "nccl two-level"]
    out: Dict[str, Any] = {}
    for dtype in (torch.float32, torch.float64):
        xs = [torch.from_numpy(rng.randn(n)).to(dev, dtype) for n in sizes]
        for how in hows:
            out[(how, str(dtype))] = [
                distributed.sum_bucket(x.clone(), mesh, how).cpu().numpy() for x in xs]
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
                held: Optional[int] = None, nodes: int = 1) -> Dict[str, Any]:
    """``rank_steps`` on one process (a world of 1 with ``one_backend``,
    NCCL on the card by default) and on ``world`` ranks over ``nodes``
    nodes (torchrun's environment), both within ``timeout_s``; their
    comparison (``compare``, over ``held`` steps). The ranks run on
    ``create_multislice_mesh()`` when there are nodes or the batch's
    ``n_groups`` do not divide over the ranks. On the
    card the two worlds run one after the other, so that neither's step
    times hold the other's work; on the CPU, where no time is read, at
    once."""
    from concurrent.futures import ThreadPoolExecutor

    from sad_tpu_torch.parallel.launch import spawn

    deadline = time.monotonic() + timeout_s

    if device == "cuda":
        backend, local, note = card_layout(world)
    else:
        backend, local, note = "gloo", [0] * world, f"{world} ranks on the CPU over gloo"
    mesh = nodes > 1 or build_kwargs.get("n_groups", world) % world != 0
    args = (build, build_kwargs, steps, lr, iters)

    def one_world():
        return spawn(rank_steps, 1, args, device=device, backend=one_backend, local_ranks=[0],
                     timeout_s=timeout_s, threads=threads)[0]

    def ranks_world():
        return spawn(rank_steps, world, args + (mesh,), device=device, backend=backend,
                     local_ranks=local, timeout_s=deadline - time.monotonic(), threads=threads,
                     nodes=nodes)

    if device == "cuda":
        one = one_world()
        ranks = ranks_world()
    else:
        with ThreadPoolExecutor(2) as pool:
            one_f, ranks_f = pool.submit(one_world), pool.submit(ranks_world)
            one, ranks = one_f.result(), ranks_f.result()
    if nodes > 1:
        note += f", as {nodes} nodes of {world // nodes}"
    return {"one": one, "ranks": ranks, "layout": note, **compare(one, ranks, held)}


def reduction_numbers(rank: Dict[str, Any]) -> Dict[str, Any]:
    """A rank's instrumented steps (``rank_steps``' 'reduction'): the
    medians of each stage's ms a step and its bytes: the two levels of the
    gradient sum ('node', 'cross'), the flat all-reduce of the same
    gradients ('flat'), the per-group count all-reduce ('counts')."""
    levels = rank.get("reduction") or []
    out: Dict[str, Any] = {"transport": rank["reduction_transport"]}
    for k in ("node", "cross", "flat", "counts"):
        ms = [1e3 * x[f"{k}_s"] for x in levels]
        out[f"{k}_ms"] = statistics.median(ms) if ms else None
        out[f"{k}_bytes"] = levels[0][f"{k}_bytes"] if levels else None
    return out


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
        "reduction": [reduction_numbers(r) for r in res["ranks"]],
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
