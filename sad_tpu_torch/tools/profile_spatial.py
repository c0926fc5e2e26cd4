"""A mesh's 'model' axis held against one process: the rank functions that
chip_smoke.py and the CPU tests hand to ``parallel.launch.spawn``.

- ``rank_mesh_steps``: the joint SAD step (or the plain RetinaNet step) of a
  seeded run (tools/profile_train.SeededTrainStep, or a run a test saved:
  ``profile_ddp.load_run``) on this rank's piece of its batch on an
  (n_data, n_model) mesh (``mesh.shard_batch_tree``: the data shard's
  images, a band of rows of each), ``steps`` compared steps at float32 with
  PyTorch's own convolutions, then ``iters`` timed ones with cuDNN; its
  readings are those of profile_ddp.rank_steps, which ``profile_ddp.compare``
  holds against one process's, plus the halo's bytes and seconds.
- ``rank_mesh_infer``: height-sharded serving (``make_inference_fn(cfg,
  model, mesh)``) of a seeded batch; on the model group's first rank with
  ``reference`` also one process's serving of the same data shard in this
  process, the comparison, and the NMS kernel's inputs of the last batch.

Transport: NCCL with a card a rank, gloo through pinned host memory for
ranks that share one card, gloo on the CPU (parallel/halo.py); the readings
name it.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from sad_tpu_torch.parallel import distributed, halo
from sad_tpu_torch.parallel.distributed import all_reduce_grads, current, reduction_transport
from sad_tpu_torch.parallel.mesh import (
    create_mesh, create_multislice_mesh, row_band, shard_batch_tree,
)
from sad_tpu_torch.tools.profile_ddp import _counts, _trees, reset_counts
from sad_tpu_torch.train import make_train_step


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def mesh_piece(run, mesh):
    """A seeded run of the whole batch cut to this rank's piece on ``mesh``:
    its batch ``shard_batch_tree``'s, its step a mesh step of the batch's G
    groups."""
    step = run.step
    groups = step.n_groups if step.n_groups is not None else run.batch["fg_num"].shape[0]
    run.batch = shard_batch_tree(run.batch, mesh)
    run.step = make_train_step(run.student_cfg, run.student, run.teacher, n_groups=groups,
                               teacher_cfg=run.teacher_cfg, cls_losses=step.cls_losses,
                               mesh=mesh)
    run.n_images //= mesh.n_data
    return run


class _Capture:
    """The fused cls-loss function, recording its first call's inputs and
    the cotangents its backward receives (the kernels' inputs at this
    rank's band of P3)."""

    def __init__(self, fn: Callable):
        self.fn, self.got = fn, None

    def __call__(self, logits, probs, labels, n_groups, p):
        out = self.fn(logits, probs, labels, n_groups, p)
        if self.got is None:
            c = logits.shape[-1]
            self.got = {"x": logits.detach().reshape(-1, c).float().clone(),
                        "pt": probs.reshape(-1, c).float().clone(),
                        "labels": labels.reshape(-1).to(torch.int32).clone(),
                        "groups": n_groups, "params": tuple(p)}
            for key, t in (("g_focal", out[0]), ("g_distill", out[1])):
                if t.requires_grad:
                    t.register_hook(lambda g, key=key: self.got.__setitem__(key, g.clone()))
        return out


def _mesh_step(run, lr: float, events=None, flat: bool = False) -> Dict[str, float]:
    """One mesh step through the step's stages (its metrics are already the
    batch's); ``events`` (3 CUDA events) recorded around the gradient
    all-reduce and after the update; with ``flat`` the gradients also summed
    by one flat all-reduce first, for ``distributed.stats`` to time."""
    step = run.step
    s_data, t_data = step.inputs(run.batch)
    total, metrics = step.losses(step.forward(s_data), step.teacher_probs(t_data), run.batch)
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
    return {k: float(v) for k, v in metrics.items()}


def rank_mesh_steps(build: Callable, build_kwargs: Dict[str, Any], n_data: int, n_model: int,
                    steps: int, lr: float, iters: int = 0, capture: bool = False,
                    timed_kwargs: Optional[Dict[str, Any]] = None,
                    n_slices: Optional[int] = None) -> Dict[str, Any]:
    """On this rank of an (n_data, n_model) mesh: ``build(**build_kwargs)``
    cut to the rank's piece (``mesh_piece``), the kernel counts set to 0,
    ``steps`` compared steps (TF32 and cuDNN off) with the metrics, the
    parameters and momenta after each, the counts and the peak memory read
    after them, then ``iters`` timed steps with cuDNN, of a fresh
    ``build(**timed_kwargs)`` when given (the compared run at another compute
    dtype), and as many with the exchanges timed: their halo ms and bytes,
    each level of the gradient sum, a flat all-reduce of the same gradients
    beside a two-level one and the count all-reduce (``distributed.stats``),
    and the peak memory. With ``capture`` the cls-loss kernels' inputs of
    the first step at this rank's band of P3 come back too. With
    ``n_slices`` the mesh is ``create_multislice_mesh(n_slices)`` over the
    n_data ranks (n_model = 1)."""
    from sad_tpu_torch.device import set_tf32

    set_tf32(False)
    info = current()
    mesh = create_multislice_mesh(n_slices) if n_slices else create_mesh(n_data, n_model)
    run = mesh_piece(build(**build_kwargs), mesh)
    dev = next(run.student.parameters()).device
    cap = _Capture(run.step.cls_losses) if capture else None
    if cap is not None:
        run.step.cls_losses = cap
    reset_counts()
    halo.reset_stats()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    metrics, trees, norms = [], [], []
    torch.backends.cudnn.enabled = False
    try:
        for _ in range(steps):
            metrics.append(_mesh_step(run, lr))
            trees.append(_trees(run))
            norms.append({k: v.cpu().numpy() for k, v in run.step.normalizers.items()})
    finally:
        torch.backends.cudnn.enabled = True
    launches = _counts()
    halo_bytes = halo.stats["bytes"] / max(steps, 1)
    out = {
        "rank": info.rank, "world": info.world, "backend": info.backend,
        "transport": halo.transport(mesh, dev), "n_images": run.n_images,
        "reduction_transport": reduction_transport(mesh), "slice": mesh.slice_index,
        "band_rows": list(mesh.band(run.batch["canvas_h"])) if n_model > 1 else None,
        "metrics": metrics, "launches": launches, "trees": trees, **trees[-1],
        "generator": [], "normalizers": norms, "halo_bytes_per_step": halo_bytes,
        "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None,
    }
    if cap is not None and cap.got is not None:
        out["band_p3"] = {k: (v.cpu().numpy() if torch.is_tensor(v) else v)
                          for k, v in cap.got.items()}
    step_ms, reduce_ms, halo_ms, halo_bytes, levels = [], [], [], [], []
    two_level = reduction_transport(mesh) != "flat"
    if iters and timed_kwargs is not None:
        del run, cap
        run = mesh_piece(build(**timed_kwargs), mesh)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    # the timed steps, then as many with every exchange timed (a device
    # synchronisation before and after each): the halo's ms and bytes
    for timed in [False] * iters + [True] * iters:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)] if dev.type == "cuda" \
            else None
        halo.reset_stats(timed=timed)
        distributed.reset_stats(timed=timed)
        _sync(dev)
        t0 = time.perf_counter()
        _mesh_step(run, lr, ev, flat=timed and two_level)
        _sync(dev)
        if timed:
            halo_ms.append(1e3 * halo.stats["seconds"])
            halo_bytes.append(halo.stats["bytes"])
            levels.append(dict(distributed.stats))
            out.setdefault("instrumented_step_ms", []).append(1e3 * (time.perf_counter() - t0))
            continue
        step_ms.append(1e3 * (time.perf_counter() - t0))
        if ev:
            reduce_ms.append(ev[0].elapsed_time(ev[1]))
    halo.reset_stats()
    distributed.reset_stats()
    out.update(step_ms=step_ms, reduce_ms=reduce_ms, halo_ms=halo_ms, halo_bytes=halo_bytes,
               reduction=levels,
               timed_peak_gib=(torch.cuda.max_memory_allocated(dev) / 2**30
                               if dev.type == "cuda" and iters else None))
    return out


def one_process_steps(build: Callable, build_kwargs: Dict[str, Any], steps: int, lr: float,
                      iters: int = 0, timed_kwargs: Optional[Dict[str, Any]] = None
                      ) -> Dict[str, Any]:
    """One process's ``profile_ddp.rank_steps`` of ``build(**build_kwargs)``
    (``steps`` compared steps), then ``iters`` steps with cuDNN of a fresh
    ``build(**timed_kwargs)`` timed by the host clock ('step_ms')."""
    from sad_tpu_torch.tools.profile_ddp import _step, rank_steps

    out = rank_steps(build, build_kwargs, steps, lr, 0)
    if iters:
        run = build(**(timed_kwargs or build_kwargs))
        dev = next(run.student.parameters()).device
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        out["step_ms"] = []
        for _ in range(iters):
            _sync(dev)
            t0 = time.perf_counter()
            _step(run, lr)
            _sync(dev)
            out["step_ms"].append(1e3 * (time.perf_counter() - t0))
        out["timed_peak_gib"] = (torch.cuda.max_memory_allocated(dev) / 2**30
                                 if dev.type == "cuda" else None)
    return out


def seeded_serving(cfg_path: str, seed: int, batch: int, device: str = "cuda", opts=()):
    """(cfg, model, images, im_hw, im_scale, content_hw): a RetinaNet config
    (with ``opts``) and its model with random weights from ``seed`` in its
    compute dtype, and one batch of seeded uint8 canvases of its landscape
    test canvas, on ``device``."""
    from sad_tpu_torch.config import load_cfg
    from sad_tpu_torch.data.synthetic import random_canvases
    from sad_tpu_torch.eval.test_engine import _test_canvas_shapes
    from sad_tpu_torch.models import compute_dtype, create_model

    cfg = load_cfg(cfg_path, list(opts))
    model = create_model(cfg, device, torch.Generator(device=device).manual_seed(seed))
    model.to(compute_dtype(cfg))
    (ch, cw), _ = _test_canvas_shapes(cfg)
    b = random_canvases(np.random.RandomState(seed), batch, (ch, cw), device)
    return cfg, model, b["data"], b["im_hw"], b["im_scale"], b["content_hw"]


def _shard(x, mesh):
    k = x.shape[0] // mesh.n_data
    return x[mesh.data_index * k:(mesh.data_index + 1) * k]


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def _rel_max(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max().clamp_min(
        1e-30))


def box_ties(dets, ref, cands, tol: float = 1e-5) -> Dict[str, Any]:
    """The kept boxes of ``dets`` against one process's ``ref``: 'boxes_rel'
    (the largest difference over max|ref box|) over the slots that are not
    at a tie, and the slots whose boxes differ by more than ``tol`` x max:
    each is 'tied' when one process's candidates (``cands``, its decode
    before the NMS) hold at least two of the slot's class with a score
    within ``tol`` x max score of it, one of them the box ``dets`` kept
    (a top-k or NMS tie, broken another way by outputs that differ in the
    last bits), else 'untied' (image, slot, class, score, both boxes)."""
    boxes, scores, classes, valid = cands
    scale, s_scale = ref["boxes"].abs().max(), ref["scores"].abs().max()
    diff = (dets["boxes"] - ref["boxes"]).abs().amax(-1)
    tied, untied = [], []
    for i, j in (diff > tol * scale).nonzero().tolist():
        same = valid[i] & (classes[i] == ref["classes"][i, j] - 1) & (
            (scores[i] - ref["scores"][i, j]).abs() <= tol * s_scale)
        hit = ((boxes[i][same] - dets["boxes"][i, j]).abs().amax(-1) <= tol * scale).any()
        entry = (i, j, int(ref["classes"][i, j]), float(ref["scores"][i, j]),
                 ref["boxes"][i, j].tolist(), dets["boxes"][i, j].tolist())
        (tied if int(same.sum()) >= 2 and bool(hit) else untied).append(entry)
    keep = torch.ones_like(diff, dtype=torch.bool)
    for i, j, *_ in tied:
        keep[i, j] = False
    return {"boxes_rel": float(diff[keep].max() / scale) if bool(keep.any()) else 0.0,
            "tied": tied, "untied": untied}


def rank_mesh_infer(build: Callable, build_kwargs: Dict[str, Any], n_data: int, n_model: int,
                    iters: int = 0, reference: bool = False, keep_outputs: bool = False
                    ) -> Dict[str, Any]:
    """On this rank of an (n_data, n_model) mesh: ``build(**build_kwargs)``
    (``seeded_serving``'s tuple), the kernel counts set to 0, one compared
    batch of height-sharded serving of this data shard (TF32 and cuDNN off;
    the raw level maps kept; its peak memory), ``iters`` timed batches with
    cuDNN and as many with the exchanges timed (forward,
    halo, gather and whole-batch ms, halo bytes), the counts read after
    them. The model group's first rank returns the detections and, with
    ``keep_outputs``, the gathered maps; with ``reference`` it first serves
    the data shard in one process and returns the comparison, the NMS
    kernel's inputs of the last batch and, after the counts were read, the
    one process's timed batches."""
    from sad_tpu_torch.config.config import merge_cfg_from_dict
    from sad_tpu_torch.device import set_tf32
    from sad_tpu_torch.eval.inference import (
        SERVING_OUTPUTS, decode_candidates, device_normalize, make_inference_fn,
    )
    from sad_tpu_torch.ops.nms import offset_by_class
    from sad_tpu_torch.parallel.spatial import spatialize

    set_tf32(False)
    info = current()
    mesh = create_mesh(n_data, n_model)
    cfg, model, images, im_hw, im_scale, content_hw = build(**build_kwargs)
    args = tuple(_shard(t, mesh) for t in (images, im_hw, im_scale, content_hw))
    dev = images.device
    raw_cfg = merge_cfg_from_dict(cfg, {"TEST": {"SAVE_RES": True}})
    out: Dict[str, Any] = {"rank": info.rank, "transport": halo.transport(mesh, dev),
                           "band_rows": list(mesh.band(images.shape[1]))}
    torch.backends.cudnn.enabled = False
    try:
        ref = None
        if reference and mesh.is_model_first:
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            ref = make_inference_fn(raw_cfg, model)(*args)
            _sync(dev)
            out["one_peak_gib"] = (torch.cuda.max_memory_allocated(dev) / 2**30
                                   if dev.type == "cuda" else None)
        reset_counts()
        halo.reset_stats()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        dets = make_inference_fn(raw_cfg, model, mesh)(*args)
        _sync(dev)
        out["peak_gib"] = (torch.cuda.max_memory_allocated(dev) / 2**30
                           if dev.type == "cuda" else None)
    finally:
        torch.backends.cudnn.enabled = True
    out["halo_bytes_per_batch"] = halo.stats["bytes"]
    infer = make_inference_fn(cfg, model, mesh)
    run = spatialize(model, mesh)
    height = images.shape[1]
    r0, r1 = mesh.band(height)
    fwd_ms, halo_ms, batch_ms, gather_ms = [], [], [], []
    # the timed batches (the banded forward alone, then the whole batch), then
    # as many with every exchange and gather timed (a device synchronisation
    # before and after each)
    for timed in [False] * iters + [True] * iters:
        halo.reset_stats(timed=timed)
        _sync(dev)
        t0 = time.perf_counter()
        with torch.inference_mode():
            band = device_normalize(cfg, args[0][:, r0:r1], args[3], row0=r0)
            run(band, outputs=SERVING_OUTPUTS, height=height)
        _sync(dev)
        t1 = time.perf_counter()
        infer(*args)
        _sync(dev)
        if timed:
            halo_ms.append(1e3 * halo.stats["seconds"])
            gather_ms.append(1e3 * halo.stats["gather_seconds"])
            continue
        fwd_ms.append(1e3 * (t1 - t0))
        batch_ms.append(1e3 * (time.perf_counter() - t1))
    halo.reset_stats()
    out.update(launches=_counts(), fwd_ms=fwd_ms, halo_ms=halo_ms, batch_ms=batch_ms,
               gather_ms=gather_ms)
    if ref is not None:  # one process's batches of the same shard, timed after the ranks'
        one = make_inference_fn(cfg, model)
        out["one_batch_ms"] = []
        for _ in range(iters):
            _sync(dev)
            t0 = time.perf_counter()
            one(*args)
            _sync(dev)
            out["one_batch_ms"].append(1e3 * (time.perf_counter() - t0))
    if dets is None:
        return out
    out["dets"] = _numpy({k: dets[k] for k in ("boxes", "scores", "classes", "valid")})
    if keep_outputs:
        out["raw"] = _numpy({"cls_prob": dets["raw_cls_prob"],
                             "bbox_pred": dets["raw_bbox_pred"]})
    if ref is not None:
        levels = [(k, lvl) for k in ("cls_prob", "bbox_pred") for lvl in ref[f"raw_{k}"]]
        out["level_rel"] = {f"{k}@P{lvl}": _rel_max(dets[f"raw_{k}"][lvl], ref[f"raw_{k}"][lvl])
                            for k, lvl in levels}
        out["classes_equal"] = bool(torch.equal(dets["classes"], ref["classes"]))
        out["valid_equal"] = bool(torch.equal(dets["valid"], ref["valid"]))
        out["scores_rel"] = _rel_max(dets["scores"], ref["scores"])
        out["n_valid"] = int(ref["valid"].sum())
        with torch.inference_mode():
            one = {"cls_prob": ref["raw_cls_prob"], "bbox_pred": ref["raw_bbox_pred"]}
            out.update(box_ties(dets, ref, decode_candidates(cfg, one, args[1], args[2],
                                                             cfg.TEST.BBOX_REG)))
            full = {"cls_prob": dets["raw_cls_prob"], "bbox_pred": dets["raw_bbox_pred"]}
            cands = decode_candidates(cfg, full, args[1], args[2], cfg.TEST.BBOX_REG)
            boxes, scores = offset_by_class(*cands)
        out["nms_inputs"] = {"boxes": boxes.cpu().numpy(), "scores": scores.cpu().numpy(),
                             "thr": cfg.TEST.NMS, "max_out": cfg.TEST.DETECTIONS_PER_IM}
    return out


def position_weights(shape, dtype=torch.float32) -> torch.Tensor:
    """sin(0.37 i) over the flat indices of a whole map of ``shape``: the
    weights of a scalar of a forward's outputs that a banded run and one
    process can both take (each slices the rows it holds)."""
    n = int(np.prod(shape))
    return torch.sin(0.37 * torch.arange(n, dtype=torch.float64)).reshape(shape).to(dtype)


def output_scalar(out, full_shapes, rows=None, data=None) -> torch.Tensor:
    """sum over every output map of map * position_weights(its whole shape),
    the weights cut to image block ``data`` = (start, stop) and to each
    level's band ``rows[key][lvl]`` = (r0, r1) when given."""
    total = 0.0
    for key, maps in out.items():
        for lvl, v in maps.items():
            w = position_weights(full_shapes[key][lvl], v.dtype).to(v.device)
            if data is not None:
                w = w[data[0]:data[1]]
            if rows is not None:
                r0, r1 = rows[key][lvl]
                w = w[:, r0:r1]
            total = total + (v * w).sum()
    return total


def against_float64(one, ranks, ref, tol: float) -> Dict[str, Any]:
    """The float32 mesh run (``ranks[0]``) and one process's (``one``) after
    their last compared step, each against ``ref``, one process's run of the
    same seeded state at float64 compute: 'one_worst' and 'mesh_worst', the
    largest relative L2 error of a parameter tensor of each against ``ref``
    (value, name), and 'beyond', the tensors whose relative L2 difference
    between the mesh and one process exceeds ``tol``, each with that
    difference and both runs' error against ``ref`` ('mesh_vs_one',
    'mesh_vs_f64', 'one_vs_f64'). A tensor whose value nearly cancels (a
    zero-initialised bias after two steps) takes most of float32's error,
    in either run, from how its many terms are summed."""
    from sad_tpu_torch.tools.profile_ddp import rel_l2

    mesh, one32, f64 = (r["trees"][-1]["params"] for r in (ranks[0], one, ref))
    err_one = {k: rel_l2(v, f64[k]) for k, v in one32.items()}
    err_mesh = {k: rel_l2(mesh[k], f64[k]) for k in one32}
    beyond = {}
    for k, want in one32.items():
        d = rel_l2(mesh[k], want)
        if d > tol:
            beyond[k] = {"mesh_vs_one": d, "mesh_vs_f64": err_mesh[k], "one_vs_f64": err_one[k]}
    worst = [max((v, k) for k, v in e.items()) for e in (err_one, err_mesh)]
    return {"one_worst": worst[0], "mesh_worst": worst[1], "beyond": beyond}


def rank_forward(path: str, n_data: int, n_model: int, grads: bool = True) -> Dict[str, Any]:
    """On this rank of an (n_data, n_model) mesh, n_model > 1: the RetinaNet
    and whole images (B, H, W, 3) that ``torch.save`` wrote to ``path`` as
    {'model', 'images'}, the forward of this rank's images' band
    (parallel/spatial.py) and, with ``grads``, the gradients of
    ``output_scalar`` with respect to the band and to every parameter that
    takes one (zeros for one this band's rows do not use). TF32 and cuDNN
    are off, as in the one process it is held against (``gradient_parity``)."""
    from sad_tpu_torch.device import set_tf32
    from sad_tpu_torch.models.retinanet import ALL_OUTPUTS
    from sad_tpu_torch.parallel.spatial import spatialize

    set_tf32(False)
    saved = torch.load(path, weights_only=False)
    model, images = saved["model"], saved["images"]
    mesh = create_mesh(n_data, n_model)
    height = images.shape[1]
    k = images.shape[0] // n_data
    data = (mesh.data_index * k, (mesh.data_index + 1) * k)
    r0, r1 = mesh.band(height)
    x = images[data[0]:data[1], r0:r1].clone().requires_grad_(grads)
    run = spatialize(model, mesh)
    torch.backends.cudnn.enabled = False
    try:
        out = run(x, height=height)
        heights = run.level_heights(height, ALL_OUTPUTS, x.dtype, x.device)
        result = {"rank": current().rank, "band": (r0, r1), "data": data, "out": _numpy(out)}
        if grads:
            shapes = {key: {lvl: (images.shape[0], h) + tuple(out[key][lvl].shape[2:])
                            for lvl, h in hs.items()} for key, hs in heights.items()}
            rows = {key: {lvl: mesh.band(h) for lvl, h in hs.items()}
                    for key, hs in heights.items()}
            scalar = output_scalar(out, shapes, rows, data)
            named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
            got = torch.autograd.grad(scalar, [x] + [p for _, p in named], allow_unused=True)
            result["grad_x"] = got[0].cpu().numpy()
            result["grads"] = {n: (torch.zeros_like(p) if g is None else g).cpu().numpy()
                               for (n, p), g in zip(named, got[1:])}
    finally:
        torch.backends.cudnn.enabled = True
    return result


def rank_jobs(jobs) -> list:
    """Each (name, kwargs) of ``jobs`` in order on this rank, name one of
    'forward', 'steps', 'infer', 'one' (rank_forward, rank_mesh_steps,
    rank_mesh_infer, one_process_steps) or 'rank_steps', 'layout', 'parity',
    'cli' (profile_ddp's rank_steps, rank_layout, reduction_parity,
    rank_cli); their results. One world runs them all, each on a mesh of
    its own."""
    from sad_tpu_torch.tools import profile_ddp

    fns = {"forward": rank_forward, "steps": rank_mesh_steps, "infer": rank_mesh_infer,
           "one": one_process_steps, "rank_steps": profile_ddp.rank_steps,
           "layout": profile_ddp.rank_layout, "parity": profile_ddp.reduction_parity,
           "cli": profile_ddp.rank_cli}
    return [fns[name](**kwargs) for name, kwargs in jobs]


def predicted_halo_bytes(model, canvas, images: int, n_model: int, outputs,
                         backward: bool = False):
    """The bytes each model index sends in the halo exchanges of one
    forward (and, with ``backward``, of its backward) of ``model`` on
    ``images`` canvases of ``canvas`` = (H, W) split over ``n_model`` bands,
    computed from the shapes alone: a record run on the meta device (each
    routed op's input shape), then each exchange's plan. The backward sends
    each rank's received rows back, for the ops whose input takes a gradient
    (not the frozen stages')."""
    from sad_tpu_torch.models import trainable_mask
    from sad_tpu_torch.parallel import spatial
    from sad_tpu_torch.parallel.halo import plan

    spatial.check_bandable(model)
    rec = spatial._Record()
    mask = trainable_mask(model, model.arch.freeze_at, False)
    named = dict(model.named_parameters())
    before = {n: p.requires_grad for n, p in named.items()}
    try:
        for n, p in named.items():  # the step differentiates the trainable tensors only
            p.requires_grad_(backward and mask[n])
        with torch.device("meta"), spatial._Routed(rec):
            model(torch.zeros((images, canvas[0], canvas[1], 3)), outputs=tuple(outputs))
    finally:
        for n, p in named.items():
            p.requires_grad_(before[n])
    sent = [0] * n_model
    for op, (shape, esize, grad) in zip(rec.ops, rec.inputs):
        k, s, p, d = op.window
        bands = [row_band(op.h_out, n_model, q) for q in range(n_model)]
        needs = [spatial.upsample_rows(b) if op.kind == "up" else spatial.needed_rows(b, k, s, p, d)
                 for b in bands]
        row = shape[0] * shape[1] * shape[3] * esize
        for m in range(n_model):
            pl = plan(op.h_in, needs, m)
            sent[m] += row * sum(r1 - r0 for _, r0, r1 in pl.sends)
            if backward and grad:
                sent[m] += row * sum(r1 - r0 for _, r0, r1 in pl.recvs)
    return sent


def _readings(out, grad_x, grads, ref) -> Dict[str, Any]:
    """Outputs (worst difference over max), input gradient and worst
    parameter gradient (relative L2) of one run against ``ref``'s."""
    from sad_tpu_torch.tools.profile_ddp import rel_l2

    params = {n: rel_l2(g, ref["grads"][n]) for n, g in grads.items()}
    worst = max(params, key=params.get)
    return {"outputs_rel": max(float(np.abs(v - ref["out"][k][lvl]).max()
                                     / np.abs(ref["out"][k][lvl]).max())
                               for k, d in out.items() for lvl, v in d.items()),
            "grad_x_rel_l2": rel_l2(grad_x, ref["grad_x"]),
            "param_rel_l2": params[worst], "param_key": worst}


def gradient_parity(cfg_path: str, seed: int = 0, images: int = 2, n_model: int = 2,
                    timeout_s: float = 600.0, device: str = "cuda") -> Dict[str, Any]:
    """The config's RetinaNet (random weights from ``seed``, FREEZE_AT 0) on
    ``images`` random canvases of its training canvas on ``device``, at
    float64 and at float32 compute and parameters: ``rank_forward`` on
    ``n_model`` ranks (their backend and cards as
    ``profile_ddp.card_layout``) and one process's forward, each with the
    gradients of ``output_scalar``, TF32 and cuDNN off in every process.
    Returns, at each dtype, the banded run against one process's
    (``_readings``) and, at float32, each of the two against one process's
    float64 run ('banded_vs_f64', 'one_vs_f64')."""
    import dataclasses
    import os
    import tempfile

    from sad_tpu_torch.config import load_cfg
    from sad_tpu_torch.data.minibatch import canvas_shapes
    from sad_tpu_torch.device import set_tf32
    from sad_tpu_torch.models import create_model
    from sad_tpu_torch.models.retinanet import RetinaNet
    from sad_tpu_torch.parallel.launch import spawn
    from sad_tpu_torch.tools.profile_ddp import card_layout

    set_tf32(False)
    torch.backends.cudnn.enabled = False
    cfg = load_cfg(cfg_path, ["COMPUTE_DTYPE", "float32"])
    base = create_model(cfg, device, torch.Generator(device=device).manual_seed(seed))
    (h, w), _ = canvas_shapes(cfg)
    x64 = torch.from_numpy(np.random.RandomState(seed).randn(images, h, w, 3))
    backend, local, _ = card_layout(n_model) if device == "cuda" else ("gloo", None, "")
    found = {}
    for dtype in ("float64", "float32"):
        dt = getattr(torch, dtype)
        model = RetinaNet(dataclasses.replace(base.arch, compute_dtype=dtype, freeze_at=0))
        model.load_state_dict(base.state_dict())
        model = model.to(device, dt)
        x = x64.to(device, dt)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "run.pt")
            torch.save({"model": model, "images": x}, path)
            ranks = spawn(rank_forward, n_model, (path, 1, n_model), device=device,
                          backend=backend, local_ranks=local, timeout_s=timeout_s)
        xr = x.clone().requires_grad_(True)
        out = model(xr)
        shapes = {k: {lvl: tuple(v.shape) for lvl, v in d.items()} for k, d in out.items()}
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        got = torch.autograd.grad(output_scalar(out, shapes), [xr] + [p for _, p in named])
        one = {"out": _numpy(out), "grad_x": got[0].cpu().numpy(),
               "grads": {n: g.cpu().numpy() for (n, _), g in zip(named, got[1:])}}
        banded = {"out": {k: {lvl: np.concatenate([r["out"][k][lvl] for r in ranks], 1)
                              for lvl in d} for k, d in one["out"].items()},
                  "grad_x": np.concatenate([r["grad_x"] for r in ranks], 1),
                  "grads": {n: sum(r["grads"][n] for r in ranks) for n in one["grads"]}}
        found[dtype] = (one, banded)
        del model, out, got
    one64 = found["float64"][0]
    runs = {dt: _readings(b["out"], b["grad_x"], b["grads"], one)
            for dt, (one, b) in found.items()}
    one32, banded32 = found["float32"]
    runs["float32"].update(
        banded_vs_f64=_readings(banded32["out"], banded32["grad_x"], banded32["grads"], one64),
        one_vs_f64=_readings(one32["out"], one32["grad_x"], one32["grads"], one64))
    return runs


def main(argv=None):
    """The banded RetinaNet's forward and gradients against one process on
    the card, at float64 and float32, and at float32 each against one
    process's float64 run (``gradient_parity``), beside the card's name and
    power limit."""
    import argparse
    import json

    from sad_tpu_torch.device import nvidia_smi_line

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--cfg", default="sad_tpu_torch/configs/retinanet_R-50-FPN_student.yaml")
    p.add_argument("--n-model", type=int, default=2)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_spatial needs a CUDA card")
    out = {"gpu": nvidia_smi_line(), "runs": gradient_parity(args.cfg, n_model=args.n_model)}
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
