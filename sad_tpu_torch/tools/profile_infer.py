"""Where the time of batched inference goes, on the card.

    python -m sad_tpu_torch.tools.profile_infer --cfg sad_tpu_torch/configs/retinanet_R-50-FPN_student.yaml \
        [--batch 8] [--iters 20] [--seed 0] [--out profile_student.json]

``--cfg`` takes the RetinaNet configs and the R-CNN ones
(``e2e_faster_rcnn_R-50-FPN.yaml``, ``e2e_mask_rcnn_R-50-FPN.yaml``,
``e2e_keypoint_rcnn_R-50-FPN.yaml``, and ``fast_rcnn_R-50-FPN.yaml`` on
TEST.PROPOSAL_LIMIT seeded proposals an image, spread over its content), and
the single-scale ones (``e2e_faster_rcnn_R-50-C4.yaml``,
``e2e_mask_rcnn_R-50-C4.yaml``, ``faster_rcnn_VGG16.yaml``,
``rfcn_R-101-C4_ohem.yaml``). Seeded
random weights in the config's compute dtype and seeded uint8 canvases of the
config's landscape test canvas. Prints, and writes as JSON:
- imgs/s: median and quartiles of --iters timed batches (host clock around
  torch.cuda.synchronize(), profiler off);
- per-stage device ms (CUDA events, medians). RetinaNet: normalise, forward,
  decode before NMS, NMS, gather. R-CNN: normalise, backbone+FPN, RPN head,
  candidates, RPN NMS, collect, RoIAlign, box head, decode, detection NMS,
  gather, with MODEL.MASK_ON mask RoIAlign and mask head, and with
  MODEL.KEYPOINTS_ON keypoint RoIAlign and keypoint head; Fast R-CNN:
  normalise, backbone+FPN, RoI levels, RoIAlign, box head, decode, detection
  NMS, gather; single-scale: normalise, body (to res4, or VGG's conv5), RPN
  head, candidates, RPN NMS, RoIAlign (R-FCN: its score maps), box head (res5,
  fc6 / fc7, or R-FCN's PSRoIPool and vote), decode, detection NMS, gather,
  and with MODEL.MASK_ON the cascaded mask branch (its RoIAlign, then res5
  with the deconv and logits);
- peak device memory of the timed batches (torch.cuda.max_memory_allocated);
- from a torch.profiler run of 5 batches: kernel time by category (conv,
  matmul, elementwise, top-k/sort, NMS kernel, RoIAlign kernel, other), the
  top kernels by name, and the device idle share = 1 - kernel time / wall
  time, against the wall time of the profiled run and of the unprofiled
  timed batches.
Needs a CUDA card; raises without one. chip_smoke.py builds its inference
runs with ``seeded_inference`` and times them with ``wall_seconds``.

Random R-CNN weights give an empty decode: N(0, 0.01) output layers put every
class near 1/81, under TEST.SCORE_THRESH, and every objectness near 0.5. So
``seeded_inference`` rescales the four output layers of an R-CNN model once
(``spread_rcnn_outputs``): the detection NMS and the mask and keypoint
branches then work on thousands of candidates an image (a thousand with the
one foreground class of the keypoint config), as they do with trained
weights.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import statistics
import time

import numpy as np
import torch

from sad_tpu_torch.config import load_cfg
from sad_tpu_torch.data.synthetic import random_canvases, random_proposals
from sad_tpu_torch.device import get_device, nvidia_smi_line, set_tf32
from sad_tpu_torch.eval.inference import (
    decode_candidates, device_normalize, gather_detections, make_inference_fn,
)
from sad_tpu_torch.eval.rcnn_inference import (
    decode_rcnn_candidates, fast_rcnn_outputs, keypoint_roi_features, kept_box_rois,
    make_rcnn_inference_fn, mask_roi_features, rcnn_gather_detections, single_scale,
)
from sad_tpu_torch.eval.test_engine import _test_canvas_shapes
from sad_tpu_torch.models import compute_dtype, create_model
from sad_tpu_torch.ops.nms import batched_nms_multi
from sad_tpu_torch.ops.proposals import map_rois_to_fpn_levels, nms_levels_batched

logger = logging.getLogger(__name__)

_CATEGORIES = (
    ("nms_kernel", ("nms_order_kernel", "nms_mask_kernel", "nms_sweep_kernel",
                    "nms_run_sort_kernel", "nms_merge_kernel", "nms_kept_sweep_kernel")),
    ("roi_align_kernel", ("roi_align_fwd_kernel",)),
    # cuDNN's convolutions are implicit GEMMs: name them before the dense layers' GEMMs
    ("conv", ("conv", "fprop", "implicit_gemm", "cudnn", "nchwToNhwc", "nhwcToNchw")),
    ("matmul", ("gemm", "cublas", "gemv", "nvjet")),
    ("conv", ("xmma", "cutlass")),
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


# std of the four R-CNN output layers after spread_rcnn_outputs: objectness
# logits (sigmoid spreads over 0.1..0.9), RPN deltas (boxes move by a good
# part of an anchor, so the proposal NMS keeps many), class logits (a few of
# the 81 classes of a roi pass SCORE_THRESH 0.05), box deltas (divided by
# BBOX_REG_WEIGHTS 10/5 in the decode)
_SPREAD_STD = {"rpn_cls": 2.0, "rpn_bbox": 0.5, "cls_score": 3.0, "bbox_pred": 1.0}


@torch.no_grad()
def spread_rcnn_outputs(cfg, model, images, im_hw, content_hw, proposals=None,
                        prop_valid=None) -> dict:
    """Rescale the weights and biases of the RPN's two output convs and the
    box head's two output layers so that their outputs on this batch have the
    stds of ``_SPREAD_STD``; the RPN first, because the box head sees the
    rois it makes (Fast R-CNN: the box head sees ``proposals``). Returns the
    factors."""
    def rescale(layer, out, target):
        factor = target / float(out.float().std())
        layer.weight.mul_(factor)
        layer.bias.mul_(factor)
        return factor

    x = device_normalize(cfg, images, content_hw)
    feats = model._features(x)
    logits, deltas = model.rpn_outputs(feats)
    _, cls_name, bbox_name = model.rpn.names
    cls_out, bbox_out = box_output_layers(model)
    factors = {
        "rpn_cls": rescale(getattr(model.rpn, cls_name),
                           torch.cat([v.reshape(-1) for v in logits.values()]),
                           _SPREAD_STD["rpn_cls"]),
        "rpn_bbox": rescale(getattr(model.rpn, bbox_name),
                            torch.cat([v.reshape(-1) for v in deltas.values()]),
                            _SPREAD_STD["rpn_bbox"]),
    }
    out = (model(x, im_hw) if proposals is None
           else fast_rcnn_outputs(cfg, model, x, proposals, prop_valid))
    factors["cls_score"] = rescale(cls_out, out["cls_score"], _SPREAD_STD["cls_score"])
    factors["bbox_pred"] = rescale(bbox_out, out["bbox_pred"], _SPREAD_STD["bbox_pred"])
    return factors


def box_output_layers(model):
    """The layers whose outputs are an R-CNN's class scores and box deltas:
    the box head's two linear layers, or R-FCN's two score-map convs (the
    vote is a mean of their pooled outputs, so it scales with them)."""
    if getattr(model, "is_rfcn", False):
        return model.rfcn.rfcn_cls, model.rfcn.rfcn_bbox
    head = getattr(model, "box_head", None)
    head = head if isinstance(head, torch.nn.Module) else model
    return head.cls_score, head.bbox_pred


def is_rcnn(cfg) -> bool:
    return cfg.MODEL.TYPE in ("generalized_rcnn", "rfcn")


def seeded_proposals(rng: np.random.RandomState, content_hw: torch.Tensor, n: int, device):
    """Fast R-CNN's inputs beside the canvases: ``n`` proposals an image
    spread over its content in network-input coordinates (the stand-in for
    a proposal file) and their valid flags, all on."""
    props = np.stack([random_proposals(rng, float(w), float(h), n)
                      for h, w in content_hw.cpu().numpy()])
    return (torch.from_numpy(props).to(device),
            torch.ones(props.shape[:2], dtype=torch.bool, device=device))


def seeded_inference(cfg_path: str, seed: int, batch: int, device):
    """The config, its model with random weights from ``seed`` in the
    compute dtype (an R-CNN's output layers rescaled by
    ``spread_rcnn_outputs``), the inference function of it, and the arguments
    of one batch of seeded uint8 canvases of the config's landscape test
    canvas (for Fast R-CNN then its seeded proposals and their flags)."""
    cfg = load_cfg(cfg_path)
    model = create_model(cfg, device, torch.Generator(device=device).manual_seed(seed))
    model.to(compute_dtype(cfg))
    (ch, cw), _ = _test_canvas_shapes(cfg)
    b = random_canvases(np.random.RandomState(seed), batch, (ch, cw), device)
    args = (b["data"], b["im_hw"], b["im_scale"], b["content_hw"])
    if is_rcnn(cfg):
        if not cfg.MODEL.FASTER_RCNN:
            args += seeded_proposals(np.random.RandomState(seed + 1), b["content_hw"],
                                     cfg.TEST.PROPOSAL_LIMIT, device)
        spread_rcnn_outputs(cfg, model, b["data"], b["im_hw"], b["content_hw"], *args[4:])
        return cfg, model, make_rcnn_inference_fn(cfg, model), args
    return cfg, model, make_inference_fn(cfg, model), args


def _event_ms(fns):
    """Run the stage functions in order, each fed the previous result, with
    a CUDA event between them; returns the last result and the device ms of
    each stage."""
    events = [torch.cuda.Event(enable_timing=True) for _ in range(len(fns) + 1)]
    state = None
    events[0].record()
    for i, fn in enumerate(fns):
        state = fn(state)
        events[i + 1].record()
    torch.cuda.synchronize()
    return state, [events[i].elapsed_time(events[i + 1]) for i in range(len(fns))]


def retinanet_stages(cfg, model, x):
    """(name, fn) stages of one RetinaNet batch; the last, untimed in the
    report, returns the number of valid NMS candidates."""
    data, im_hw, im_scale, content_hw = x
    st = {}

    def candidates(out):
        st["cands"] = decode_candidates(cfg, out, im_hw, im_scale, cfg.TEST.BBOX_REG)
        return st["cands"]

    return [
        ("normalize", lambda _: device_normalize(cfg, data, content_hw)),
        ("forward", lambda im: model(im)),
        ("decode_pre_nms", candidates),
        ("nms", lambda c: batched_nms_multi(*c, cfg.TEST.NMS, cfg.TEST.DETECTIONS_PER_IM)),
        ("gather", lambda k: gather_detections(st["cands"], *k)),
        ("count", lambda _: st["cands"][3].sum()),
    ]


def rcnn_stages(cfg, model, x):
    """(name, fn) stages of one Fast / Faster / Mask / Keypoint R-CNN batch,
    the steps of GeneralizedRCNN.forward (or, for Fast R-CNN, of
    fast_rcnn_outputs on the proposals x[4], x[5]) and make_rcnn_inference_fn
    one by one; the last, untimed in the report, returns the number of valid
    detection-NMS candidates."""
    data, im_hw, im_scale, content_hw = x[:4]
    st = {}

    def keep(key, value):
        st[key] = value
        return value

    if single_scale(cfg):
        return single_scale_stages(cfg, model, x)
    if not cfg.MODEL.FASTER_RCNN:  # Fast R-CNN: x holds the proposals
        f = cfg.FPN
        levels = lambda _: map_rois_to_fpn_levels(  # noqa: E731
            x[4], f.ROI_MIN_LEVEL, f.ROI_MAX_LEVEL, f.ROI_CANONICAL_SCALE, f.ROI_CANONICAL_LEVEL)
        front = [("roi_levels", levels),
                 ("roi_align", lambda lv: roi_align((x[4], None, x[5], lv)))]
    else:
        front = [
            ("rpn_head", lambda feats: model.rpn_outputs(feats)),
            ("candidates", lambda o: model.rpn_candidates(*o, im_hw)),
            ("rpn_nms", lambda pl: nms_levels_batched(pl, cfg.TEST.RPN_NMS_THRESH,
                                                      cfg.TEST.RPN_POST_NMS_TOP_N)),
            ("collect", lambda kept: model.collect(*kept)),
            ("roi_align", lambda props: roi_align(props)),
        ]

    def roi_align(props):
        st["props"] = props
        st["nhwc"] = {l: f.permute(0, 2, 3, 1) for l, f in st["nchw"].items()}
        return model.box_roi_features(st["nhwc"], props[0], props[3], props[2])

    def decode(head_out):
        cls_score, bbox_pred = head_out
        boxes, _, valid, _ = st["props"]
        b, r = boxes.shape[:2]
        prob = torch.softmax(cls_score.reshape(b, r, -1), dim=-1)
        return keep("cands", decode_rcnn_candidates(
            cfg, boxes, valid, prob, bbox_pred.reshape(b, r, -1), im_hw, im_scale))

    stages = [
        ("normalize", lambda _: device_normalize(cfg, data, content_hw)),
        ("backbone_fpn", lambda im: keep("nchw", model._features(im))),
        *front,
        ("box_head", lambda rf: model.box_head(rf)),
        ("decode", decode),
        ("detection_nms", lambda c: batched_nms_multi(*c, cfg.TEST.NMS,
                                                      cfg.TEST.DETECTIONS_PER_IM)),
        ("gather", lambda k: keep("dets", rcnn_gather_detections(st["cands"], *k))),
    ]
    if cfg.MODEL.MASK_ON:
        stages += [
            ("mask_roi_align", lambda d: mask_roi_features(cfg, model, st["nhwc"], d["boxes"],
                                                           d["valid"], im_scale)),
            ("mask_head", lambda mf: torch.sigmoid(model.mask_heads(mf))),
        ]
    if cfg.MODEL.KEYPOINTS_ON:
        stages += [
            ("kps_roi_align", lambda _: keypoint_roi_features(
                cfg, model, st["nhwc"], st["dets"]["boxes"], st["dets"]["valid"], im_scale)),
            ("kps_head", lambda kf: model.keypoint_heads(kf)),
        ]
    stages.append(("count", lambda _: st["cands"][3].sum()))
    return stages


def single_scale_stages(cfg, model, x):
    """(name, fn) stages of one single-scale R-CNN batch (C4, VGG, R-FCN):
    the steps of SingleScaleRCNN.forward and make_rcnn_inference_fn one by
    one; the last, untimed, returns the number of valid detection-NMS
    candidates."""
    from sad_tpu_torch.models.rcnn import flat_rois

    data, im_hw, im_scale, content_hw = x[:4]
    st = {}

    def keep(key, value):
        st[key] = value
        return value

    def transform(props):
        st["props"] = props
        st["nhwc"] = {l: f.permute(0, 2, 3, 1) for l, f in st["nchw"].items()}
        if model.is_rfcn:  # the score maps take RoIAlign's place
            return model.rfcn.score_maps(st["nchw"][model.level])
        f = cfg.FAST_RCNN
        return model.pool(st["nhwc"], flat_rois(props[0]), f.ROI_XFORM_RESOLUTION,
                          f.ROI_XFORM_SAMPLING_RATIO)

    def head(t):
        if model.is_rfcn:
            return model.rfcn.vote(*t, flat_rois(st["props"][0]))
        return model.box_head(t)

    def decode(head_out):
        cls_score, bbox_pred = head_out
        boxes, _, valid, _ = st["props"]
        b, r = boxes.shape[:2]
        prob = torch.softmax(cls_score.reshape(b, r, -1), dim=-1)
        return keep("cands", decode_rcnn_candidates(
            cfg, boxes, valid, prob, bbox_pred.reshape(b, r, -1), im_hw, im_scale))

    m = cfg.MRCNN
    stages = [
        ("normalize", lambda _: device_normalize(cfg, data, content_hw)),
        ("body", lambda im: keep("nchw", model._features(im))),
        ("rpn_head", lambda feats: model.rpn_outputs(feats)),
        ("candidates", lambda o: model.rpn_candidates(*o, im_hw)),
        ("rpn_nms", lambda pl: nms_levels_batched(pl, cfg.TEST.RPN_NMS_THRESH,
                                                  cfg.TEST.RPN_POST_NMS_TOP_N)),
        ("collect", lambda kept: model.collect(*kept)),
        ("psroi_score_maps" if model.is_rfcn else "roi_align", transform),
        ("psroipool_vote" if model.is_rfcn else ("res5_head" if model.has_res5 else "fc6_fc7"),
         head),
        ("decode", decode),
        ("detection_nms", lambda c: batched_nms_multi(*c, cfg.TEST.NMS,
                                                      cfg.TEST.DETECTIONS_PER_IM)),
        ("gather", lambda k: keep("dets", rcnn_gather_detections(st["cands"], *k))),
    ]
    if cfg.MODEL.MASK_ON:
        stages += [
            ("cascaded_mask_roi_align", lambda d: model.pool(
                st["nhwc"], kept_box_rois(cfg, d["boxes"], im_scale)[0],
                m.ROI_XFORM_RESOLUTION, m.ROI_XFORM_SAMPLING_RATIO)),
            ("cascaded_mask_res5_head", lambda mf: torch.sigmoid(
                model.mask_out(model.mask_res5_maps(mf)))),
        ]
    stages.append(("count", lambda _: st["cands"][3].sum()))
    return stages


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


DEVICE_MS_SESSIONS = 3  # profiler sessions device_ms tries before it raises
DEVICE_MS_KEPT = 0.5  # the least share of a named kernel's launches a session must record
# spin kernels (torch.cuda._sleep(0)) launched at the start and at the end of each
# profiled session of device_ms, outside fn's calls and left out of its result: late
# in a long process the profiler loses about the first 20-30 kernel records of a
# session, whatever kernels they are (PERF.md section 6)
DEVICE_MS_PAD = (256, 64)
PAD_KERNEL = "spin_kernel"  # the name of torch.cuda._sleep's kernel
QUEUED_HOLD_CYCLES = 200_000_000  # ~0.1 s of the H100's clock: queued_ms's first hold


def kernel_ms_a_call(records, iters: int, named: bool):
    """From one profiler session over ``iters`` calls, (kernel, launches
    recorded, device microseconds) of each kernel: (the ms a call of each,
    the least share of a kernel's launches recorded). A kernel recorded
    about k times a call takes k times the mean of its recorded launches;
    one recorded fewer than once in two calls its total over ``iters``
    (and, unless ``named``, no share)."""
    ms, shares = {}, []
    for key, count, us in records:
        per_call = max(1, round(count / iters))
        often = count >= iters / 2
        if named or often:
            shares.append(count / (per_call * iters))
        ms[key] = us / 1e3 * (per_call / count if often else 1.0 / iters)
    return ms, min(shares, default=1.0)


def device_ms(fn, iters: int, warmup: int, name: str = "") -> dict:
    """Device ms a call of each of fn's CUDA kernels whose names hold `name`,
    from torch.profiler over ``iters`` calls after ``warmup``: the kernels'
    own time, without the host's share that a CUDA-event interval around a
    small kernel holds. Each session opens and closes with DEVICE_MS_PAD
    spin kernels, which the result leaves out. The profiler on the card does
    not always record every launch (late in a long process 40-47 of 50, now
    and then none: PERF.md section 6), so each kernel is timed from its
    recorded launches (``kernel_ms_a_call``), and a session is measured
    again, up to DEVICE_MS_SESSIONS in all, when it saw no such kernel or,
    with ``name``, recorded fewer than DEVICE_MS_KEPT of a named kernel's
    launches; then device_ms raises, naming what the last session saw."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for session in range(DEVICE_MS_SESSIONS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(DEVICE_MS_PAD[0]):
                torch.cuda._sleep(0)
            for _ in range(iters):
                fn()
            for _ in range(DEVICE_MS_PAD[1]):
                torch.cuda._sleep(0)
            torch.cuda.synchronize()
        events = prof.key_averages()
        cuda = [e for e in events if e.device_type == DeviceType.CUDA]
        ms, least = kernel_ms_a_call(
            [(e.key, e.count, e.self_device_time_total) for e in cuda
             if name in e.key and PAD_KERNEL not in e.key], iters, bool(name))
        if sum(ms.values()) > 0 and (not name or least >= DEVICE_MS_KEPT):
            if session or least < 1.0:
                logger.warning("device_ms *%s*: %d session(s) measured again; this one recorded "
                               "%.3f of a kernel's launches at least", name, session, least)
            return ms
    raise RuntimeError(
        f"the profiler recorded no CUDA kernel named *{name}*, or too few of its launches, in "
        f"{DEVICE_MS_SESSIONS} sessions of {iters} calls; the last saw {len(cuda)} CUDA kernels "
        f"{sorted((e.key[:60], e.count) for e in cuda)[:8]}, {len(events)} events, "
        f"{len(prof.events())} raw")


def queued_ms(fn, iters: int, warmup: int, hold_cycles: int = QUEUED_HOLD_CYCLES) -> float:
    """Mean device ms of a call of fn from CUDA events, without the host's
    share and without the profiler: a spin kernel (torch.cuda._sleep) holds
    the stream while all ``iters`` calls are enqueued, each between two
    events, so each pair brackets only what fn launched, back to back on the
    device. When the spin has ended before the last call was enqueued (fn
    synchronises, or the host is slower than the hold) the calls are
    enqueued again behind a hold twice as long, up to three holds; then
    queued_ms raises."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
        held = torch.cuda.Event()
        torch.cuda._sleep(hold_cycles << attempt)
        held.record()
        for start, end in zip(starts, ends):
            start.record()
            fn()
            end.record()
        in_time = not held.query()
        torch.cuda.synchronize()
        if in_time:
            return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters
    raise RuntimeError(f"queued_ms: the stream's hold of {hold_cycles << 2} cycles ended before "
                       f"{iters} calls were enqueued")


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
    torch.cuda.reset_peak_memory_stats()
    walls = wall_seconds(lambda: infer(*x), args.iters, 5)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    staged = (rcnn_stages if is_rcnn(cfg) else retinanet_stages)(cfg, model, x)
    stages = {name: [] for name, _ in staged}
    with torch.inference_mode():
        for _ in range(args.iters):
            n_valid, ms = _event_ms([fn for _, fn in staged])
            for (name, _), t in zip(staged, ms):
                stages[name].append(t)
        n_valid = int(n_valid)
    stages.pop("count", None)

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
        "peak_memory_gib": peak_gib,
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
