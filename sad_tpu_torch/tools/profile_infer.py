"""Where the time of batched inference goes, on the card.

    python -m sad_tpu_torch.tools.profile_infer --cfg sad_tpu_torch/configs/retinanet_R-50-FPN_student.yaml \
        [--batch 8] [--iters 20] [--seed 0] [--out profile_student.json]

``--cfg`` takes the RetinaNet configs and the two R-CNN ones
(``e2e_faster_rcnn_R-50-FPN.yaml``, ``e2e_mask_rcnn_R-50-FPN.yaml``). Seeded
random weights in the config's compute dtype and seeded uint8 canvases of the
config's landscape test canvas. Prints, and writes as JSON:
- imgs/s: median and quartiles of --iters timed batches (host clock around
  torch.cuda.synchronize(), profiler off);
- per-stage device ms (CUDA events, medians). RetinaNet: normalise, forward,
  decode before NMS, NMS, gather. R-CNN: normalise, backbone+FPN, RPN head,
  candidates, RPN NMS, collect, RoIAlign, box head, decode, detection NMS,
  gather, and with MODEL.MASK_ON mask RoIAlign and mask head;
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
(``spread_rcnn_outputs``): the detection NMS and the mask branch then work
on thousands of candidates an image, as they do with trained weights.
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
from sad_tpu_torch.eval.rcnn_inference import (
    decode_rcnn_candidates, make_rcnn_inference_fn, mask_roi_features, rcnn_gather_detections,
)
from sad_tpu_torch.eval.test_engine import _test_canvas_shapes
from sad_tpu_torch.models import compute_dtype, create_model
from sad_tpu_torch.ops.nms import batched_nms_multi
from sad_tpu_torch.ops.proposals import nms_levels_batched

_CATEGORIES = (
    ("nms_kernel", ("nms_order_kernel", "nms_mask_kernel", "nms_sweep_kernel",
                    "nms_argmax_kernel")),
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
def spread_rcnn_outputs(cfg, model, images, im_hw, content_hw) -> dict:
    """Rescale the weights and biases of the RPN's two output convs and the
    box head's two output layers so that their outputs on this batch have the
    stds of ``_SPREAD_STD``; the RPN first, because the box head sees the
    rois it makes. Returns the factors."""
    def rescale(layer, out, target):
        factor = target / float(out.float().std())
        layer.weight.mul_(factor)
        layer.bias.mul_(factor)
        return factor

    x = device_normalize(cfg, images, content_hw)
    feats = model._features(x)
    logits, deltas = model.rpn_outputs(feats)
    _, cls_name, bbox_name = model.rpn.names
    factors = {
        "rpn_cls": rescale(getattr(model.rpn, cls_name),
                           torch.cat([v.reshape(-1) for v in logits.values()]),
                           _SPREAD_STD["rpn_cls"]),
        "rpn_bbox": rescale(getattr(model.rpn, bbox_name),
                            torch.cat([v.reshape(-1) for v in deltas.values()]),
                            _SPREAD_STD["rpn_bbox"]),
    }
    out = model(x, im_hw)
    factors["cls_score"] = rescale(model.box_head.cls_score, out["cls_score"],
                                   _SPREAD_STD["cls_score"])
    factors["bbox_pred"] = rescale(model.box_head.bbox_pred, out["bbox_pred"],
                                   _SPREAD_STD["bbox_pred"])
    return factors


def is_rcnn(cfg) -> bool:
    return cfg.MODEL.TYPE == "generalized_rcnn"


def seeded_inference(cfg_path: str, seed: int, batch: int, device):
    """The config, its model with random weights from ``seed`` in the
    compute dtype (an R-CNN's output layers rescaled by
    ``spread_rcnn_outputs``), the inference function of it, and the arguments
    of one batch of seeded uint8 canvases of the config's landscape test
    canvas."""
    cfg = load_cfg(cfg_path)
    model = create_model(cfg, device, torch.Generator(device=device).manual_seed(seed))
    model.to(compute_dtype(cfg))
    (ch, cw), _ = _test_canvas_shapes(cfg)
    b = random_canvases(np.random.RandomState(seed), batch, (ch, cw), device)
    args = (b["data"], b["im_hw"], b["im_scale"], b["content_hw"])
    if is_rcnn(cfg):
        spread_rcnn_outputs(cfg, model, b["data"], b["im_hw"], b["content_hw"])
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
    """(name, fn) stages of one Faster / Mask R-CNN batch, the steps of
    GeneralizedRCNN.forward and make_rcnn_inference_fn one by one; the last,
    untimed in the report, returns the number of valid detection-NMS
    candidates."""
    data, im_hw, im_scale, content_hw = x
    st = {}

    def keep(key, value):
        st[key] = value
        return value

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
        ("rpn_head", lambda feats: model.rpn_outputs(feats)),
        ("candidates", lambda o: model.rpn_candidates(*o, im_hw)),
        ("rpn_nms", lambda pl: nms_levels_batched(pl, cfg.TEST.RPN_NMS_THRESH,
                                                  cfg.TEST.RPN_POST_NMS_TOP_N)),
        ("collect", lambda kept: model.collect(*kept)),
        ("roi_align", roi_align),
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


def device_ms(fn, iters: int, warmup: int, name: str = "") -> dict:
    """Device ms a call of each of fn's CUDA kernels whose names hold `name`,
    from torch.profiler over ``iters`` calls after ``warmup``: the kernels'
    own time, without the host's share that a CUDA-event interval around a
    small kernel holds. Raises if the profiler saw no such kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ms = {e.key: e.self_device_time_total / 1e3 / iters for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and name in e.key}
    if not sum(ms.values()) > 0:
        raise RuntimeError(f"the profiler saw no CUDA kernel named *{name}*")
    return ms


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
