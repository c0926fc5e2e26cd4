#!/usr/bin/env python3
"""Smoke run of sad_tpu_torch on one CUDA card: build the kernels, check each
against its plain PyTorch version, and drive the RetinaNet serving path, the
joint SAD training step, Faster / Mask R-CNN serving and the Faster / Mask
R-CNN training step end to end.

    python3 chip_smoke.py [--seed 0] [--batch 8] [--groups 4] [--iters 10] [--warmup 3]

Run from the root of the repository, on a machine with one NVIDIA Hopper
card, nvcc and PyTorch built for CUDA. Inputs and weights are made from
--seed in memory; nothing is read from disk but the repository. Phases, one
line each (name, what was checked, time):

  env            card name and power limit (nvidia-smi), torch / CUDA
                 versions, TF32 switches, kernel build time
  nms_kernel     csrc/nms.cu (sort, IoU bitmask, sweep; the argmax loop for
                 problems over the sort's cap) against ops.nms.nms_multi_plain
                 on the card: idx and valid exactly equal on every case (ties,
                 -0.0 / +0.0 ties, invalid tails, K = max_out, every problem
                 over the cap, one of three over it); median times of both at
                 the RetinaNet decode shape (N=8, K=5000, max_out=100), the RPN
                 shape (N=40, K=1000, max_out=1000, thr 0.7), the training RPN
                 shape (N=40, K=2000, max_out=2000, thr 0.7), the R-CNN decode
                 shape (N=8, K=80000, max_out=100) and over the cap, each beside
                 the argmax loop's earlier time
  roi_align_kernel
                 csrc/roi_align.cu against the plain twin of ops/roi_align.py
                 on the card, float32 (within 1e-5 * max|ref| + 1e-6) and
                 bfloat16 (every element within one bf16 ulp, 2^-7 of the
                 larger magnitude): the box shape (R=8000, res 7) and the
                 mask shape (R=800, res 14) on the four levels of a batch of 8
                 800x1344 canvases at C=256, rois of every level; rois wholly
                 outside the map, zero-area rois, extreme aspect ratios, rois
                 on the last row and column, invalid slots, an odd R, C=64,
                 C=3 (no vector loads), a 1x2 top level, sr 1 and 3; median
                 times, bytes moved and the bound at both shapes
  roi_align_bwd_kernel
                 the backward gather of csrc/roi_align.cu against
                 multilevel_roi_align_bwd_plain on the card, through its
                 wrapper and through autograd (with a cotangent that is a
                 non-contiguous view), on the cases above plus rois over many
                 map tiles (the canvas on P5 and on P2) and 600 rois on one
                 cell; float32 within 1e-5 * max|ref| (1e-4 for the 600),
                 bfloat16 one ulp (2^-7 of the larger magnitude) more: the two
                 add in other orders, so they are not bit-equal, but two runs
                 of the kernel are; median times of both, and of the forward,
                 at the box shape (R=4096, res 7) and the mask shape (R=1024,
                 res 14) of the training step, beside the atomic scatter's
                 earlier time; bytes moved and the bound
  student_infer  R-50-FPN student config, random bf16 weights, a batch of
                 uint8 640x1024 canvases through make_inference_fn; output
                 shapes, finite boxes, classes in 1..80, NMS kernel launched,
                 and detections equal to a decode of the same per-level
                 outputs with the plain NMS on the card; imgs/s
  teacher_infer  the same for the R-101-FPN teacher config (the forward and
                 decode of pseudo-labelling)
  cls_loss_kernels
                 csrc/cls_losses.cu (forward and backward) against the plain
                 twin of ops/fused_losses.py on the card: the 5 flagship
                 levels at bs 8 with G=4, a row count that is no multiple of a
                 block, G=1, an ignored label that is a class, |x| > 90 (the
                 FLT_MIN clamp), beta=0.5, non-integer gammas, PowSum off,
                 C=20 (16-byte chunks), C=9 (the scalar instance), x and pt
                 4 bytes off a 16-byte boundary (the scalar instance; the
                 library refuses the 16-byte one), pt log-uniform in
                 1e-6..1e-3 (where PowSum's MUFU ex2/lg2 err most);
                 per-group sums within 1e-5 relative (summation order: the
                 kernel sums in double, the twin in float) and dx within
                 1e-5 * max|dx| (ulp-level differences of exp/log/pow), and
                 two runs of each kernel bit-equal; CUDA-event medians of
                 both kernels and of the twin at P3, beside the first
                 design's, and the bounds of every level
  cls_loss_levels
                 after the main paths (and last with --only): the device
                 time of both kernels at every level from torch.profiler,
                 beside its bound
  joint_step     the R-50 student and the frozen R-101 teacher at full width,
                 --groups x 2 images on the 640x1024 canvas, bf16 compute,
                 LR 1e-6: one step with the kernels and one with the plain
                 twin from the same state (metrics within 1e-5 relative, the
                 gradients of the 5 levels' cls logits within 1e-5 * max),
                 then warm-up + timed steps: finite losses, every trainable
                 tensor updated (non-zero momentum) and at least 90 % of them
                 changed, frozen tensors and the teacher bit-identical,
                 5 + 5 kernel launches a step, one of each at each level's
                 shape; imgs/s

  faster_rcnn_infer, mask_rcnn_infer
                 the two R-50-FPN R-CNN configs, random bf16 weights with the
                 output layers rescaled (tools/profile_infer.spread_rcnn_
                 outputs), a batch of uint8 800x1344 canvases through
                 make_rcnn_inference_fn: shapes, finite boxes, classes in
                 1..80, the RPN fills its 1000 slots, at least 50 of an
                 image's 100 slots valid, mask probabilities in [0, 1];
                 detections (and masks) equal to a run of the same model with
                 the plain NMS and plain RoIAlign in place of the kernels;
                 2 NMS launches and 1 (Faster) or 2 (Mask) RoIAlign launches
                 a batch; imgs/s

  faster_rcnn_train, mask_rcnn_train
                 the training step of the same two configs at full width and
                 depth, --groups x 2 images on the 800x1344 canvas, bf16
                 compute, float32 parameters, LR 1e-6
                 (tools/profile_train.seeded_rcnn_train_step): from one state
                 and one set of sampler uniforms a step with the kernels and
                 a step with the plain NMS and plain RoIAlign (forward and
                 backward) in their place, metrics within 1e-4 relative; the
                 gradients each RoIAlign backward hands to the FPN outputs
                 within one bf16 ulp + 1e-5 * max; the backward kernel timed
                 on the rois the step sampled; then warm-up + timed steps:
                 finite losses, loss_mask for Mask R-CNN, every trainable
                 tensor updated, frozen tensors bit-identical, at least one
                 fg roi an image, and a step's launches: NMS 1, RoIAlign
                 forward 1 (Faster) or 3 (Mask: box, mask, and the mask
                 target crop, which carries no gradient), backward 1 or 2;
                 imgs/s, peak memory

Then a JSON line with every kernel of the paths, the card's name and power
limit, and as the last line {"ok": true, "device": {...}}. Any failure
raises and the exit code is not 0; without a CUDA card the script exits 2
and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
STUDENT_CFG = "sad_tpu_torch/configs/retinanet_R-50-FPN_student.yaml"
TEACHER_CFG = "sad_tpu_torch/configs/retinanet_R-101-FPN_teacher.yaml"
FASTER_CFG = "sad_tpu_torch/configs/e2e_faster_rcnn_R-50-FPN.yaml"
MASK_CFG = "sad_tpu_torch/configs/e2e_mask_rcnn_R-50-FPN.yaml"
# N problems, K candidates, max_out, threshold
DECODE_SHAPE = (8, 5000, 100, 0.5)  # RetinaNet decode: 8 images, 5 levels x 1000
RPN_SHAPE = (40, 1000, 1000, 0.7)  # R-CNN proposals: 5 levels x 8 images
RCNN_DECODE_SHAPE = (8, 80000, 100, 0.5)  # R-CNN decode: 1000 rois x 80 classes
RPN_TRAIN_SHAPE = (40, 2000, 2000, 0.7)  # R-CNN training proposals: 5 levels x 8 images
RCNN_CANVAS = (800, 1344)
# the card times of the kernels before their redesign (PERF.md section 6, rows #2
# and #8; NVIDIA H100 80GB HBM3, 700.00 W), printed beside the new medians
NMS_EARLIER_MS = {"decode": 0.3069, "rpn": 1.2370, "rpn_train": 3.2288, "rcnn_decode": 3.4746}
ROI_BWD_EARLIER_MS = {"box": 3.0123, "mask": 2.9818}


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
              all_invalid_rows=(), invalid_tail_rows=None, valid_share=None, signed_zeros=False):
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
    if invalid_tail_rows is not None:
        rows, start = invalid_tail_rows
        scores[list(rows), start:] = np.float32(-1e30)
    if valid_share is not None:
        scores[rng.uniform(size=(n, k)) > valid_share] = np.float32(-1e30)
    if signed_zeros:  # exact +0.0 and -0.0 among negative and positive scores
        scores -= np.float32(0.5)
        pick = rng.uniform(size=(n, k))
        scores[pick < 0.25] = np.float32(0.0)
        scores[pick > 0.75] = np.float32(-0.0)
    dev = "cuda"
    return torch.from_numpy(boxes).to(dev), torch.from_numpy(scores).to(dev)


def _nms_bound(n, k, max_out, valid):
    """NMS on this run's data: each problem takes one step per kept box (and
    one more that finds nothing live, unless max_out came first), each step
    an IoU (~15 operations) per candidate; bytes: boxes and scores read once,
    idx and valid written once."""
    steps = int(valid.sum()) + int((~valid.all(dim=1)).sum())
    return bound(n * k * 20 + n * max_out * 5, 15 * k * steps)


def phase_nms(torch, rng, iters, warmup):
    from sad_tpu_torch.ops import nms, nms_kernel

    t0 = time.perf_counter()
    n, k, max_out, thr = DECODE_SHAPE
    rn, rk, rmax, rthr = RPN_SHAPE
    dn, dk, dmax, dthr = RCNN_DECODE_SHAPE
    tn, tk, tmax, tthr = RPN_TRAIN_SHAPE
    cases = {
        "decode N=8 K=5000 thr=0.5": (_nms_case(torch, rng, n, k, invalid_from=4600), thr, max_out),
        # a level's 1000 candidates of one image; the last 8 problems are the
        # coarsest level's, 819 anchors padded to K with NEG_INF
        "rpn N=40 K=1000 max_out=1000 thr=0.7": (
            _nms_case(torch, rng, rn, rk, clusters=200,
                      invalid_tail_rows=(range(32, 40), 819)), rthr, rmax),
        # the training step's proposals: 2000 candidates a level and image
        "rpn train N=40 K=2000 max_out=2000 thr=0.7": (
            _nms_case(torch, rng, tn, tk, clusters=400,
                      invalid_tail_rows=(range(32, 40), 819)), tthr, tmax),
        # 1000 rois x 80 classes, class-offset boxes, ~3 % over SCORE_THRESH
        "rcnn decode N=8 K=80000 thr=0.5": (
            _nms_case(torch, rng, dn, dk, clusters=400, valid_share=0.03), dthr, dmax),
        "N=1 (nms_fixed)": (_nms_case(torch, rng, 1, 3000), 0.5, max_out),
        "K=1500 not a multiple of 1024, thr=0.3": (_nms_case(torch, rng, 3, 1500), 0.3, max_out),
        "invalid tail from 2000, thr=0.7": (_nms_case(torch, rng, 4, 5000, invalid_from=2000), 0.7, max_out),
        "all-invalid problem": (_nms_case(torch, rng, 3, 700, all_invalid_rows=(1,)), 0.5, max_out),
        "fewer valid than max_out": (_nms_case(torch, rng, 2, 300, invalid_from=40), 0.5, max_out),
        "exact score ties": (_nms_case(torch, rng, 8, 5000, tie_step=0.05), 0.5, max_out),
        "-0.0 / +0.0 ties": (_nms_case(torch, rng, 4, 3000, signed_zeros=True), 0.5, 300),
        "K = max_out = 1500, thr 0.7": (_nms_case(torch, rng, 6, 1500, clusters=150), 0.7, 1500),
        # more valid candidates than the order stage sorts: the argmax loop
        "K=20000, all valid: every problem over the sort's cap": (
            _nms_case(torch, rng, 2, 20000, clusters=300), 0.5, max_out),
        "one problem over the cap, two under": (
            _nms_case(torch, rng, 3, 10000, clusters=300, invalid_tail_rows=((1, 2), 3000)),
            0.5, max_out),
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
    stats, said = {}, []
    for key, name, plain_iters in (("decode", "decode N=8 K=5000 thr=0.5", iters),
                                   ("rpn", "rpn N=40 K=1000 max_out=1000 thr=0.7", 3),
                                   ("rpn_train", "rpn train N=40 K=2000 max_out=2000 thr=0.7", 2),
                                   ("rcnn_decode", "rcnn decode N=8 K=80000 thr=0.5", iters),
                                   ("over_cap", "K=20000, all valid: every problem over the "
                                    "sort's cap", 1)):
        (boxes, scores), t, m = cases[name]
        ms = _median_ms(torch, lambda: nms_kernel.nms_cuda(boxes, scores, t, m), iters * 5, warmup)
        plain_ms = _median_ms(torch, lambda: nms.nms_multi_plain(boxes, scores, t, m),
                              plain_iters, 1)
        _, valid = nms_kernel.nms_cuda(boxes, scores, t, m)
        b = _nms_bound(*scores.shape, m, valid)
        stats[key] = {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, **b}
        earlier = f" (argmax loop of PERF.md row #2: {NMS_EARLIER_MS[key]} ms)" if (
            key in NMS_EARLIER_MS) else ""
        said.append(f"{name}: kernel {ms:.4f} ms{earlier}, plain {plain_ms:.4f} ms, bound "
                    f"{b['bound_ms']:.4f} ms by {b['bound_by']}, {int(valid.sum())} kept")
    _phase("nms_kernel", f"{len(cases)} cases, idx and valid exactly equal to the plain "
           f"version; medians: " + "; ".join(said), time.perf_counter() - t0)
    return stats


# H100 SXM data sheet: HBM rate and float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# float32 operations an element of the cls-loss kernels, counted from the
# source: two expf and one logf (~20 each with their range reduction), one
# IEEE division (~10), ~30 multiplies/adds for the terms and the masks, and
# for PowSum log2f, exp2f and a multiply (~10); the backward adds ~20
# multiplies/adds
CLS_FWD_OPS, CLS_FWD_POW_OPS, CLS_BWD_OPS = 100, 10, 120
# flagship per-level grids (640x1024 canvas, strides 8..128), A = 9, C = 80
LEVEL_HW = {3: (80, 128), 4: (40, 64), 5: (20, 32), 6: (10, 16), 7: (5, 8)}
# the card times of the cls-loss kernels at P3 of a bs 8 step before their
# redesign (PERF.md section 6, rows #3 and #5; NVIDIA H100 80GB HBM3, 700.00 W)
CLS_EARLIER_MS = {"fwd": 0.7658, "bwd": 0.6720}


def bound(bytes_moved: float, ops: float) -> dict:
    """The least time of a piece of work on the H100: bytes over the memory
    rate or operations over the float32 rate, whichever is larger."""
    by_bytes, by_ops = bytes_moved / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def _cls_case(torch, gen, rows, groups, x_scale=3.0, clamp_rows=0, c=80, offset=0,
              pt_near_zero=False):
    """x, pt (rows, c) float32, labels (rows,) int32 in -1..c, cotangents (G,);
    offset > 0 makes x and pt views that start `offset` floats into their
    buffers (4 * offset bytes off a 16-byte boundary); pt is uniform in
    [0.001, 0.999], or log-uniform in [1e-6, 1e-3] with pt_near_zero (a
    trained teacher's background probabilities)."""
    x = torch.randn((rows * c + offset,), generator=gen, device="cuda")[offset:].view(rows, c)
    x.mul_(x_scale)
    if clamp_rows:
        x[:clamp_rows] = x[:clamp_rows].sign() * (90.0 + 10.0 * x[:clamp_rows].abs())
    pt = torch.rand((rows * c + offset,), generator=gen, device="cuda")[offset:].view(rows, c)
    if pt_near_zero:
        pt.mul_(3.0 * np.log(10.0)).exp_().mul_(1e-6)
    else:
        pt.mul_(0.998).add_(0.001)
    labels = torch.randint(-1, c + 1, (rows,), generator=gen, device="cuda", dtype=torch.int32)
    gf = torch.rand((groups,), generator=gen, device="cuda") + 0.5
    gd = torch.rand((groups,), generator=gen, device="cuda") + 0.5
    return x, pt, labels, gf, gd


def _cls_bounds(rows, c, groups):
    """The forward's and the backward's bounds with PowSum on: each input read
    once (x, pt, labels; the backward's cotangents), each output written once."""
    n = rows * c
    return (bound(8 * n + 4 * rows + 12 * groups, (CLS_FWD_OPS + CLS_FWD_POW_OPS) * n),
            bound(12 * n + 4 * rows + 8 * groups, CLS_BWD_OPS * n))


def phase_cls_losses(torch, seed, batch, groups, iters, warmup):
    from sad_tpu_torch.ops import cls_loss_kernel as K
    from sad_tpu_torch.ops.fused_losses import cls_losses_bwd_plain, cls_losses_fwd_plain

    t0 = time.perf_counter()
    flag = K.ClsLossParams(2.0, 0.25, 2.0, 0.5, 0.0, -1, 1.8, True)  # the flagship config
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = 9
    # name: rows, G, params, _cls_case keywords, the instance's vec width
    level_of = {f"P{l} bs{batch} G={groups}": l for l in LEVEL_HW}
    cases = {name: (batch * LEVEL_HW[l][0] * LEVEL_HW[l][1] * a, groups, flag, {}, 4)
             for name, l in level_of.items()}
    cases.update({
        "rows not a multiple of a block, G=3": (3 * 1013, 3, flag, {}, 4),
        "G=1": (4099, 1, flag, {}, 4),
        "IGNORED_LABEL=5 (a class)": (2 * 3001, 2, flag._replace(ignored_label=5), {}, 4),
        "|x| > 90 (FLT_MIN clamp)": (4 * 2000, 4, flag, {"x_scale": 30.0, "clamp_rows": 4000}, 4),
        "beta=0.5": (2 * 5000, 2, flag._replace(beta_d=0.5), {}, 4),
        "gamma_f=1.5 gamma_d=2.5": (2 * 5000, 2, flag._replace(gamma_f=1.5, gamma_d=2.5), {}, 4),
        "PowSum off": (2 * 5000, 2, flag._replace(want_powsum=False), {}, 4),
        "C=20 (16-byte chunks)": (2 * 4001, 2, flag, {"c": 20}, 4),
        "C=9 (scalar instance)": (3 * 1001, 3, flag, {"c": 9}, 1),
        "x, pt 4 bytes off a 16-byte boundary": (2 * 3001, 2, flag, {"offset": 1}, 1),
        "pt log-uniform in 1e-6..1e-3": (2 * 5000, 2, flag, {"pt_near_zero": True}, 4),
    })
    fwd_err = bwd_err = 0.0
    levels, rels = [], {}
    for name, (rows, g, p, kw, vec) in cases.items():
        x, pt, labels, gf, gd = _cls_case(torch, gen, rows, g, **kw)
        got_vec = K.kernel_instance(x.shape[1], x.data_ptr(), pt.data_ptr(), p)[0]
        if got_vec != vec:
            raise AssertionError(f"cls losses {name!r}: instance of width {got_vec}, want {vec}")
        sums = K.cls_losses_fwd(x, pt, labels, g, p)
        ref = cls_losses_fwd_plain(x, pt, labels, g, p)
        dx = K.cls_losses_bwd(x, pt, labels, gf, gd, p)
        dref = cls_losses_bwd_plain(x, pt, labels, gf, gd, p)
        again = (K.cls_losses_fwd(x, pt, labels, g, p), K.cls_losses_bwd(x, pt, labels, gf, gd, p))
        torch.cuda.synchronize()
        if not (bool(torch.isfinite(ref).all()) and bool(torch.isfinite(dref).all())):
            raise AssertionError(f"cls losses {name!r}: the plain twin is not finite")
        rel = float(((sums - ref).abs() / ref.abs().clamp_min(1e-30)).max())
        if not p.want_powsum and bool(sums[:, 2].any()):
            raise AssertionError(f"cls losses {name!r}: PowSum off but the kernel wrote one")
        drel = float((dx - dref).abs().max() / dref.abs().max())
        rels[name] = (rel, drel)
        if not rel <= 1e-5 or not drel <= 1e-5:
            raise AssertionError(f"cls losses {name!r}: sums rel err {rel:.3e}, dx err "
                                 f"{drel:.3e} of max|dx| (limits 1e-5)")
        if not (torch.equal(sums, again[0]) and torch.equal(dx, again[1])):
            raise AssertionError(f"cls losses {name!r}: two runs of the kernels differ")
        if kw.get("offset"):  # the library refuses 16-byte chunks of an unaligned x
            before = (K.fwd_launches, K.bwd_launches)
            for launch in (lambda: K._launch_fwd(x, pt, labels, g, p, 4, K.GAMMA2_POW),
                           lambda: K._launch_bwd(x, pt, labels, gf, gd, p, 4, K.GAMMA2_POW)):
                try:
                    launch()
                except RuntimeError:
                    continue
                raise AssertionError(f"cls losses {name!r}: the 16-byte instance launched")
            if (K.fwd_launches, K.bwd_launches) != before:
                raise AssertionError(f"cls losses {name!r}: a refused launch was counted")
        fwd_err = max(fwd_err, float((sums - ref).abs().max()))
        bwd_err = max(bwd_err, float((dx - dref).abs().max()))
        if name in level_of:  # a flagship level: its bounds; P3 timed here
            level = level_of[name]
            b_fwd, b_bwd = _cls_bounds(rows, x.shape[1], g)
            levels.append({"level": level, "rows": rows, "fwd_bound_ms": b_fwd["bound_ms"],
                           "bwd_bound_ms": b_bwd["bound_ms"]})
            if level == 3:
                ms_fwd = _median_ms(torch, lambda: K.cls_losses_fwd(x, pt, labels, g, p),
                                    iters * 5, warmup)
                ms_bwd = _median_ms(torch, lambda: K.cls_losses_bwd(x, pt, labels, gf, gd, p),
                                    iters * 5, warmup)
                plain_fwd = _median_ms(torch, lambda: cls_losses_fwd_plain(x, pt, labels, g, p),
                                       iters, warmup)
                plain_bwd = _median_ms(
                    torch, lambda: cls_losses_bwd_plain(x, pt, labels, gf, gd, p), iters, warmup)
                p3 = (rows, ms_fwd, ms_bwd, plain_fwd, plain_bwd, b_fwd, b_bwd)
        del x, pt, labels, sums, ref, dx, dref, again

    rows, ms_fwd, ms_bwd, plain_fwd, plain_bwd, b_fwd, b_bwd = p3
    worst = max(rels, key=lambda k: rels[k][0])
    near0 = rels["pt log-uniform in 1e-6..1e-3"]
    _phase("cls_loss_kernels", f"{len(cases)} cases, sums within 1e-5 relative and dx within "
           f"1e-5 * max|dx| of the plain twin (worst sums {rels[worst][0]:.2e} at {worst!r}, "
           f"dx {max(v[1] for v in rels.values()):.2e}; pt near 0: sums {near0[0]:.2e}, dx "
           f"{near0[1]:.2e}), two runs bit-equal; P3 bs{batch} ({rows} rows x "
           f"80, G={groups}): fwd kernel {ms_fwd:.4f} ms (before the redesign "
           f"{CLS_EARLIER_MS['fwd']}; plain {plain_fwd:.4f}, bound {b_fwd['bound_ms']:.4f}), "
           f"bwd kernel {ms_bwd:.4f} ms (before {CLS_EARLIER_MS['bwd']}; plain "
           f"{plain_bwd:.4f}, bound {b_bwd['bound_ms']:.4f}) (CUDA-event medians of "
           f"{iters * 5})", time.perf_counter() - t0)
    per_level = lambda k: [{"level": v["level"], "rows": v["rows"],  # noqa: E731
                            "bound_ms": v[f"{k}_bound_ms"]} for v in levels]
    return ({"max_abs_err": fwd_err, "ms": ms_fwd, "plain_ms": plain_fwd, **b_fwd,
             "levels": per_level("fwd")},
            {"max_abs_err": bwd_err, "ms": ms_bwd, "plain_ms": plain_bwd, **b_bwd,
             "levels": per_level("bwd")})


def phase_cls_levels(torch, seed, batch, groups, iters, warmup, stats):
    """The cls-loss kernels' device time at every flagship level from
    torch.profiler, into stats' "levels" as "device_ms" (the level's only
    time: an event median there is mostly host time). Run after the main
    paths: with the
    profiler run before them, the host-bound training steps of the same
    process read slower (PERF.md section 6)."""
    from sad_tpu_torch.ops import cls_loss_kernel as K
    from sad_tpu_torch.tools.profile_infer import device_ms

    t0 = time.perf_counter()
    flag = K.ClsLossParams(2.0, 0.25, 2.0, 0.5, 0.0, -1, 1.8, True)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    said = []
    for i, (level, (h, w)) in enumerate(LEVEL_HW.items()):
        x, pt, labels, gf, gd = _cls_case(torch, gen, batch * h * w * 9, groups)
        by_kernel = device_ms(lambda: K.cls_losses_fwd(x, pt, labels, groups, flag), iters * 5,
                              warmup, "cls_losses")
        fwd = sum(by_kernel.values())
        sum_kernel = sum(v for k, v in by_kernel.items() if "cls_losses_sum" in k)
        bwd = sum(device_ms(lambda: K.cls_losses_bwd(x, pt, labels, gf, gd, flag), iters * 5,
                            warmup, "cls_losses_bwd").values())
        stats[0]["levels"][i]["device_ms"] = fwd
        stats[1]["levels"][i]["device_ms"] = bwd
        said.append(f"P{level}: fwd {fwd:.4f} (of which the sum kernel {sum_kernel:.4f}; bound "
                    f"{stats[0]['levels'][i]['bound_ms']:.4f}), bwd {bwd:.4f} (bound "
                    f"{stats[1]['levels'][i]['bound_ms']:.4f})")
        del x, pt, labels, gf, gd
    _phase("cls_loss_levels", "device ms a call (torch.profiler, mean of "
           f"{iters * 5}): " + "; ".join(said), time.perf_counter() - t0)


def _level_grads(torch, step, s_data, probs, batch):
    """Loss and the gradients of the total loss w.r.t. the 5 levels' cls
    logits, which isolates the loss kernels from cuDNN's backward."""
    out = step.forward(s_data)
    total, metrics = step.losses(out, probs, batch)
    logits = list(out["cls_logits"].values())
    return {k: v.detach() for k, v in metrics.items()}, torch.autograd.grad(total, logits)


def phase_joint_step(torch, seed, groups, iters, warmup):
    from sad_tpu_torch.ops import cls_loss_kernel
    from sad_tpu_torch.ops.fused_losses import fused_cls_losses_raw_plain
    from sad_tpu_torch.tools.profile_train import BENCH_LR, seeded_train_step
    from sad_tpu_torch.train import make_train_step
    from sad_tpu_torch.tools.profile_infer import wall_seconds

    t0 = time.perf_counter()
    run = seeded_train_step(seed=seed, n_groups=groups, device="cuda")
    if tuple(run.batch["data_u8"].shape) != (run.n_images, 640, 1024, 3):
        raise AssertionError(f"joint step canvas {tuple(run.batch['data_u8'].shape)}")
    step = run.step
    plain = make_train_step(run.student_cfg, run.student, run.teacher, n_groups=groups,
                            teacher_cfg=run.teacher_cfg, cls_losses=fused_cls_losses_raw_plain)

    # kernels vs plain twin from the same state: a whole step each, then the
    # gradients w.r.t. the cls logits of one forward each
    params = dict(run.student.named_parameters())
    snap = {n: p.detach().clone() for n, p in params.items()}
    vsnap = {n: v.clone() for n, v in run.state.velocity.items()}

    def restore():
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(snap[n])
            for n, v in run.state.velocity.items():
                v.copy_(vsnap[n])

    m_kernel = step(run.state, run.batch, BENCH_LR)
    restore()
    m_plain = plain(run.state, run.batch, BENCH_LR)
    restore()
    worst = max(float((m_kernel[k] - m_plain[k]).abs() / m_plain[k].abs().clamp_min(1e-30))
                for k in m_plain)
    if sorted(m_kernel) != sorted(m_plain) or not worst <= 1e-5:
        raise AssertionError(f"joint step metrics, kernels vs plain twin: worst rel err {worst:.3e}")
    s_data, t_data = step.inputs(run.batch)
    probs = step.teacher_probs(t_data)
    _, g_kernel = _level_grads(torch, step, s_data, probs, run.batch)
    _, g_plain = _level_grads(torch, plain, s_data, probs, run.batch)
    gworst = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(g_kernel, g_plain))
    if not gworst <= 1e-5:
        raise AssertionError(f"cls-logit gradients, kernels vs plain twin: {gworst:.3e} of max")
    del s_data, t_data, probs, g_kernel, g_plain

    # the main path: warm-up and timed steps
    t_mask = step.names
    frozen = {n: snap[n] for n in params if n not in set(t_mask)}
    teacher_snap = [p.detach().clone() for p in run.teacher.parameters()]
    losses = []
    cls_loss_kernel.fwd_launches = cls_loss_kernel.bwd_launches = 0
    cls_loss_kernel.fwd_by_rows, cls_loss_kernel.bwd_by_rows = {}, {}
    torch.cuda.reset_peak_memory_stats()
    times = wall_seconds(lambda: losses.append(step(run.state, run.batch, BENCH_LR)["loss"]),
                         iters, warmup)
    torch.cuda.synchronize()
    launches = (cls_loss_kernel.fwd_launches, cls_loss_kernel.bwd_launches)
    by_rows = (cls_loss_kernel.fwd_by_rows, cls_loss_kernel.bwd_by_rows)
    n_steps = iters + warmup
    if launches != (5 * n_steps, 5 * n_steps):
        raise AssertionError(f"cls-loss kernels launched {launches} times in {n_steps} "
                             f"steps, want 5 + 5 a step")
    # each level's (rows, 80) grid: one launch of each kernel a step
    level_rows = {lvl: run.n_images * h * w * 9 for lvl, (h, w) in LEVEL_HW.items()}
    per_level = {lvl: (by_rows[0].get(r, 0), by_rows[1].get(r, 0)) for lvl, r in level_rows.items()}
    if any(v != (n_steps, n_steps) for v in per_level.values()):
        raise AssertionError(f"cls-loss launches by level (fwd, bwd) {per_level} in {n_steps} "
                             f"steps, want one of each a level a step")
    vals = [float(v) for v in losses]
    if not all(np.isfinite(vals)):
        raise AssertionError(f"non-finite joint-step loss: {vals}")
    # every trainable tensor got a gradient (its momentum is not zero), and
    # the weights moved; at LR 1e-6 an update below half an ulp of its weight
    # rounds away in float32 (e.g. the cls bias at -4.6), so a few may not
    still = [n for n in t_mask if not bool(run.state.velocity[n].any())]
    if still:
        raise AssertionError(f"{len(still)} trainable tensors got no update, e.g. {still[:3]}")
    unchanged = [n for n in t_mask if torch.equal(params[n], snap[n])]
    if len(unchanged) > len(t_mask) // 10:
        raise AssertionError(f"{len(unchanged)} of {len(t_mask)} trainable tensors did not "
                             f"change, e.g. {unchanged[:3]}")
    moved = [n for n in frozen if not torch.equal(params[n], frozen[n])]
    if moved:
        raise AssertionError(f"frozen student tensors changed: {moved[:3]}")
    if not all(torch.equal(p, q) for p, q in zip(run.teacher.parameters(), teacher_snap)):
        raise AssertionError("the teacher's parameters changed")
    med = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2**30
    _phase("joint_step", f"R-50 student + R-101 teacher, {run.n_images}x640x1024 uint8, "
           f"G={groups}, bf16, LR {BENCH_LR}: metrics of a kernel step and a plain-twin step "
           f"within {worst:.2e} rel, cls-logit grads within {gworst:.2e} of max; {n_steps} "
           f"steps, loss {vals[0]:.4f} -> {vals[-1]:.4f}, all {len(t_mask)} trainable tensors "
           f"updated and {len(t_mask) - len(unchanged)} changed (unchanged: {unchanged}), "
           f"{len(frozen)} frozen and the teacher bit-identical, kernels launched "
           f"{launches[0]} fwd + {launches[1]} bwd (fwd, bwd by level: {per_level}); "
           f"{run.n_images / med:.2f} imgs/s, "
           f"{1000 * med:.3f} ms/step (median of {iters} after {warmup} warm-up), peak "
           f"{peak:.2f} GiB", time.perf_counter() - t0)
    return launches, per_level


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


def _rpn_like_rois(torch, rng, batch, per_im, canvas):
    """Image-major rois as an RPN at work makes them: log-uniform sizes from
    16 px to the canvas height, aspect ratios 1:3..3:1, anywhere on the
    canvas and clipped to it, 2 % of the slots invalid."""
    ch, cw = canvas
    r = batch * per_im
    size = np.exp(rng.uniform(np.log(16.0), np.log(float(ch)), r))
    ar = np.exp(rng.uniform(-np.log(3.0), np.log(3.0), r))
    w, h = size * np.sqrt(ar), size / np.sqrt(ar)
    cx, cy = rng.uniform(0, cw, r), rng.uniform(0, ch, r)
    boxes = np.stack([np.clip(cx - w / 2, 0, cw - 1), np.clip(cy - h / 2, 0, ch - 1),
                      np.clip(cx + w / 2, 0, cw - 1), np.clip(cy + h / 2, 0, ch - 1)], axis=1)
    rois = np.concatenate([np.repeat(np.arange(batch), per_im)[:, None], boxes], axis=1)
    valid = rng.uniform(size=r) > 0.02
    return (torch.from_numpy(rois.astype(np.float32)).cuda(), torch.from_numpy(valid).cuda())


def _edge_rois(torch, rng, batch, canvas, r):
    """rois that exercise the edge rules: wholly outside the map, zero area,
    1:60 and 60:1 aspect ratios, on the last row and column, negative
    extents, and random ones; a fifth of the slots invalid."""
    ch, cw = canvas
    xy = rng.uniform(0, [cw * 0.9, ch * 0.9], (r, 2))
    wh = np.exp(rng.uniform(np.log(2.0), np.log(ch * 0.9), (r, 2)))
    boxes = np.concatenate([xy, np.minimum(xy + wh, [cw - 1, ch - 1])], axis=1)
    special = [
        [-3.0 * cw, -2.0 * ch, -2.5 * cw, -1.5 * ch], [2.0 * cw, 2.0 * ch, 2.5 * cw, 2.2 * ch],
        [10.0, 10.0, 10.0, 10.0], [cw / 2, ch / 2, cw / 2, ch / 2 + 30],
        [5.0, 1.0, 9.0, ch - 2.0], [1.0, 5.0, cw - 2.0, 9.0],
        [cw - 20.0, ch - 12.0, cw - 1.0, ch - 1.0], [cw - 1.0, ch - 1.0, cw - 1.0, ch - 1.0],
        [0.0, 0.0, cw - 1.0, ch - 1.0], [30.0, 40.0, 20.0, 10.0],
        [-8.0, -8.0, 12.0, 12.0], [cw - 6.0, ch - 6.0, cw + 40.0, ch + 40.0],
    ]
    boxes[:len(special)] = special
    rois = np.concatenate([np.sort(rng.randint(0, batch, r))[:, None], boxes], axis=1)
    valid = rng.uniform(size=r) > 0.2
    valid[:len(special)] = True
    return (torch.from_numpy(rois.astype(np.float32)).cuda(), torch.from_numpy(valid).cuda())


def _roi_feats(torch, gen, batch, canvas, c, dtype, lvl_min=2, lvl_max=5):
    return {l: torch.randn((batch, max(canvas[0] >> l, 1), max(canvas[1] >> l, 1), c),
                           generator=gen, device="cuda").to(dtype)
            for l in range(lvl_min, lvl_max + 1)}


def _roi_align_bound(torch, feats, rois, levels, valid, res, sr):
    """RoIAlign on this run's data. Bytes: the output written once, every
    feature cell that a valid roi's samples touch read once, the rois, levels
    and valid flags read once. Operations: a multiply and an add per tap, 4
    taps a sample, sr x sr samples an output element."""
    from sad_tpu_torch.ops.roi_align import roi_geometry

    lvls = sorted(feats)
    b, c = feats[lvls[0]].shape[0], feats[lvls[0]].shape[-1]
    dims = [(feats[l].shape[1], feats[l].shape[2]) for l in lvls]
    li, bi, _, _, (ylo, yhi, wylo, wyhi), (xlo, xhi, wxlo, wxhi) = roi_geometry(
        dims, lvls[0], b, rois, levels, res, sr)
    r = rois.shape[0]
    # a sample outside [-1, n] has weight 0 on both taps and needs no cell
    y_in = ((wylo + wyhi) > 0).float().reshape(r, -1)
    x_in = ((wxlo + wxhi) > 0).float().reshape(r, -1)
    ylo, yhi, xlo, xhi = (t.reshape(r, -1) for t in (ylo, yhi, xlo, xhi))
    touched = 0
    for k, (h, w) in enumerate(dims):
        for img in range(b):
            sel = valid & (li == k) & (bi == img)
            n_sel = int(sel.sum())
            if n_sel == 0:
                continue
            rows = torch.zeros((n_sel, h), device="cuda")
            cols = torch.zeros((n_sel, w), device="cuda")
            rows.scatter_add_(1, ylo[sel], y_in[sel]).scatter_add_(1, yhi[sel], y_in[sel])
            cols.scatter_add_(1, xlo[sel], x_in[sel]).scatter_add_(1, xhi[sel], x_in[sel])
            touched += int((((rows > 0).float().T @ (cols > 0).float()) > 0).sum())
    esize = feats[lvls[0]].element_size()
    out_elems = r * res * res * c
    bytes_moved = out_elems * esize + touched * c * esize + r * (20 + 4 + 1)
    return bound(bytes_moved, 2 * 4 * sr * sr * out_elems), bytes_moved, touched


def _roi_align_check(torch, name, feats, rois, levels, valid, res, sr):
    """Kernel against plain twin on one case; returns max abs err."""
    from sad_tpu_torch.ops.roi_align import multilevel_roi_align, multilevel_roi_align_plain

    got = multilevel_roi_align(feats, rois, levels, valid, res, sr)
    ref = multilevel_roi_align_plain(feats, rois, levels, valid, res, sr)
    torch.cuda.synchronize()
    dtype = feats[min(feats)].dtype
    if got.dtype != dtype or got.shape != ref.shape or not bool(torch.isfinite(ref.float()).all()):
        raise AssertionError(f"roi_align {name!r}: dtype/shape/finite check failed")
    if bool(got[~valid].any()):
        raise AssertionError(f"roi_align {name!r}: an invalid roi is not all zeros")
    g, f = got.float(), ref.float()
    err = (g - f).abs()
    if dtype == torch.float32:
        limit = 1e-5 * float(f.abs().max()) + 1e-6
        bad = int((err > limit).sum())
    else:  # one bf16 ulp: 2^-7 of the larger magnitude
        bad = int((err > 2.0 ** -7 * torch.maximum(g.abs(), f.abs())).sum())
    if bad:
        raise AssertionError(f"roi_align {name!r} ({dtype}): {bad} of {err.numel()} elements "
                             f"beyond the tolerance, max abs err {float(err.max()):.3e}")
    return float(err.max()), float((g == f).float().mean())


def phase_roi_align(torch, seed, batch, iters, warmup):
    from sad_tpu_torch.ops import roi_align_kernel
    from sad_tpu_torch.ops.proposals import map_rois_to_fpn_levels
    from sad_tpu_torch.ops.roi_align import multilevel_roi_align, multilevel_roi_align_plain

    t0 = time.perf_counter()
    rng = np.random.RandomState(seed + 7)
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    n_cases, worst, stats, said = 0, 0.0, {}, []
    before = roi_align_kernel.launches

    # the two shapes of the main path, both dtypes; times at bf16, the path's dtype
    for dtype in (torch.float32, torch.bfloat16):
        feats = _roi_feats(torch, gen, batch, RCNN_CANVAS, 256, dtype)
        for key, per_im, res in (("box", 1000, 7), ("mask", 100, 14)):
            rois, valid = _rpn_like_rois(torch, rng, batch, per_im, RCNN_CANVAS)
            levels = map_rois_to_fpn_levels(rois[:, 1:], 2, 5)
            err, same = _roi_align_check(torch, f"{key} shape", feats, rois, levels, valid, res, 2)
            worst, n_cases = max(worst, err), n_cases + 1
            if dtype != torch.bfloat16:
                continue
            ms = _median_ms(torch, lambda: multilevel_roi_align(feats, rois, levels, valid, res, 2),
                            iters * 5, warmup)
            plain_ms = _median_ms(torch, lambda: multilevel_roi_align_plain(
                feats, rois, levels, valid, res, 2), iters, warmup)
            b, nbytes, touched = _roi_align_bound(torch, feats, rois, levels, valid, res, 2)
            counts = torch.bincount(levels[valid], minlength=6)[2:].tolist()
            if min(counts) == 0:
                raise AssertionError(f"roi_align {key} shape: a level got no roi: {counts}")
            stats[key] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b}
            said.append(f"{key} shape R={rois.shape[0]} res={res} bf16, rois per level P2..P5 "
                        f"{counts}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                        f"{nbytes / 1e6:.1f} MB ({touched} cells touched), bound "
                        f"{b['bound_ms']:.4f} ms by {b['bound_by']}, max abs err {err:.3e}, "
                        f"{100 * same:.3f} % of elements bit-equal")
        del feats

    # edge rules, odd sizes and the scalar-load path, both dtypes
    small = (256, 384)
    edge = [  # name, batch, canvas, C, R, res, sr, levels
        ("edge rois, C=64, R=37", 2, small, 64, 37, 7, 2, (2, 5)),
        ("edge rois, res 14", 2, small, 64, 53, 14, 2, (2, 5)),
        ("C=3: no vector loads", 3, small, 3, 29, 7, 2, (2, 5)),
        ("C=20 float32 vectors, bf16 scalars", 1, small, 20, 31, 7, 2, (2, 5)),
        ("1x2 top level", 1, (32, 64), 256, 16, 7, 2, (2, 5)),
        ("one level only", 2, small, 64, 23, 7, 2, (3, 3)),
        ("sr=1", 2, small, 64, 37, 7, 1, (2, 5)),
        ("sr=3", 2, small, 64, 37, 7, 3, (2, 5)),
    ]
    for name, b, canvas, c, r, res, sr, (lo, hi) in edge:
        rois, valid = _edge_rois(torch, rng, b, canvas, r)
        levels = map_rois_to_fpn_levels(rois[:, 1:], lo, hi)
        for dtype in (torch.float32, torch.bfloat16):
            feats = _roi_feats(torch, gen, b, canvas, c, dtype, lo, hi)
            if name == "1x2 top level" and tuple(feats[5].shape[1:3]) != (1, 2):
                raise AssertionError(f"top level is {tuple(feats[5].shape)}")
            err, _ = _roi_align_check(torch, name, feats, rois, levels, valid, res, sr)
            worst, n_cases = max(worst, err), n_cases + 1
    # all rois invalid: zeros, and the kernel still counts as launched
    feats = _roi_feats(torch, gen, 1, small, 64, torch.bfloat16)
    rois, valid = _edge_rois(torch, rng, 1, small, 19)
    out = multilevel_roi_align(feats, rois, map_rois_to_fpn_levels(rois[:, 1:], 2, 5),
                               torch.zeros_like(valid), 7, 2)
    if bool(out.any()):
        raise AssertionError("roi_align: all-invalid rois gave non-zero output")
    n_cases += 1
    launched = roi_align_kernel.launches - before
    _phase("roi_align_kernel", f"{n_cases} cases within tolerance of the plain twin (float32 "
           f"1e-5 * max|ref| + 1e-6; bfloat16 one ulp), worst abs err {worst:.3e}, "
           f"{launched} launches; medians: " + "; ".join(said), time.perf_counter() - t0)
    return stats


def _roi_align_bwd_bound(feats_hw, batch, c, esize, r, res, sr):
    """RoIAlign backward: the cotangent read once, every gradient map written
    once (it is dense: cells no roi touched are zeros that must be written),
    the rois, levels and valid flags read once; a multiply and an add per tap."""
    cells = batch * sum(h * w for h, w in feats_hw)
    elems = r * res * res * c
    bytes_moved = elems * esize + cells * c * esize + r * (20 + 4 + 1)
    return bound(bytes_moved, 2 * 4 * sr * sr * elems), bytes_moved


def _roi_align_bwd_check(torch, name, feats, rois, levels, valid, res, sr, gen, positive=False,
                         rel=1e-5):
    """Backward kernel against its plain version on one case, through the
    wrapper and through autograd; returns max abs err. ``positive`` (a
    cotangent without signs, so that nothing cancels) and a wider ``rel`` are
    for a cell that collects ~10^4 terms: both versions add them in float32
    in an order of their own, and the rounding of such a sum is ~1e-5 of it."""
    from sad_tpu_torch.ops import roi_align_kernel
    from sad_tpu_torch.ops.roi_align import multilevel_roi_align, multilevel_roi_align_bwd_plain

    lvls = sorted(feats)
    f0 = feats[lvls[0]]
    b, c, dtype = f0.shape[0], f0.shape[-1], f0.dtype
    hw = {l: tuple(feats[l].shape[1:3]) for l in lvls}
    g = torch.randn((rois.shape[0], res, res, c), generator=gen, device="cuda")
    g = (g.abs() if positive else g).to(dtype)
    got = roi_align_kernel.roi_align_bwd_cuda(g, [hw[l] for l in lvls], lvls[0], b, rois,
                                              levels, valid, sr)
    ref = multilevel_roi_align_bwd_plain(g, hw, b, rois, levels, valid, sr)
    leaves = {l: f.detach().requires_grad_(True) for l, f in feats.items()}
    out = multilevel_roi_align(leaves, rois, levels, valid, res, sr)
    # a cotangent that is a non-contiguous view, as autograd may hand over
    auto = torch.autograd.grad(out, [leaves[l] for l in lvls],
                               g.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3))
    torch.cuda.synchronize()
    ref_max = max(float(ref[l].float().abs().max()) for l in lvls)
    worst = 0.0
    for k, l in enumerate(lvls):
        for what, t in (("wrapper", got[k]), ("autograd", auto[k])):
            if t.dtype != dtype or t.shape != feats[l].shape:
                raise AssertionError(f"roi_align_bwd {name!r}: {what} P{l} is {t.dtype} "
                                     f"{tuple(t.shape)}")
            a, f = t.float(), ref[l].float()
            err = (a - f).abs()
            limit = rel * ref_max + 1e-30
            if dtype != torch.float32:  # one bf16 ulp after the single cast
                limit = limit + 2.0 ** -7 * torch.maximum(a.abs(), f.abs())
            bad = int((err > limit).sum())
            if bad or not bool(torch.isfinite(a).all()):
                raise AssertionError(
                    f"roi_align_bwd {name!r} ({dtype}, {what}, P{l}): {bad} of {err.numel()} "
                    f"elements beyond the tolerance, max abs err {float(err.max()):.3e}, "
                    f"max|ref| {ref_max:.3e}")
            worst = max(worst, float(err.max()))
    return worst


def phase_roi_align_bwd(torch, seed, batch, iters, warmup):
    from sad_tpu_torch.ops import roi_align_kernel
    from sad_tpu_torch.ops.proposals import map_rois_to_fpn_levels
    from sad_tpu_torch.ops.roi_align import (
        multilevel_roi_align, multilevel_roi_align_bwd_plain, multilevel_roi_align_plain,
    )

    t0 = time.perf_counter()
    rng = np.random.RandomState(seed + 11)
    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    n_cases, worst, stats, said = 0, 0.0, {}, []
    before = roi_align_kernel.bwd_launches

    # the two shapes of the training step, both dtypes; times at bf16, the step's dtype
    for dtype in (torch.float32, torch.bfloat16):
        feats = _roi_feats(torch, gen, batch, RCNN_CANVAS, 256, dtype)
        hw = {l: tuple(f.shape[1:3]) for l, f in feats.items()}
        for key, per_im, res in (("box", 512, 7), ("mask", 128, 14)):
            rois, valid = _rpn_like_rois(torch, rng, batch, per_im, RCNN_CANVAS)
            levels = map_rois_to_fpn_levels(rois[:, 1:], 2, 5)
            err = _roi_align_bwd_check(torch, f"{key} shape", feats, rois, levels, valid, res, 2,
                                       gen)
            worst, n_cases = max(worst, err), n_cases + 1
            ferr, _ = _roi_align_check(torch, f"{key} shape of the step", feats, rois, levels,
                                       valid, res, 2)
            if dtype != torch.bfloat16:
                continue
            fms = _median_ms(torch, lambda: multilevel_roi_align(feats, rois, levels, valid, res, 2),
                             iters * 3, warmup)
            fplain = _median_ms(torch, lambda: multilevel_roi_align_plain(
                feats, rois, levels, valid, res, 2), max(iters // 2, 2), 1)
            fb, _, _ = _roi_align_bound(torch, feats, rois, levels, valid, res, 2)
            stats[f"fwd_{key}"] = {"max_abs_err": ferr, "ms": fms, "plain_ms": fplain, **fb}
            said.append(f"forward at the {key} shape of the step: kernel {fms:.4f} ms, plain "
                        f"{fplain:.4f} ms, bound {fb['bound_ms']:.4f} ms")
            g = torch.randn((rois.shape[0], res, res, 256), generator=gen,
                            device="cuda").to(dtype)
            dims = [hw[l] for l in sorted(hw)]
            once = roi_align_kernel.roi_align_bwd_cuda(g, dims, 2, batch, rois, levels, valid, 2)
            again = roi_align_kernel.roi_align_bwd_cuda(g, dims, 2, batch, rois, levels, valid, 2)
            if not all(torch.equal(a, b) for a, b in zip(once, again)):
                raise AssertionError(f"roi_align_bwd {key} shape: two runs differ")
            del once, again
            ms = _median_ms(torch, lambda: roi_align_kernel.roi_align_bwd_cuda(
                g, dims, 2, batch, rois, levels, valid, 2), iters * 3, warmup)
            plain_ms = _median_ms(torch, lambda: multilevel_roi_align_bwd_plain(
                g, hw, batch, rois, levels, valid, 2), max(iters // 2, 2), 1)
            b, nbytes = _roi_align_bwd_bound(dims, batch, 256, g.element_size(), rois.shape[0],
                                             res, 2)
            stats[key] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b}
            said.append(f"{key} shape R={rois.shape[0]} res={res} bf16, spread rois: kernel "
                        f"{ms:.4f} ms (the atomic scatter of PERF.md row #8: "
                        f"{ROI_BWD_EARLIER_MS[key]} ms), plain {plain_ms:.4f} ms, "
                        f"{nbytes / 1e6:.1f} MB, bound {b['bound_ms']:.4f} ms by {b['bound_by']}, "
                        f"max abs err {err:.3e}, two runs bit-equal")
            del g
        del feats

    small = (256, 384)
    edge = [  # name, batch, canvas, C, R, res, sr, levels
        ("edge rois, C=64, R=37", 2, small, 64, 37, 7, 2, (2, 5)),
        ("edge rois, res 14", 2, small, 64, 53, 14, 2, (2, 5)),
        ("C=3: no vector loads", 3, small, 3, 29, 7, 2, (2, 5)),
        ("C=20 float32 vectors, bf16 scalars", 1, small, 20, 31, 7, 2, (2, 5)),
        ("1x2 top level", 1, (32, 64), 256, 16, 7, 2, (2, 5)),
        ("one level only", 2, small, 64, 23, 7, 2, (3, 3)),
        ("sr=1", 2, small, 64, 37, 7, 1, (2, 5)),
        ("sr=3", 2, small, 64, 37, 7, 3, (2, 5)),
    ]
    for name, b, canvas, c, r, res, sr, (lo, hi) in edge:
        rois, valid = _edge_rois(torch, rng, b, canvas, r)
        levels = map_rois_to_fpn_levels(rois[:, 1:], lo, hi)
        for dtype in (torch.float32, torch.bfloat16):
            feats = _roi_feats(torch, gen, b, canvas, c, dtype, lo, hi)
            err = _roi_align_bwd_check(torch, name, feats, rois, levels, valid, res, sr, gen)
            worst, n_cases = max(worst, err), n_cases + 1
    # rois that span many map tiles: the whole canvas on P5 (4 x 6 tiles) and on P2
    # (25 x 42), a quarter of it on P3, among spread rois, at the training canvas
    rois, valid = _rpn_like_rois(torch, rng, 2, 40, RCNN_CANVAS)
    ch, cw = RCNN_CANVAS
    big = [[0, 0, 0, cw - 1, ch - 1], [1, 0, 0, cw - 1, ch - 1], [0, 0, 0, cw - 1, ch - 1],
           [1, cw / 4, ch / 4, 3 * cw / 4, 3 * ch / 4]]
    rois[:4] = torch.tensor(big, device="cuda")
    valid[:4] = True
    levels = map_rois_to_fpn_levels(rois[:, 1:], 2, 5)
    levels[:4] = torch.tensor([5, 5, 2, 3], dtype=torch.int32, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        feats = _roi_feats(torch, gen, 2, RCNN_CANVAS, 256, dtype)
        for res in (7, 14):
            err = _roi_align_bwd_check(torch, f"rois over many tiles, res {res}", feats, rois,
                                       levels, valid, res, 2, gen)
            worst, n_cases = max(worst, err), n_cases + 1
        del feats
    # 600 rois on one and the same cell of P2: one tile's list holds all of them
    feats = _roi_feats(torch, gen, 2, small, 256, torch.float32)
    rois = torch.tensor([[1.0, 41.0, 61.0, 43.0, 62.5]], device="cuda").repeat(600, 1)
    valid = torch.ones(600, dtype=torch.bool, device="cuda")
    levels = torch.full((600,), 2, dtype=torch.int32, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        err = _roi_align_bwd_check(torch, "600 rois on one cell",
                                   {l: f.to(dtype) for l, f in feats.items()}, rois, levels,
                                   valid, 7, 2, gen, positive=True, rel=1e-4)
        worst, n_cases = max(worst, err), n_cases + 1
    # all rois invalid: zeros
    hw = [tuple(feats[l].shape[1:3]) for l in sorted(feats)]
    g = torch.randn((600, 7, 7, 256), generator=gen, device="cuda")
    zero = roi_align_kernel.roi_align_bwd_cuda(g, hw, 2, 2, rois, levels, ~valid, 2)
    if any(bool(z.any()) for z in zero):
        raise AssertionError("roi_align_bwd: all-invalid rois gave a non-zero gradient")
    n_cases += 1
    launched = roi_align_kernel.bwd_launches - before
    _phase("roi_align_bwd_kernel", f"{n_cases} cases, wrapper and autograd, within tolerance of "
           f"the plain version (float32 1e-5 * max|ref|, 1e-4 where 600 rois share a cell; bfloat16 "
           f"one ulp more; the two add in other orders, so not bit-equal), worst abs err "
           f"{worst:.3e}, {launched} launches; medians: " + "; ".join(said),
           time.perf_counter() - t0)
    return stats


@contextlib.contextmanager
def _plain_twins():
    """For a check only: the plain NMS and the plain RoIAlign, forward and
    backward, in place of the three CUDA wrappers, so that the same entry
    points run without a kernel."""
    from sad_tpu_torch.ops import nms, nms_kernel, roi_align, roi_align_kernel

    def plain_roi_align(feats, lvl_min, rois, levels, valid, res, sr):
        return roi_align.multilevel_roi_align_plain(
            {lvl_min + i: f for i, f in enumerate(feats)}, rois, levels, valid, res, sr)

    def plain_roi_align_bwd(grad_out, level_hw, lvl_min, batch, rois, levels, valid, sr):
        out = roi_align.multilevel_roi_align_bwd_plain(
            grad_out, {lvl_min + i: hw for i, hw in enumerate(level_hw)}, batch, rois, levels,
            valid, sr)
        return [out[l] for l in sorted(out)]

    k = roi_align_kernel
    saved = nms_kernel.nms_cuda, k.roi_align_fwd_cuda, k.roi_align_bwd_cuda
    nms_kernel.nms_cuda = nms.nms_multi_plain
    k.roi_align_fwd_cuda, k.roi_align_bwd_cuda = plain_roi_align, plain_roi_align_bwd
    try:
        yield
    finally:
        nms_kernel.nms_cuda, k.roi_align_fwd_cuda, k.roi_align_bwd_cuda = saved


def phase_rcnn_infer(torch, name, cfg_path, seed, batch, iters, warmup):
    from sad_tpu_torch.eval.inference import device_normalize
    from sad_tpu_torch.ops import nms_kernel, roi_align_kernel
    from sad_tpu_torch.tools.profile_infer import seeded_inference, wall_seconds

    t0 = time.perf_counter()
    cfg, model, infer, args = seeded_inference(os.path.join(REPO, cfg_path), seed, batch, "cuda")
    if tuple(args[0].shape) != (batch, *RCNN_CANVAS, 3):
        raise AssertionError(f"{name}: canvas {tuple(args[0].shape)}")
    dets = infer(*args)
    torch.cuda.synchronize()
    max_out, n_fg = cfg.TEST.DETECTIONS_PER_IM, cfg.MODEL.NUM_CLASSES - 1
    keys = ("boxes", "scores", "classes", "valid")
    for key in keys:
        want = (batch, max_out, 4) if key == "boxes" else (batch, max_out)
        if tuple(dets[key].shape) != want:
            raise AssertionError(f"{name}: {key} shape {tuple(dets[key].shape)} != {want}")
    valid = dets["valid"]
    if not bool(torch.isfinite(dets["boxes"]).all()) or not bool(torch.isfinite(dets["scores"]).all()):
        raise AssertionError(f"{name}: non-finite boxes or scores")
    cls = dets["classes"][valid]
    per_im = valid.sum(dim=1).tolist()
    if min(per_im) < max_out // 2 or int(cls.min()) < 1 or int(cls.max()) > n_fg:
        raise AssertionError(f"{name}: detections per image {per_im} (want >= {max_out // 2} "
                             f"each), classes outside 1..{n_fg}")
    with torch.inference_mode():
        out = model(device_normalize(cfg, args[0], args[3]), args[1])
    if not bool(out["roi_valid"].all()) or tuple(out["rois"].shape) != (
            batch, cfg.TEST.RPN_POST_NMS_TOP_N, 4):
        raise AssertionError(f"{name}: the RPN filled {out['roi_valid'].sum(dim=1).tolist()} of "
                             f"{cfg.TEST.RPN_POST_NMS_TOP_N} slots an image")
    roi_levels = torch.bincount(out["roi_levels"].reshape(-1), minlength=6)[2:].tolist()
    del out
    if cfg.MODEL.MASK_ON:
        keys += ("mask_prob",)
        m = cfg.MRCNN.RESOLUTION
        mp = dets["mask_prob"]
        if tuple(mp.shape) != (batch, max_out, m, m, cfg.MODEL.NUM_CLASSES) or not bool(
                ((mp >= 0) & (mp <= 1)).all()):
            raise AssertionError(f"{name}: mask_prob shape {tuple(mp.shape)} or values outside [0, 1]")

    # the same model and batch with the plain NMS and plain RoIAlign
    counts = nms_kernel.launches, roi_align_kernel.launches
    with _plain_twins():
        ref = infer(*args)
    torch.cuda.synchronize()
    if (nms_kernel.launches, roi_align_kernel.launches) != counts:
        raise AssertionError(f"{name}: the plain-twin run launched a kernel")
    for key in keys:
        if not torch.equal(dets[key], ref[key]):
            diff = (dets[key].float() - ref[key].float()).abs()
            raise AssertionError(f"{name}: {key} differs from the plain-twin run: "
                                 f"{int((diff > 0).sum())} entries, max {float(diff.max()):.3e}")
    del ref

    # the main path: counts set to 0 just before, read just after
    nms_kernel.launches = roi_align_kernel.launches = 0
    times = wall_seconds(lambda: infer(*args), iters, warmup)
    launches = nms_kernel.launches, roi_align_kernel.launches
    n_batches = iters + warmup
    want = (2 * n_batches, (2 if cfg.MODEL.MASK_ON else 1) * n_batches)
    if launches != want:
        raise AssertionError(f"{name}: {launches} NMS / RoIAlign launches in {n_batches} "
                             f"batches, want {want}")
    med = statistics.median(times)
    _phase(name, f"{cfg_path}: {batch}x{RCNN_CANVAS[0]}x{RCNN_CANVAS[1]} uint8, bf16; RPN filled "
           f"all {cfg.TEST.RPN_POST_NMS_TOP_N} slots (rois per level P2..P5 {roi_levels}), "
           f"detections per image {per_im}, classes in 1..{n_fg}, finite"
           + (", mask_prob in [0, 1]" if cfg.MODEL.MASK_ON else "")
           + f"; {', '.join(keys)} equal to the plain-twin run; {launches[0]} NMS and "
           f"{launches[1]} RoIAlign launches in {n_batches} batches; {batch / med:.2f} imgs/s, "
           f"{1000 * med / batch:.3f} ms/img (median of {iters} after {warmup} warm-up)",
           time.perf_counter() - t0)
    return {"imgs_per_s": batch / med, "nms_launches": launches[0],
            "roi_align_launches": launches[1], "mask": bool(cfg.MODEL.MASK_ON)}


def _kernel_counts():
    from sad_tpu_torch.ops import nms_kernel, roi_align_kernel

    return nms_kernel.launches, roi_align_kernel.launches, roi_align_kernel.bwd_launches


def _roi_branch_grads(torch, step, run, nchw, sampled):
    """The gradients of the box loss and, for Mask R-CNN, of the mask loss
    w.r.t. detached NHWC RoI levels: what each RoIAlign backward alone
    produces (their sum would round a second time in bf16)."""
    leaves = run.model.roi_features(
        {l: f.detach().permute(0, 2, 3, 1).requires_grad_(True) for l, f in nchw.items()})
    wrt = [leaves[l] for l in sorted(leaves)]
    grads = list(torch.autograd.grad(step.box_branch(leaves, sampled)[0], wrt))
    if run.cfg.MODEL.MASK_ON:
        grads += torch.autograd.grad(step.mask_branch(leaves, sampled, run.batch), wrt)
    return grads


def phase_rcnn_train(torch, name, cfg_path, seed, groups, iters, warmup):
    from sad_tpu_torch.models.rcnn import flat_rois
    from sad_tpu_torch.ops import nms_kernel, roi_align_kernel
    from sad_tpu_torch.ops.roi_align import multilevel_roi_align, multilevel_roi_align_plain
    from sad_tpu_torch.tools.profile_infer import wall_seconds
    from sad_tpu_torch.tools.profile_train import BENCH_LR, seeded_rcnn_train_step

    t0 = time.perf_counter()
    run = seeded_rcnn_train_step(os.path.join(REPO, cfg_path), seed=seed, n_groups=groups,
                                 device="cuda")
    cfg, step, batch = run.cfg, run.step, run.batch
    mask_on = bool(cfg.MODEL.MASK_ON)
    n = run.n_images
    if tuple(batch["data_u8"].shape) != (n, *RCNN_CANVAS, 3):
        raise AssertionError(f"{name}: canvas {tuple(batch['data_u8'].shape)}")
    params = dict(run.model.named_parameters())
    snap = {k: p.detach().clone() for k, p in params.items()}

    def restore():
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(snap[k])
            for v in run.state.velocity.values():
                v.zero_()

    # one step with the kernels and one with the plain versions, from the same
    # state and the same sampler uniforms
    p_all = cfg.TRAIN.RPN_POST_NMS_TOP_N + batch["gt_boxes"].shape[1]
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    uniforms = (torch.rand((n, p_all), generator=gen, device="cuda"),
                torch.rand((n, p_all), generator=gen, device="cuda"))
    m_kernel = step(run.state, batch, BENCH_LR, uniforms=uniforms)
    restore()
    counts = _kernel_counts()
    with _plain_twins():
        m_plain = step(run.state, batch, BENCH_LR, uniforms=uniforms)
    restore()
    torch.cuda.synchronize()
    if _kernel_counts() != counts:
        raise AssertionError(f"{name}: the plain step launched a kernel")
    worst = max(float((m_kernel[k] - m_plain[k]).abs() / m_plain[k].abs().clamp_min(1e-6))
                for k in m_plain)
    if sorted(m_kernel) != sorted(m_plain) or not worst <= 1e-4:
        raise AssertionError(f"{name}: metrics of the kernel step vs the plain step: worst "
                             f"rel err {worst:.3e} (limit 1e-4)")
    if mask_on != ("loss_mask" in m_kernel):
        raise AssertionError(f"{name}: loss_mask {'missing' if mask_on else 'present'}")

    # the gradients that the RoIAlign backward hands to the FPN outputs
    with torch.no_grad():
        nchw = step.backbone(step.inputs(batch))
        logits, deltas = run.model.rpn_outputs(nchw)
    boxes, valid = step.proposals(logits, deltas, batch)
    sampled = step.sample(boxes, valid, batch, uniforms)
    g_kernel = _roi_branch_grads(torch, step, run, nchw, sampled)
    with _plain_twins():
        g_plain = _roi_branch_grads(torch, step, run, nchw, sampled)
    torch.cuda.synchronize()
    ref_max = max(float(g.float().abs().max()) for g in g_plain)
    gworst = 0.0
    for a, b in zip(g_kernel, g_plain):
        a, b = a.float(), b.float()
        err = (a - b).abs()
        bad = int((err > 1e-5 * ref_max + 2.0 ** -7 * torch.maximum(a.abs(), b.abs())).sum())
        if bad or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{name}: {bad} FPN-output gradient elements beyond one bf16 "
                                 f"ulp + 1e-5 * max of the plain backward's")
        gworst = max(gworst, float(err.max()))
    fg_per_im = sampled["is_fg"].sum(dim=1).tolist()
    valid_per_im = sampled["valid"].sum(dim=1).tolist()
    proposals_per_im = valid.sum(dim=1).tolist()
    if min(fg_per_im) < 1:
        raise AssertionError(f"{name}: fg rois per image {fg_per_im}")
    rois5 = flat_rois(sampled["rois"])
    roi_levels = torch.bincount(step._roi_levels(rois5)[sampled["valid"].reshape(-1)],
                                minlength=6)[2:].tolist()

    # the backward kernel on the rois the step really sampled
    res_box, cap = cfg.FAST_RCNN.ROI_XFORM_RESOLUTION, step.mask_cap()
    dims = [tuple(nchw[l].shape[2:]) for l in range(2, 6)]
    c = nchw[2].shape[1]
    dtype = nchw[2].dtype
    own = []
    shapes = [("box", rois5, sampled["valid"].reshape(-1), res_box)]
    if mask_on:
        shapes.append(("mask", flat_rois(sampled["rois"][:, :cap]),
                       sampled["is_fg"][:, :cap].reshape(-1), cfg.MRCNN.ROI_XFORM_RESOLUTION))
    for key, r5, ok, res in shapes:
        r5 = r5.contiguous()
        lv = step._roi_levels(r5)
        g = torch.randn((r5.shape[0], res, res, c), generator=gen, device="cuda").to(dtype)
        ms = _median_ms(torch, lambda: roi_align_kernel.roi_align_bwd_cuda(
            g, dims, 2, n, r5, lv, ok, 2), iters * 2, warmup)
        own.append(f"{key} R={r5.shape[0]} ({int(ok.sum())} live) {ms:.4f} ms")
    target_stats = None
    if mask_on:
        # the target crop: the forward kernel over the (B * G, Hm, Wm, 1) rasters
        rast = batch["gt_mask_rasters"]
        bb, gg, hm, wm = rast.shape
        maps = {2: rast.reshape(bb * gg, hm, wm, 1).float().contiguous()}
        which = (torch.arange(bb, device="cuda")[:, None] * gg
                 + sampled["matched_gt"][:, :cap]).reshape(-1, 1).float()
        r5 = torch.cat([which, sampled["rois"][:, :cap].reshape(-1, 4)], dim=1).contiguous()
        lv = torch.full((r5.shape[0],), 2, dtype=torch.int32, device="cuda")
        ok = torch.ones((r5.shape[0],), dtype=torch.bool, device="cuda")
        res = cfg.MRCNN.RESOLUTION
        err, _ = _roi_align_check(torch, "mask target crop", maps, r5, lv, ok, res, 2)
        ms = _median_ms(torch, lambda: multilevel_roi_align(maps, r5, lv, ok, res, 2),
                        iters * 2, warmup)
        plain_ms = _median_ms(torch, lambda: multilevel_roi_align_plain(maps, r5, lv, ok, res, 2),
                              iters, warmup)
        b_, _, _ = _roi_align_bound(torch, maps, r5, lv, ok, res, 2)
        target_stats = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b_}
        own.append(f"mask target crop R={r5.shape[0]} res={res} C=1 over {bb * gg} rasters: "
                   f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_['bound_ms']:.4f} ms")
    del nchw, logits, deltas, g_kernel, g_plain, sampled

    # the main path: counts set to 0 just before, read just after
    frozen = {k: snap[k] for k in params if k not in set(step.names)}
    losses = []
    nms_kernel.launches = roi_align_kernel.launches = roi_align_kernel.bwd_launches = 0
    torch.cuda.reset_peak_memory_stats()
    times = wall_seconds(lambda: losses.append(step(run.state, batch, BENCH_LR)), iters, warmup)
    torch.cuda.synchronize()
    launches = _kernel_counts()
    n_steps = iters + warmup
    want = (n_steps, (3 if mask_on else 1) * n_steps, (2 if mask_on else 1) * n_steps)
    if launches != want:
        raise AssertionError(f"{name}: NMS / RoIAlign forward / backward launches {launches} in "
                             f"{n_steps} steps, want {want}")
    vals = {k: [float(m[k]) for m in losses] for k in losses[0]}
    if not all(np.isfinite(v).all() for v in vals.values()):
        raise AssertionError(f"{name}: non-finite metrics {vals}")
    still = [k for k in step.names if not bool(run.state.velocity[k].any())]
    if still:
        raise AssertionError(f"{name}: {len(still)} trainable tensors got no update, e.g. "
                             f"{still[:3]}")
    unchanged = [k for k in step.names if torch.equal(params[k], snap[k])]
    if len(unchanged) > len(step.names) // 10:
        raise AssertionError(f"{name}: {len(unchanged)} of {len(step.names)} trainable tensors "
                             f"did not change, e.g. {unchanged[:3]}")
    moved = [k for k in frozen if not torch.equal(params[k], frozen[k])]
    if moved:
        raise AssertionError(f"{name}: frozen tensors changed: {moved[:3]}")
    med = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2**30
    _phase(name, f"{cfg_path}: {n}x{RCNN_CANVAS[0]}x{RCNN_CANVAS[1]} uint8, G={groups}, bf16, LR "
           f"{BENCH_LR}; kernel step vs plain step from one state: metrics within {worst:.2e} "
           f"rel, FPN-output grads within tolerance (max abs diff {gworst:.3e} of max "
           f"{ref_max:.3e}); proposals per image {proposals_per_im}, sampled valid "
           f"{valid_per_im}, fg {fg_per_im}, rois per level P2..P5 {roi_levels}; backward "
           f"kernel on the step's own rois: " + "; ".join(own) + f"; {n_steps} steps, loss "
           f"{vals['loss'][0]:.4f} -> {vals['loss'][-1]:.4f}"
           + (f", loss_mask {vals['loss_mask'][-1]:.4f}" if mask_on else "")
           + f", all {len(step.names)} trainable tensors updated and "
           f"{len(step.names) - len(unchanged)} changed, {len(frozen)} frozen bit-identical; "
           f"launches NMS {launches[0]}, RoIAlign forward {launches[1]}"
           + (" (box, mask and the target crop)" if mask_on else "")
           + f", backward {launches[2]}; {n / med:.2f} imgs/s, {1000 * med:.3f} ms/step "
           f"(median of {iters} after {warmup} warm-up), peak {peak:.2f} GiB",
           time.perf_counter() - t0)
    return {"imgs_per_s": n / med, "launches": launches, "steps": n_steps,
            "target_stats": target_stats}


# phases that can be run alone with --only
PARTIAL = {
    "nms_kernel": lambda torch, a, rng: phase_nms(torch, rng, a.iters, a.warmup),
    "cls_loss_kernels": lambda torch, a, rng: phase_cls_losses(torch, a.seed, a.batch, a.groups,
                                                               a.iters, a.warmup),
    "joint_step": lambda torch, a, rng: phase_joint_step(torch, a.seed, a.groups, a.iters,
                                                         a.warmup),
    "roi_align_kernel": lambda torch, a, rng: phase_roi_align(torch, a.seed, a.batch, a.iters,
                                                              a.warmup),
    "roi_align_bwd_kernel": lambda torch, a, rng: phase_roi_align_bwd(torch, a.seed, a.batch,
                                                                      a.iters, a.warmup),
    "faster_rcnn_train": lambda torch, a, rng: phase_rcnn_train(
        torch, "faster_rcnn_train", FASTER_CFG, a.seed + 4, a.groups, a.iters, a.warmup),
    "mask_rcnn_train": lambda torch, a, rng: phase_rcnn_train(
        torch, "mask_rcnn_train", MASK_CFG, a.seed + 5, a.groups, a.iters, a.warmup),
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--groups", type=int, default=4, help="loss groups of 2 images, joint step")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--only", default="", help="comma-separated phases to run alone while "
                   "working on one (no result lines are printed): " + ", ".join(PARTIAL))
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
    from sad_tpu_torch.ops import _build, cls_loss_kernel, nms_kernel, roi_align_kernel

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
    if args.only:
        for name in args.only.split(","):
            out = PARTIAL[name](torch, args, rng)
            if name == "cls_loss_kernels":
                cls_stats = out
        if "cls_loss_kernels" in args.only.split(","):
            phase_cls_levels(torch, args.seed, args.batch, args.groups, args.iters, args.warmup,
                             cls_stats)
        print("partial run: no result")
        return 0
    nms_stats = phase_nms(torch, rng, args.iters, args.warmup)
    roi_stats = phase_roi_align(torch, args.seed, args.batch, args.iters, args.warmup)
    roi_bwd_stats = phase_roi_align_bwd(torch, args.seed, args.batch, args.iters, args.warmup)
    fwd_stats, bwd_stats = PARTIAL["cls_loss_kernels"](torch, args, rng)

    # the RetinaNet serving path: every count set to 0 just before it, read just after
    nms_kernel.launches = roi_align_kernel.launches = 0
    cls_loss_kernel.fwd_launches = cls_loss_kernel.bwd_launches = 0
    cls_loss_kernel.fwd_by_rows, cls_loss_kernel.bwd_by_rows = {}, {}
    phase_infer(torch, "student_infer", STUDENT_CFG, args.seed, args.batch,
                args.iters, args.warmup)
    phase_infer(torch, "teacher_infer", TEACHER_CFG, args.seed + 1, args.batch,
                args.iters, args.warmup)
    nms_launches = nms_kernel.launches
    # the training path: the counts are set to 0 inside, after its comparisons
    cls_launches, cls_by_level = PARTIAL["joint_step"](torch, args, rng)
    for i, stats in enumerate((fwd_stats, bwd_stats)):
        for lvl in stats["levels"]:
            lvl["launches"] = cls_by_level[lvl["level"]][i]
    # the R-CNN serving paths: the counts are set to 0 inside, after the comparisons
    faster = phase_rcnn_infer(torch, "faster_rcnn_infer", FASTER_CFG, args.seed + 2, args.batch,
                              args.iters, args.warmup)
    mask = phase_rcnn_infer(torch, "mask_rcnn_infer", MASK_CFG, args.seed + 3, args.batch,
                            args.iters, args.warmup)
    if nms_kernel.launches != mask["nms_launches"] or (
            roi_align_kernel.launches != mask["roi_align_launches"]):
        raise AssertionError("a kernel was launched after the R-CNN serving runs")
    rcnn_batches = (faster["nms_launches"] + mask["nms_launches"]) // 2
    # the R-CNN training steps: the counts are set to 0 inside, after the comparisons
    faster_t = PARTIAL["faster_rcnn_train"](torch, args, rng)
    mask_t = PARTIAL["mask_rcnn_train"](torch, args, rng)
    if _kernel_counts() != mask_t["launches"]:
        raise AssertionError("a kernel was launched after the last main-path run")
    phase_cls_levels(torch, args.seed, args.batch, args.groups, args.iters, args.warmup,
                     (fwd_stats, bwd_stats))
    train_steps = faster_t["steps"] + mask_t["steps"]

    nms_entry = {
        "route": "cuda",
        "source": "sad_tpu_torch/csrc/nms.cu",
        "replaces": "sad_tpu/ops/pallas_nms.py:45 (_nms_kernel) and :103 (_nms_kernel_batched)",
        "library_ms": None,
    }
    roi_entry = {
        "route": "cuda",
        "source": "sad_tpu_torch/csrc/roi_align.cu",
        "replaces": "sad_tpu/ops/pallas_roi_align.py:234 (_mlra_kernel)",
        "library_ms": None,
    }
    roi_bwd_entry = {
        "route": "cuda",
        "source": "sad_tpu_torch/csrc/roi_align.cu",
        "replaces": "sad_tpu/ops/pallas_roi_align.py:505 (_mlra_bwd_kernel)",
        "library_ms": None,
    }
    print(json.dumps({"kernels": [{
        # RetinaNet decode shape; launches of the two RetinaNet serving runs
        "name": "greedy_nms_sorted", "launches": nms_launches, **nms_stats["decode"], **nms_entry,
    }, {
        # one launch a batch of each R-CNN serving run, at each of the two shapes
        "name": "greedy_nms_sorted@rpn", "launches": rcnn_batches, **nms_stats["rpn"], **nms_entry,
    }, {
        "name": "greedy_nms_sorted@rcnn_decode", "launches": rcnn_batches,
        **nms_stats["rcnn_decode"], **nms_entry,
    }, {
        # box RoIAlign: one launch a batch of both R-CNN runs; mask: of the Mask R-CNN run
        "name": "roi_align_fwd@box", **roi_stats["box"], **roi_entry,
        "launches": faster["roi_align_launches"] + mask["roi_align_launches"] // 2,
    }, {
        "name": "roi_align_fwd@mask", **roi_stats["mask"], **roi_entry,
        "launches": mask["roi_align_launches"] // 2,
    }, {
        # the training steps: one NMS, one box RoIAlign pair a step of both families; the
        # mask pair and the mask target crop (forward only) a step of Mask R-CNN
        "name": "greedy_nms_sorted@rpn_train", "launches": train_steps,
        **nms_stats["rpn_train"], **nms_entry,
    }, {
        "name": "roi_align_fwd@box_train", "launches": train_steps,
        **roi_bwd_stats["fwd_box"], **roi_entry,
    }, {
        "name": "roi_align_fwd@mask_train", "launches": mask_t["steps"],
        **roi_bwd_stats["fwd_mask"], **roi_entry,
    }, {
        "name": "roi_align_fwd@mask_targets", "launches": mask_t["steps"],
        **mask_t["target_stats"], **roi_entry,
    }, {
        "name": "roi_align_bwd_gather@box", "launches": train_steps,
        **roi_bwd_stats["box"], **roi_bwd_entry,
    }, {
        "name": "roi_align_bwd_gather@mask", "launches": mask_t["steps"],
        **roi_bwd_stats["mask"], **roi_bwd_entry,
    }, {
        # P3's shape; "levels" holds every level's device time, bound and the launches
        # counted at that level's shape in the joint step
        "name": "cls_losses_fwd",
        "route": "cuda",
        "source": "sad_tpu_torch/csrc/cls_losses.cu",
        "replaces": "sad_tpu/ops/pallas_losses.py:152 (_fwd_kernel) and :284 (_fwd_kernel_aligned)",
        "launches": cls_launches[0],
        **fwd_stats, "library_ms": None,
    }, {
        "name": "cls_losses_bwd",
        "route": "cuda",
        "source": "sad_tpu_torch/csrc/cls_losses.cu",
        "replaces": "sad_tpu/ops/pallas_losses.py:214 (_bwd_kernel) and :320 (_bwd_kernel_aligned)",
        "launches": cls_launches[1],
        **bwd_stats, "library_ms": None,
    }]}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
