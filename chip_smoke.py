#!/usr/bin/env python3
"""Smoke run of sad_tpu_torch on one CUDA card: build the kernels, check each
against its plain PyTorch version, and drive the serving path and the joint
SAD training step end to end.

    python3 chip_smoke.py [--seed 0] [--batch 8] [--groups 4] [--iters 10] [--warmup 3]

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
  cls_loss_kernels
                 csrc/cls_losses.cu (forward and backward) against the plain
                 twin of ops/fused_losses.py on the card: the 5 flagship
                 levels at bs 8 with G=4, a row count that is no multiple of a
                 block, G=1, an ignored label that is a class, |x| > 90 (the
                 FLT_MIN clamp), beta=0.5, non-integer gammas, PowSum off;
                 per-group sums within 1e-5 relative (summation order: the
                 kernel sums in double, the twin in float) and dx within
                 1e-5 * max|dx| (ulp-level differences of exp/log/pow);
                 median times of both kernels and the twin at the P3 shape
  joint_step     the R-50 student and the frozen R-101 teacher at full width,
                 --groups x 2 images on the 640x1024 canvas, bf16 compute,
                 LR 1e-6: one step with the kernels and one with the plain
                 twin from the same state (metrics within 1e-5 relative, the
                 gradients of the 5 levels' cls logits within 1e-5 * max),
                 then warm-up + timed steps: finite losses, every trainable
                 tensor updated (non-zero momentum) and at least 90 % of them
                 changed, frozen tensors and the teacher bit-identical,
                 5 + 5 kernel launches a step; imgs/s

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


# H100 SXM data sheet: HBM rate and float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# float32 operations an element of the cls-loss kernels, counted from the
# source: two expf and one logf (~20 each with their range reduction), one
# IEEE division (~10), ~30 multiplies/adds for the terms and the masks, and
# for PowSum one powf (~40); the backward adds ~20 multiplies/adds
CLS_FWD_OPS, CLS_FWD_POW_OPS, CLS_BWD_OPS = 100, 40, 120
# flagship per-level grids (640x1024 canvas, strides 8..128), A = 9, C = 80
LEVEL_HW = {3: (80, 128), 4: (40, 64), 5: (20, 32), 6: (10, 16), 7: (5, 8)}


def bound(bytes_moved: float, ops: float) -> dict:
    """The least time of a piece of work on the H100: bytes over the memory
    rate or operations over the float32 rate, whichever is larger."""
    by_bytes, by_ops = bytes_moved / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def _cls_case(torch, gen, rows, groups, x_scale=3.0, clamp_rows=0):
    c = 80
    x = torch.randn((rows, c), generator=gen, device="cuda") * x_scale
    if clamp_rows:
        x[:clamp_rows] = x[:clamp_rows].sign() * (90.0 + 10.0 * x[:clamp_rows].abs())
    pt = torch.rand((rows, c), generator=gen, device="cuda") * 0.998 + 0.001
    labels = torch.randint(-1, c + 1, (rows,), generator=gen, device="cuda", dtype=torch.int32)
    gf = torch.rand((groups,), generator=gen, device="cuda") + 0.5
    gd = torch.rand((groups,), generator=gen, device="cuda") + 0.5
    return x, pt, labels, gf, gd


def phase_cls_losses(torch, seed, batch, groups, iters, warmup):
    from sad_tpu_torch.ops import cls_loss_kernel as K
    from sad_tpu_torch.ops.fused_losses import cls_losses_bwd_plain, cls_losses_fwd_plain

    t0 = time.perf_counter()
    flag = K.ClsLossParams(2.0, 0.25, 2.0, 0.5, 0.0, -1, 1.8, True)  # the flagship config
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = 9
    cases = {f"P{l} bs{batch} G={groups}": (batch * h * w * a, groups, flag, {})
             for l, (h, w) in LEVEL_HW.items()}
    cases.update({
        "rows not a multiple of a block, G=3": (3 * 1013, 3, flag, {}),
        "G=1": (4099, 1, flag, {}),
        "IGNORED_LABEL=5 (a class)": (2 * 3001, 2, flag._replace(ignored_label=5), {}),
        "|x| > 90 (FLT_MIN clamp)": (4 * 2000, 4, flag, {"x_scale": 30.0, "clamp_rows": 4000}),
        "beta=0.5": (2 * 5000, 2, flag._replace(beta_d=0.5), {}),
        "gamma_f=1.5 gamma_d=2.5": (2 * 5000, 2, flag._replace(gamma_f=1.5, gamma_d=2.5), {}),
        "PowSum off": (2 * 5000, 2, flag._replace(want_powsum=False), {}),
    })
    fwd_err = bwd_err = 0.0
    for name, (rows, g, p, kw) in cases.items():
        x, pt, labels, gf, gd = _cls_case(torch, gen, rows, g, **kw)
        sums = K.cls_losses_fwd(x, pt, labels, g, p)
        ref = cls_losses_fwd_plain(x, pt, labels, g, p)
        dx = K.cls_losses_bwd(x, pt, labels, gf, gd, p)
        dref = cls_losses_bwd_plain(x, pt, labels, gf, gd, p)
        torch.cuda.synchronize()
        if not (bool(torch.isfinite(ref).all()) and bool(torch.isfinite(dref).all())):
            raise AssertionError(f"cls losses {name!r}: the plain twin is not finite")
        rel = float(((sums - ref).abs() / ref.abs().clamp_min(1e-30)).max())
        if not p.want_powsum and bool(sums[:, 2].any()):
            raise AssertionError(f"cls losses {name!r}: PowSum off but the kernel wrote one")
        drel = float((dx - dref).abs().max() / dref.abs().max())
        if not rel <= 1e-5 or not drel <= 1e-5:
            raise AssertionError(f"cls losses {name!r}: sums rel err {rel:.3e}, dx err "
                                 f"{drel:.3e} of max|dx| (limits 1e-5)")
        fwd_err = max(fwd_err, float((sums - ref).abs().max()))
        bwd_err = max(bwd_err, float((dx - dref).abs().max()))
        del x, pt, labels, sums, ref, dx, dref

    rows = batch * LEVEL_HW[3][0] * LEVEL_HW[3][1] * a
    x, pt, labels, gf, gd = _cls_case(torch, gen, rows, groups)
    ms_fwd = _median_ms(torch, lambda: K.cls_losses_fwd(x, pt, labels, groups, flag), iters * 5, warmup)
    ms_bwd = _median_ms(torch, lambda: K.cls_losses_bwd(x, pt, labels, gf, gd, flag), iters * 5, warmup)
    plain_fwd = _median_ms(torch, lambda: cls_losses_fwd_plain(x, pt, labels, groups, flag), iters, warmup)
    plain_bwd = _median_ms(torch, lambda: cls_losses_bwd_plain(x, pt, labels, gf, gd, flag), iters, warmup)
    n = rows * 80
    b_fwd = bound(8 * n + 4 * rows + 12 * groups, (CLS_FWD_OPS + CLS_FWD_POW_OPS) * n)
    b_bwd = bound(12 * n + 4 * rows + 8 * groups, CLS_BWD_OPS * n)
    _phase("cls_loss_kernels", f"{len(cases)} cases, sums within 1e-5 relative and dx within "
           f"1e-5 * max|dx| of the plain twin; P3 bs{batch} ({rows} rows x 80, G={groups}): "
           f"fwd kernel {ms_fwd:.4f} ms (plain {plain_fwd:.4f}, bound {b_fwd['bound_ms']:.4f}), "
           f"bwd kernel {ms_bwd:.4f} ms (plain {plain_bwd:.4f}, bound {b_bwd['bound_ms']:.4f}) "
           f"(median)", time.perf_counter() - t0)
    return ({"max_abs_err": fwd_err, "ms": ms_fwd, "plain_ms": plain_fwd, **b_fwd},
            {"max_abs_err": bwd_err, "ms": ms_bwd, "plain_ms": plain_bwd, **b_bwd})


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
    torch.cuda.reset_peak_memory_stats()
    times = wall_seconds(lambda: losses.append(step(run.state, run.batch, BENCH_LR)["loss"]),
                         iters, warmup)
    torch.cuda.synchronize()
    launches = (cls_loss_kernel.fwd_launches, cls_loss_kernel.bwd_launches)
    n_steps = iters + warmup
    if launches != (5 * n_steps, 5 * n_steps):
        raise AssertionError(f"cls-loss kernels launched {launches} times in {n_steps} "
                             f"steps, want 5 + 5 a step")
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
           f"{launches[0]} fwd + {launches[1]} bwd; {run.n_images / med:.2f} imgs/s, "
           f"{1000 * med:.3f} ms/step (median of {iters} after {warmup} warm-up), peak "
           f"{peak:.2f} GiB", time.perf_counter() - t0)
    return launches


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
    p.add_argument("--groups", type=int, default=4, help="loss groups of 2 images, joint step")
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
    from sad_tpu_torch.ops import _build, cls_loss_kernel, nms_kernel

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
    fwd_stats, bwd_stats = phase_cls_losses(torch, args.seed, args.batch, args.groups,
                                            args.iters, args.warmup)

    # the serving path: every count set to 0 just before it, read just after
    nms_kernel.launches = cls_loss_kernel.fwd_launches = cls_loss_kernel.bwd_launches = 0
    phase_infer(torch, "student_infer", STUDENT_CFG, args.seed, args.batch,
                args.iters, args.warmup)
    phase_infer(torch, "teacher_infer", TEACHER_CFG, args.seed + 1, args.batch,
                args.iters, args.warmup)
    nms_launches = nms_kernel.launches
    # the training path: the counts are set to 0 inside, after its comparisons
    cls_launches = phase_joint_step(torch, args.seed, args.groups, args.iters, args.warmup)

    # NMS at the decode shape: 100 dependent steps over N*K candidates, each
    # an IoU (~15 operations) per live candidate; bytes: boxes and scores
    # read once, idx and valid written once
    n, k, max_out, _ = DECODE_SHAPE
    nms_bound = bound(n * k * 20 + n * max_out * 5, 15 * n * k * max_out)
    print(json.dumps({"kernels": [{
        "name": "greedy_nms",
        "route": "cuda",
        "source": "sad_tpu_torch/csrc/nms.cu",
        "replaces": "sad_tpu/ops/pallas_nms.py:45 (_nms_kernel) and :103 (_nms_kernel_batched)",
        "launches": nms_launches,
        **nms_stats, **nms_bound, "library_ms": None,
    }, {
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
