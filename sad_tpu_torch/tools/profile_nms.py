"""Where the greedy-NMS kernels of csrc/nms.cu spend their time on the card.

    python -m sad_tpu_torch.tools.profile_nms [--iters 30] [--seed 0] \
        [--shapes decode,rpn,rpn_train,rcnn_decode,over_cap,ss_rpn_train,merge_160000] \
        [--out profile_nms.json]

At the main paths' shapes (N problems x K candidates -> max_out at thr), on
the clustered boxes of ``seeded_case`` (chip_smoke.py's ``[nms_kernel]`` draws
its cases from ``seeded_case`` and ``SHAPES`` too):
  decode        8 x 5000 -> 100, thr 0.5, 4600 valid: RetinaNet serving
  rpn           40 x 1000 -> 1000, thr 0.7: the FPN RPN
  rpn_train     40 x 2000 -> 2000, thr 0.7: the FPN training RPN
  rcnn_decode   8 x 80,000 -> 100, thr 0.5, ~3 % valid: the R-CNN decode
  over_cap      2 x 20,000 -> 100, thr 0.5, all valid: over the sort's cap
  ss_rpn_train  8 x 12,000 -> 2000, thr 0.7, all valid: the C4 / VGG16
                training RPN, over the sort's cap
  merge_160000  2 x 160,000 -> 100, thr 0.5, ~20,000 valid: 40 runs merged
it prints one JSON line a shape, and writes them all as JSON: the device ms a
call of each kernel (torch.profiler, ``profile_infer.device_ms``) and their
sum, the CUDA-event mean of a call queued behind a spin kernel
(``profile_infer.queued_ms``), the valid candidates a problem, the kept
boxes, and for the problems over the cap what the kept-list sweep walks: the
64-candidate tiles up to the max_out-th keep (or the end of the list) and
the (candidate, earlier kept box) pairs it may test there. ``nms_work``
counts the bytes and IoU tests that bound NMS on a case's data. It goes through ``nms_kernel.nms_cuda`` only, so it
times any version of the kernels: run it on another tree with
``PYTHONPATH=<tree> python <tree>/sad_tpu_torch/tools/profile_nms.py``.
Needs a CUDA card; raises without one.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from sad_tpu_torch.device import nvidia_smi_line
from sad_tpu_torch.ops import nms_kernel
from sad_tpu_torch.tools.profile_infer import device_ms, queued_ms

# name: (N, K, max_out, thr, the case's keywords); chip_smoke.py's [nms_kernel]
# times the same shapes
SHAPES = {
    "decode": (8, 5000, 100, 0.5, {"invalid_from": 4600}),
    # a level's 1000 candidates of one image; the last 8 problems are the
    # coarsest level's, 819 anchors padded to K with NEG_INF
    "rpn": (40, 1000, 1000, 0.7, {"clusters": 200, "invalid_tail_rows": (range(32, 40), 819)}),
    "rpn_train": (40, 2000, 2000, 0.7,
                  {"clusters": 400, "invalid_tail_rows": (range(32, 40), 819)}),
    # 1000 rois x 80 classes, ~3 % over SCORE_THRESH
    "rcnn_decode": (8, 80000, 100, 0.5, {"clusters": 400, "valid_share": 0.03}),
    "over_cap": (2, 20000, 100, 0.5, {"clusters": 300}),
    "ss_rpn_train": (8, 12000, 2000, 0.7, {"clusters": 600}),
    "merge_160000": (2, 160000, 100, 0.5, {"clusters": 400, "valid_share": 0.125}),
}
TILE = 64  # the kept-list sweep's tile
IOU_OPS = 15  # float32 operations of one IoU test with its threshold


def seeded_case(rng, n, k, clusters=60, invalid_from=None, tie_step=None, all_invalid_rows=(),
                invalid_tail_rows=None, valid_share=None, signed_zeros=False):
    """Clustered boxes on a 1024x640 canvas so real suppression happens, scores
    in [0, 1); invalid candidates carry -1e30. Numpy arrays (N, K, 4), (N, K)."""
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
    return boxes, scores


def _walk(s, i, v, max_out):
    """One problem in the greedy order (score descending, -0.0 as +0.0, then
    index): (its valid count V, the sorted places of its kept boxes, the
    walk's end: one past the max_out-th keep, else V)."""
    j = np.nonzero(s > -1e29)[0]
    order = j[np.lexsort((j, -s[j].astype(np.float64)))]
    place = np.empty(len(s), np.int64)
    place[order] = np.arange(len(order))
    kept = np.sort(place[i[v]])
    end = int(kept[-1]) + 1 if 0 < len(kept) == max_out else len(order)
    return len(order), kept, end


def greedy_pairs(scores, idx, valid, max_out) -> int:
    """The IoU tests greedy NMS needs on this data, summed over the problems:
    each valid candidate up to the max_out-th keep against each kept box
    before it in the greedy order."""
    total = 0
    for s, i, v in zip(scores, idx, valid):
        _, kept, end = _walk(s, i, v, max_out)
        total += int(np.searchsorted(kept, np.arange(end), side="left").sum())
    return total


def nms_work(scores, idx, valid, max_out):
    """(bytes, float32 operations) that NMS must spend on this data: boxes
    and scores read once, idx and valid written once; IOU_OPS an IoU test of
    ``greedy_pairs``. Numpy arrays: scores (N, K), idx and valid (N, max_out)."""
    n, k = scores.shape
    return n * k * 20 + n * max_out * 5, IOU_OPS * greedy_pairs(scores, idx, valid, max_out)


def sweep_walk(scores, idx, valid, max_out):
    """For each problem over the sort's cap: (tiles the kept-list sweep walks,
    pairs of a walked candidate and a kept box before it). The walk ends with
    the tile of the max_out-th keep, or at the end of the list."""
    out = []
    for s, i, v in zip(scores, idx, valid):
        n_valid, kept, end = _walk(s, i, v, max_out)
        if n_valid <= nms_kernel.ORDER_CAP:
            continue
        end = min(-(-end // TILE) * TILE, n_valid)
        before = np.searchsorted(kept, np.arange(end), side="left")
        out.append((int(-(-end // TILE)), int(before.sum())))
    return out


def profile_shape(name, seed, iters):
    n, k, max_out, thr, kw = SHAPES[name]
    boxes, scores = seeded_case(np.random.RandomState(seed), n, k, **kw)
    b, s = torch.from_numpy(boxes).cuda(), torch.from_numpy(scores).cuda()
    call = lambda: nms_kernel.nms_cuda(b, s, thr, max_out)  # noqa: E731
    idx, valid = call()
    kernels = device_ms(call, iters, 3, "nms_")
    walk = sweep_walk(scores, idx.cpu().numpy(), valid.cpu().numpy(), max_out)
    return {
        "shape": name, "n": n, "k": k, "max_out": max_out, "thr": thr,
        "valid": [int(c) for c in (scores > -1e29).sum(axis=1)],
        "kept": int(valid.sum()),
        "kernel_ms": {key: round(ms, 4) for key, ms in sorted(kernels.items())},
        "device_ms": round(sum(kernels.values()), 4),
        "queued_ms": round(queued_ms(call, iters, 3), 4),
        "sweep_tiles": [t for t, _ in walk], "sweep_pairs": [p for _, p in walk],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--shapes", default=",".join(SHAPES))
    p.add_argument("--out", default="")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_nms measures the card: no CUDA device")
    card = nvidia_smi_line()
    rows = []
    for i, name in enumerate(a.shapes.split(",")):
        row = {**profile_shape(name, a.seed + i, a.iters), "card": card}
        print(json.dumps(row), flush=True)
        rows.append(row)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
