"""The algorithm of the greedy-NMS kernels of sad_tpu_torch/csrc/nms.cu,
written out in numpy stage by stage, held exactly equal (idx and valid) to
sad_tpu's ``nms_multi`` (its Pallas kernel, interpreted on this CPU) and to
the port's ``nms_multi_plain`` on the same inputs.

The stages, as the kernels do them, for a problem of at most ``cap`` valid
candidates:
1. order: compact the valid candidates (score > -1e30), sort them by a
   64-bit key, the order-preserving bits of the score descending (-0.0 keyed
   as +0.0) and then the index ascending;
2. mask: tiles of 64 x 64 over the upper triangle of the sorted order, bit j
   of row i (j > i) set iff the IoU with sorted box i as the pick exceeds thr;
3. sweep: a word of 64 candidates at a time against the removed bits, ORing
   the rows of the kept ones into the later words, until max_out keeps.
A problem over ``cap`` (a small cap here sends some there) takes instead:
4. run sort: the valid candidates of each run of ``run`` input slots,
   keyed as in 1 and sorted;
5. merge: a key's place is its place in its run plus, in every other run,
   the count of smaller keys;
6. kept-list sweep: tiles of 64 sorted candidates, each tested against the
   boxes kept so far, the tile's survivors resolved among themselves with
   the tile's own 64 x 64 mask, until max_out keeps or the end of the list.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sad_tpu.ops import nms as jnms
from sad_tpu_torch.ops import nms as tnms
from sad_tpu_torch.ops import nms_kernel
from sad_tpu_torch.tools import profile_nms
from test_torch_models import one_torch_thread  # noqa: F401  (autouse)

NEG = np.float32(-1e30)
ONE = np.float32(1.0)
TILE = 64


def keys_of(scores, j):
    """The order stage's 64-bit keys of candidates j: ascending order = the
    argmax order."""
    s = np.where(scores[j] == 0, np.float32(0.0), scores[j]).astype(np.float32)
    u = s.view(np.uint32).astype(np.uint64)
    u = np.where(u & np.uint64(0x80000000), ~u & np.uint64(0xFFFFFFFF), u | np.uint64(0x80000000))
    return ((~u & np.uint64(0xFFFFFFFF)) << np.uint64(32)) | j.astype(np.uint64)


def sort_keys(scores):
    """The order stage: the valid candidates' original indices, sorted."""
    keys = keys_of(scores, np.nonzero(scores > NEG)[0])
    return (np.sort(keys) & np.uint64(0xFFFFFFFF)).astype(np.int64)


def iou_row(p, boxes):
    """IoU of pick p against boxes, float32, in the kernel's order of operations."""
    parea = (p[2] - p[0] + ONE) * (p[3] - p[1] + ONE)
    area = (boxes[:, 2] - boxes[:, 0] + ONE) * (boxes[:, 3] - boxes[:, 1] + ONE)
    iw = np.maximum(np.minimum(p[2], boxes[:, 2]) - np.maximum(p[0], boxes[:, 0]) + ONE,
                    np.float32(0))
    ih = np.maximum(np.minimum(p[3], boxes[:, 3]) - np.maximum(p[1], boxes[:, 1]) + ONE,
                    np.float32(0))
    inter = iw * ih
    with np.errstate(divide="ignore", invalid="ignore"):
        return inter / (parea + area - inter)


def mask_words(sboxes, thr):
    """(V, words) uint64: the mask stage, tile by tile over the upper triangle."""
    v = len(sboxes)
    words = -(-v // TILE)
    mask = np.zeros((v, words), np.uint64)
    for rt in range(words):
        for ct in range(rt, words):
            cols = sboxes[ct * TILE:(ct + 1) * TILE]
            for i in range(rt * TILE, min((rt + 1) * TILE, v)):
                hit = iou_row(sboxes[i], cols) > np.float32(thr)
                hit &= np.arange(ct * TILE, ct * TILE + len(cols)) > i
                mask[i, ct] = np.uint64(sum(1 << int(b) for b in np.nonzero(hit)[0]))
    return mask


def sweep(order, mask, max_out):
    """The sweep: kept original indices, in keep order, at most max_out."""
    v = len(order)
    removed = [0] * mask.shape[1]
    out = []
    for w in range(mask.shape[1]):
        rw, kept = removed[w], []
        for b in range(min(TILE, v - w * TILE)):
            if not (rw >> b) & 1:
                kept.append(b)
                rw |= int(mask[w * TILE + b, w])
        kept = kept[:max_out - len(out)]
        out += [int(order[w * TILE + b]) for b in kept]
        if len(out) == max_out:
            break
        for ww in range(w + 1, mask.shape[1]):
            for b in kept:
                removed[ww] |= int(mask[w * TILE + b, ww])
    return out


def iou_pairs(picks, boxes):
    """(len(picks), len(boxes)) IoUs, each pair in iou_row's order of
    operations with the pick as the first operand."""
    p = picks[:, None, :]
    parea = (p[..., 2] - p[..., 0] + ONE) * (p[..., 3] - p[..., 1] + ONE)
    area = (boxes[:, 2] - boxes[:, 0] + ONE) * (boxes[:, 3] - boxes[:, 1] + ONE)
    iw = np.maximum(np.minimum(p[..., 2], boxes[:, 2]) - np.maximum(p[..., 0], boxes[:, 0]) + ONE,
                    np.float32(0))
    ih = np.maximum(np.minimum(p[..., 3], boxes[:, 3]) - np.maximum(p[..., 1], boxes[:, 1]) + ONE,
                    np.float32(0))
    inter = iw * ih
    with np.errstate(divide="ignore", invalid="ignore"):
        return inter / (parea + area - inter)


def run_sort(scores, run):
    """Stage 4: each run of ``run`` input slots' valid keys, sorted."""
    runs = []
    for lo in range(0, len(scores), run):
        j = lo + np.nonzero(scores[lo:lo + run] > NEG)[0]
        runs.append(np.sort(keys_of(scores, j)))
    return runs


def merge_runs(runs):
    """Stage 5: the original indices in sorted order, each key placed at its
    place in its run plus the count of smaller keys in every other run."""
    order = np.full(sum(len(r) for r in runs), -1, np.int64)
    for r, keys in enumerate(runs):
        for i, key in enumerate(keys):
            pos = i + sum(int(np.searchsorted(other, key, side="left"))
                          for q, other in enumerate(runs) if q != r)
            order[pos] = int(key & np.uint64(0xFFFFFFFF))
    assert (order >= 0).all()  # the places are a permutation
    return order


def kept_sweep(order, sboxes, thr, max_out):
    """Stage 6: kept original indices, in keep order, at most max_out."""
    kept, out = [], []
    thr = np.float32(thr)
    for i0 in range(0, len(order), TILE):
        tile = sboxes[i0:i0 + TILE]
        lim = len(tile)
        left = np.ones(lim, bool)
        if kept:
            left &= ~(iou_pairs(sboxes[kept], tile) > thr).any(axis=0)
        diag = (iou_pairs(tile, tile) > thr) & (np.arange(lim)[None, :] > np.arange(lim)[:, None])
        new = []
        for b in range(lim):
            if left[b]:
                new.append(b)
                left &= ~diag[b]
        new = new[:max_out - len(out)]
        kept += [i0 + b for b in new]
        out += [int(order[i0 + b]) for b in new]
        if len(out) == max_out:
            break
    return out


def sorted_nms(boxes, scores, thr, max_out, cap=8192, run=4096):
    """(idx (N, max_out) int32, valid (N, max_out) bool) of the stages."""
    n = boxes.shape[0]
    idx = np.zeros((n, max_out), np.int32)
    valid = np.zeros((n, max_out), bool)
    for p in range(n):
        order = sort_keys(scores[p])
        if len(order) > cap:
            merged = merge_runs(run_sort(scores[p], run))
            np.testing.assert_array_equal(merged, order)
            kept = kept_sweep(merged, boxes[p][merged], thr, max_out)
        else:
            kept = sweep(order, mask_words(boxes[p][order], thr), max_out)
        idx[p, :len(kept)] = kept
        valid[p, :len(kept)] = True
    return idx, valid


def _case(seed, n, k, clusters=12, tie_step=None):
    rng = np.random.RandomState(seed)
    centers = rng.uniform(0, 300, (n, clusters, 2))
    which = rng.randint(0, clusters, (n, k))
    xy = np.take_along_axis(centers, which[..., None], axis=1) + rng.uniform(-8, 8, (n, k, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(8, 60, (n, k, 2))], axis=-1).astype(np.float32)
    scores = rng.uniform(0.01, 1.0, (n, k)).astype(np.float32)
    if tie_step:
        scores = (np.round(scores / tie_step) * tie_step).astype(np.float32)
    return boxes, scores


def _signed_zeros(seed, n, k):
    """Scores of exactly +0.0 and -0.0 among positive and negative ones."""
    boxes, scores = _case(seed, n, k)
    rng = np.random.RandomState(seed + 1)
    scores = scores - np.float32(0.5)
    pick = rng.uniform(size=(n, k))
    scores[pick < 0.2] = np.float32(0.0)
    scores[pick > 0.8] = np.float32(-0.0)
    return boxes, scores


def _case_for(name):
    """(boxes, scores, thr, max_out, cap, run) of one named case."""
    if name == "ties":
        b, s = _case(1, 3, 250, tie_step=0.1)
        return b, s, 0.5, 60, 8192, 4096
    if name == "signed zeros":
        b, s = _signed_zeros(2, 3, 200)
        return b, s, 0.5, 80, 8192, 4096
    if name == "invalid tails and an all-invalid problem":
        b, s = _case(3, 4, 200)
        s[0, 30:] = NEG
        s[1, 150:] = NEG
        s[2] = NEG
        return b, s, 0.5, 60, 8192, 4096
    if name == "K = max_out, thr 0.7":
        b, s = _case(4, 3, 192)
        s[2, 100:] = NEG
        return b, s, 0.7, 192, 8192, 4096
    if name == "fewer valid than max_out":
        b, s = _case(5, 2, 150)
        s[:, 25:] = NEG
        return b, s, 0.5, 100, 8192, 4096
    if name == "K not a multiple of 64, over-cap problems":
        b, s = _case(6, 3, 299)
        s[1, 100:] = NEG  # 100 valid: under the cap of 120; the others take stages 4-6
        return b, s, 0.3, 90, 120, 4096
    if name == "V just over the cap":
        b, s = _case(7, 2, 200)
        s[0, 121:] = NEG
        s[1, 150:] = NEG
        return b, s, 0.5, 100, 120, 64
    if name == "several runs with a merge":
        b, s = _case(8, 2, 300)
        return b, s, 0.5, 120, 120, 48
    if name == "exact score ties across a run boundary":
        b, s = _case(9, 2, 260, tie_step=0.05)
        return b, s, 0.5, 100, 120, 50
    if name == "-0.0 / +0.0 ties over the cap":
        b, s = _signed_zeros(10, 2, 240)
        return b, s, 0.5, 120, 120, 64
    if name == "invalid tails over the cap":
        b, s = _case(11, 3, 280)
        s[0, 200:] = NEG
        s[1, 130:] = NEG
        s[2, 90:] = NEG
        return b, s, 0.5, 80, 120, 64
    if name == "max_out greater than V over the cap":
        b, s = _case(12, 2, 200)
        s[:, 160:] = NEG
        return b, s, 0.5, 200, 120, 64
    if name == "max_out reached in the first tile":
        b, s = _case(13, 2, 250, clusters=200)
        return b, s, 0.9, 20, 120, 64
    if name == "one problem over the cap beside two under it":
        b, s = _case(14, 3, 250)
        s[1, 100:] = NEG
        s[2, 60:] = NEG
        return b, s, 0.5, 70, 120, 64
    raise KeyError(name)


CASES = ["ties", "signed zeros", "invalid tails and an all-invalid problem",
         "K = max_out, thr 0.7", "fewer valid than max_out",
         "K not a multiple of 64, over-cap problems", "V just over the cap",
         "several runs with a merge", "exact score ties across a run boundary",
         "-0.0 / +0.0 ties over the cap", "invalid tails over the cap",
         "max_out greater than V over the cap", "max_out reached in the first tile",
         "one problem over the cap beside two under it"]


@pytest.mark.parametrize("name", CASES)
def test_sorted_stages_equal_sad_tpu_and_the_plain_version(name):
    boxes, scores, thr, max_out, cap, run = _case_for(name)
    idx, valid = sorted_nms(boxes, scores, thr, max_out, cap, run)
    ji, jv = jnms.nms_multi(jnp.asarray(boxes), jnp.asarray(scores), thr, max_out)
    pi, pv = tnms.nms_multi_plain(torch.from_numpy(boxes), torch.from_numpy(scores), thr, max_out)
    np.testing.assert_array_equal(valid, np.asarray(jv))
    np.testing.assert_array_equal(idx, np.asarray(ji))
    np.testing.assert_array_equal(valid, pv.numpy())
    np.testing.assert_array_equal(idx, pi.numpy())


def _valid_counts(s):
    return [sort_keys(row).size for row in s]


def test_the_cases_reach_what_they_name():
    """Ties tie, -0.0 and +0.0 both occur among the kept, the mask spans
    several words, the sweep stops at max_out, and the cap splits problems."""
    b, s, thr, m, cap, run = _case_for("ties")
    assert len(np.unique(s[0])) < s.shape[1] // 5
    b, s, thr, m, cap, run = _case_for("signed zeros")
    idx, valid = sorted_nms(b, s, thr, m)
    kept = s[0][idx[0][valid[0]]]
    assert (np.signbit(kept) & (kept == 0)).any() and (~np.signbit(kept) & (kept == 0)).any()
    b, s, thr, m, cap, run = _case_for("K = max_out, thr 0.7")
    assert sort_keys(s[0]).size == m and -(-m // TILE) == 3
    b, s, thr, m, cap, run = _case_for("K not a multiple of 64, over-cap problems")
    sizes = _valid_counts(s)
    assert s.shape[1] % TILE and min(sizes) <= cap < max(sizes)
    b, s, thr, m, cap, run = _case_for("ties")
    idx, valid = sorted_nms(b, s, thr, m)
    assert valid.all()  # max_out keeps reached before the end of the list


def test_the_over_cap_cases_reach_what_they_name():
    """Each over-cap case reaches the part of stages 4-6 that its name says."""
    b, s, thr, m, cap, run = _case_for("V just over the cap")
    assert _valid_counts(s)[0] == cap + 1
    b, s, thr, m, cap, run = _case_for("several runs with a merge")
    assert min(_valid_counts(s)) > cap and all(len(r) >= 3 for r in
                                               (run_sort(row, run) for row in s))
    b, s, thr, m, cap, run = _case_for("exact score ties across a run boundary")
    runs = np.arange(s.shape[1]) // run
    same = (s[0][:, None] == s[0][None, :]) & (runs[:, None] != runs[None, :])
    assert same.any() and min(_valid_counts(s)) > cap
    b, s, thr, m, cap, run = _case_for("-0.0 / +0.0 ties over the cap")
    idx, valid = sorted_nms(b, s, thr, m, cap, run)
    kept = s[0][idx[0][valid[0]]]
    assert min(_valid_counts(s)) > cap
    assert (np.signbit(kept) & (kept == 0)).any() and (~np.signbit(kept) & (kept == 0)).any()
    b, s, thr, m, cap, run = _case_for("invalid tails over the cap")
    sizes = _valid_counts(s)
    assert sizes[0] > cap and sizes[1] > cap and sizes[2] <= cap and (s <= NEG).any(axis=1).all()
    b, s, thr, m, cap, run = _case_for("max_out greater than V over the cap")
    idx, valid = sorted_nms(b, s, thr, m, cap, run)
    assert min(_valid_counts(s)) > cap and m > max(_valid_counts(s)) and not valid[:, -1].any()
    b, s, thr, m, cap, run = _case_for("max_out reached in the first tile")
    idx, valid = sorted_nms(b, s, thr, m, cap, run)
    assert min(_valid_counts(s)) > cap and valid.all()
    for p in range(s.shape[0]):
        order = list(sort_keys(s[p]))
        assert max(order.index(i) for i in idx[p]) < TILE
    b, s, thr, m, cap, run = _case_for("one problem over the cap beside two under it")
    assert sorted(c > cap for c in _valid_counts(s)) == [False, False, True]


def greedy_walk_pairs(boxes, scores, thr, max_out):
    """The greedy order walked one candidate at a time: each candidate up to
    the max_out-th keep counts the kept boxes before it, and is kept iff none
    of them suppresses it."""
    total, thr = 0, np.float32(thr)
    for b, s in zip(boxes, scores):
        kept = []
        for c in sort_keys(s):
            if len(kept) == max_out:
                break
            total += len(kept)
            if not kept or not (iou_pairs(b[kept], b[[c]]) > thr).any():
                kept.append(int(c))
    return total


@pytest.mark.parametrize("name", ["signed zeros", "invalid tails and an all-invalid problem",
                                  "fewer valid than max_out", "max_out reached in the first tile",
                                  "exact score ties across a run boundary"])
def test_nms_bound_counts_the_greedy_walk(name):
    """The bound's IoU tests (``profile_nms.nms_work``, which chip_smoke.py
    charges) are the pairs the greedy walk tests: each valid candidate up to
    the max_out-th keep against the kept boxes before it."""
    boxes, scores, thr, max_out, _, _ = _case_for(name)
    pi, pv = tnms.nms_multi_plain(torch.from_numpy(boxes), torch.from_numpy(scores), thr, max_out)
    pairs = greedy_walk_pairs(boxes, scores, thr, max_out)
    assert profile_nms.greedy_pairs(scores, pi.numpy(), pv.numpy(), max_out) == pairs > 0
    n, k = scores.shape
    assert profile_nms.nms_work(scores, pi.numpy(), pv.numpy(), max_out) == (
        n * k * 20 + n * max_out * 5, profile_nms.IOU_OPS * pairs)


@pytest.mark.parametrize("n,k", [(1, 1), (8, 5000), (40, 1000), (3, 1500), (40, 2000),
                                 (8, 8192)])
def test_scratch_plan_up_to_the_cap_is_the_sorted_paths(n, k):
    """For K <= ORDER_CAP no problem can pass the cap: the scratch is the
    sorted path's parts alone, in their order and sizes, 16-byte aligned."""
    words = -(-k // 64)
    sizes = [n * k * 4, n * k * 16, n * k * words * 8, n * nms_kernel.ORDER_CAP // 8, 3 * n * 4]
    plan, total = nms_kernel.scratch_plan(n, k)
    assert [name for name, _, _ in plan] == ["sorted_idx", "sorted_box", "mask", "removed",
                                             "state"]
    assert [size for _, _, size in plan] == sizes
    offsets = np.cumsum([0] + [-(-size // 16) * 16 for size in sizes])
    assert [offset for _, offset, _ in plan] == offsets[:-1].tolist() and total == offsets[-1]


def test_scratch_plan_past_the_cap_grows_linearly_in_k():
    """Past the cap the over-cap parts grow linearly in K (no K^2 term),
    while the sorted path's stay at their size at the cap."""
    n = 8
    totals = [nms_kernel.scratch_plan(n, k)[1] for k in (40_960, 81_920, 122_880, 163_840)]
    steps = np.diff(totals)
    assert (steps == steps[0]).all() and steps[0] == n * 40_960 * 28 + n * 10 * 4
    plan, total = nms_kernel.scratch_plan(n, 160_000)
    parts = {name: size for name, _, size in plan}
    at_cap = nms_kernel.scratch_plan(n, nms_kernel.ORDER_CAP)[0]
    assert all(parts[name] == size for name, _, size in at_cap)
    runs = -(-160_000 // nms_kernel.RUN)
    assert (parts["run_keys"], parts["run_count"], parts["over_idx"], parts["over_box"]) == (
        n * 160_000 * 8, n * runs * 4, n * 160_000 * 4, n * 160_000 * 16)
    assert total - nms_kernel.scratch_plan(n, nms_kernel.ORDER_CAP)[1] < n * 160_000 * 29
    assert all(offset % 16 == 0 for _, offset, _ in plan)
