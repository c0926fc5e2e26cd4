"""The algorithm of the greedy-NMS kernels of sad_tpu_torch/csrc/nms.cu,
written out in numpy stage by stage, held exactly equal (idx and valid) to
sad_tpu's ``nms_multi`` (its Pallas kernel, interpreted on this CPU) and to
the port's ``nms_multi_plain`` on the same inputs.

The stages, as the kernels do them:
1. order: compact the valid candidates (score > -1e30), sort them by a
   64-bit key, the order-preserving bits of the score descending (-0.0 keyed
   as +0.0) and then the index ascending;
2. mask: tiles of 64 x 64 over the upper triangle of the sorted order, bit j
   of row i (j > i) set iff the IoU with sorted box i as the pick exceeds thr;
3. sweep: a word of 64 candidates at a time against the removed bits, ORing
   the rows of the kept ones into the later words, until max_out keeps;
   problems with more valid candidates than the order stage holds go to the
   argmax loop instead (a small cap here sends some there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sad_tpu.ops import nms as jnms
from sad_tpu_torch.ops import nms as tnms

NEG = np.float32(-1e30)
ONE = np.float32(1.0)
TILE = 64


def sort_keys(scores):
    """The order stage's 64-bit keys of the valid candidates, ascending order =
    the argmax order; returns the sorted original indices."""
    j = np.nonzero(scores > NEG)[0]
    s = np.where(scores[j] == 0, np.float32(0.0), scores[j]).astype(np.float32)
    u = s.view(np.uint32).astype(np.uint64)
    u = np.where(u & np.uint64(0x80000000), ~u & np.uint64(0xFFFFFFFF), u | np.uint64(0x80000000))
    keys = ((~u & np.uint64(0xFFFFFFFF)) << np.uint64(32)) | j.astype(np.uint64)
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


def argmax_loop(boxes, scores, thr, max_out):
    """The over-cap path: max_out steps of argmax (first index among the
    maxima) and suppression."""
    live = scores.copy()
    out = []
    for _ in range(max_out):
        pick = int(np.argmax(live))
        if not live[pick] > NEG:
            break
        out.append(pick)
        live[iou_row(boxes[pick], boxes) > np.float32(thr)] = NEG
        live[pick] = NEG
    return out


def sorted_nms(boxes, scores, thr, max_out, cap=8192):
    """(idx (N, max_out) int32, valid (N, max_out) bool) of the three stages."""
    n = boxes.shape[0]
    idx = np.zeros((n, max_out), np.int32)
    valid = np.zeros((n, max_out), bool)
    for p in range(n):
        order = sort_keys(scores[p])
        if len(order) > cap:
            kept = argmax_loop(boxes[p], scores[p], thr, max_out)
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
    """(boxes, scores, thr, max_out, cap) of one named case."""
    if name == "ties":
        b, s = _case(1, 3, 250, tie_step=0.1)
        return b, s, 0.5, 60, 8192
    if name == "signed zeros":
        b, s = _signed_zeros(2, 3, 200)
        return b, s, 0.5, 80, 8192
    if name == "invalid tails and an all-invalid problem":
        b, s = _case(3, 4, 200)
        s[0, 30:] = NEG
        s[1, 150:] = NEG
        s[2] = NEG
        return b, s, 0.5, 60, 8192
    if name == "K = max_out, thr 0.7":
        b, s = _case(4, 3, 192)
        s[2, 100:] = NEG
        return b, s, 0.7, 192, 8192
    if name == "fewer valid than max_out":
        b, s = _case(5, 2, 150)
        s[:, 25:] = NEG
        return b, s, 0.5, 100, 8192
    if name == "K not a multiple of 64, over-cap problems":
        b, s = _case(6, 3, 299)
        s[1, 100:] = NEG  # 100 valid: under the cap of 120; the others take the argmax loop
        return b, s, 0.3, 90, 120
    raise KeyError(name)


CASES = ["ties", "signed zeros", "invalid tails and an all-invalid problem",
         "K = max_out, thr 0.7", "fewer valid than max_out",
         "K not a multiple of 64, over-cap problems"]


@pytest.mark.parametrize("name", CASES)
def test_sorted_stages_equal_sad_tpu_and_the_plain_version(name):
    boxes, scores, thr, max_out, cap = _case_for(name)
    idx, valid = sorted_nms(boxes, scores, thr, max_out, cap)
    ji, jv = jnms.nms_multi(jnp.asarray(boxes), jnp.asarray(scores), thr, max_out)
    pi, pv = tnms.nms_multi_plain(torch.from_numpy(boxes), torch.from_numpy(scores), thr, max_out)
    np.testing.assert_array_equal(valid, np.asarray(jv))
    np.testing.assert_array_equal(idx, np.asarray(ji))
    np.testing.assert_array_equal(valid, pv.numpy())
    np.testing.assert_array_equal(idx, pi.numpy())


def test_the_cases_reach_what_they_name():
    """Ties tie, -0.0 and +0.0 both occur among the kept, the mask spans
    several words, the sweep stops at max_out, and the cap splits problems."""
    b, s, thr, m, cap = _case_for("ties")
    assert len(np.unique(s[0])) < s.shape[1] // 5
    b, s, thr, m, cap = _case_for("signed zeros")
    idx, valid = sorted_nms(b, s, thr, m)
    kept = s[0][idx[0][valid[0]]]
    assert (np.signbit(kept) & (kept == 0)).any() and (~np.signbit(kept) & (kept == 0)).any()
    b, s, thr, m, cap = _case_for("K = max_out, thr 0.7")
    assert sort_keys(s[0]).size == m and -(-m // TILE) == 3
    b, s, thr, m, cap = _case_for("K not a multiple of 64, over-cap problems")
    sizes = [sort_keys(row).size for row in s]
    assert s.shape[1] % TILE and min(sizes) <= cap < max(sizes)
    b, s, thr, m, cap = _case_for("ties")
    idx, valid = sorted_nms(b, s, thr, m)
    assert valid.all()  # max_out keeps reached before the end of the list
