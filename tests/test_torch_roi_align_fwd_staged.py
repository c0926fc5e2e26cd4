"""The partition of the staged RoIAlign forward kernel of
sad_tpu_torch/csrc/roi_align.cu (``roi_align_fwd_kernel``), written out in
PyTorch and held bit for bit to ``multilevel_roi_align_plain``.

One block takes one roi and a group of its channel slices of L lanes x V
channels: all of them unless that leaves fewer than MIN_BLOCKS blocks, then
half as many, down to one (``slice_group``). For the roi, once:
- each axis's res * sr taps (``roi_geometry``'s cells and weights) get slots
  in a compact list of the axis's distinct cells: the taps move
  monotonically along an axis, so a running count of the cells a tap adds
  beyond the last tap's hi cell ranks them (``axis_slots``); where float
  rounding steps a position back a cell (positions past ~2^19, on a map that
  wide), every tap of that axis keeps two slots of its own.
For each slice in turn:
- the roi is staged in tiles, each a rectangle of slots that the shared
  buffer of ``cap`` cells holds: the whole roi where it fits, else column
  chunks no wider than ``cap // (2 sr)`` slots and, in each chunk, bands of
  bin rows whose rows x columns fit (``tiles``);
- the block's threads take a tile's (bin row, bin column, lane) items in that
  order, lane fastest, one pass of threads after another (``thread_items``):
  with one lane a cell (the small-C instance, C = 1) every thread has an item
  while the tile has items left;
- each output element adds the 16 products v * (wy * wx) in the plain twin's
  order: sample i, sample j, then (lo, lo), (lo, hi), (hi, lo), (hi, hi).
Also held within 1e-5 * max|ref| + 1e-6 to sad_tpu's dense multilevel
RoIAlign at float32, on the fixture shapes of tests/test_torch_roi_align.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sad_tpu.ops.proposals import dense_multilevel_roi_align
from sad_tpu_torch.ops import roi_align_kernel as K
from sad_tpu_torch.ops.roi_align import multilevel_roi_align_plain, roi_geometry

from test_torch_roi_align import _jax, _torch, fixture_inputs
from test_torch_models import one_torch_thread  # noqa: F401  (autouse)

MAX_THREADS = 256  # kThreads in the source
STAGE_BYTES = 49152  # kStageBytes in the source
MIN_BLOCKS = 4096  # kMinBlocks in the source


def axis_slots(lo, hi):
    """(slot of each tap's lo cell, slot of its hi cell, the cells in slot
    order) for one roi's taps along one axis, in tap order (bin, sample)."""
    lo, hi = lo.tolist(), hi.tolist()
    n = len(lo)
    if any(lo[k] < lo[k - 1] for k in range(1, n)):  # positions that do not grow
        cells = [c for k in range(n) for c in (lo[k], hi[k])]
        return list(range(0, 2 * n, 2)), list(range(1, 2 * n, 2)), cells
    s_lo, s_hi, cells, prev_hi = [], [], [], -1
    for a, b in zip(lo, hi):
        if a > prev_hi:
            cells.append(a)
        if b != a and b > prev_hi:
            cells.append(b)
        s_hi.append(len(cells) - 1)
        s_lo.append(len(cells) - 1 - (b != a))
        prev_hi = b
    return s_lo, s_hi, cells


def tiles(x_lo, x_hi, y_lo, y_hi, res, sr, cap):
    """The tiles (p0, p1, q0, q1) of a roi in the order the block takes them,
    from the slots of its taps (``cap`` cells in the buffer)."""
    xa = [x_lo[q * sr] for q in range(res)]
    xb = [x_hi[q * sr + sr - 1] for q in range(res)]
    ya = [y_lo[p * sr] for p in range(res)]
    yb = [y_hi[p * sr + sr - 1] for p in range(res)]
    if (yb[-1] + 1) * (xb[-1] + 1) <= cap:  # the whole roi
        return [(0, res, 0, res)]
    out, q0 = [], 0
    while q0 < res:
        q1 = q0 + 1
        while q1 < res and (xb[q1] - xa[q0] + 1) * 2 * sr <= cap:
            q1 += 1
        span, p0 = xb[q1 - 1] - xa[q0] + 1, 0
        while p0 < res:
            p1 = p0 + 1
            while p1 < res and (yb[p1] - ya[p0] + 1) * span <= cap:
                p1 += 1
            out.append((p0, p1, q0, q1))
            p0 = p1
        q0 = q1
    return out


def kernel_instance(c, esize, aligned=True):
    """(V, L) of the instance the library picks: 16-byte vectors with 8
    lanes where C is a multiple of the vector and C / V >= 8 (and the
    pointers are 16-byte aligned), else scalars with one lane."""
    vec = 16 // esize
    if aligned and c % vec == 0 and c // vec >= 8:
        return vec, 8
    return 1, 1


def cap_cells(stage_bytes, lanes, vec, esize, sr):
    """Cells of L * V values that the buffer holds."""
    return max(stage_bytes // (lanes * vec * esize), 4 * sr * sr)


def slice_group(n_rois, slices, min_blocks=MIN_BLOCKS):
    """The slices a block takes: all, unless R * ceil(slices / group) is
    under min_blocks; then half as many (rounded up), down to one."""
    group = slices
    while group > 1 and n_rois * -(-slices // group) < min_blocks:
        group = (group + 1) // 2
    return group


def block_threads(res, lanes):
    """The block size: the fewest threads (a multiple of 32, at least 64)
    that take a slice's res * res * L items in as few passes as MAX_THREADS
    do."""
    items = res * res * lanes
    passes = -(-items // MAX_THREADS)
    return max(64, -(-(-(-items // passes)) // 32) * 32)


def thread_items(p0, p1, q0, q1, lanes, threads):
    """For each pass of the block's threads over bin rows [p0, p1) of a tile:
    the (p, q, lane) item of each thread, or None for a thread without one."""
    nq, n = q1 - q0, (p1 - p0) * (q1 - q0) * lanes
    passes = []
    for base in range(0, n, threads):
        row = []
        for t in range(threads):
            e = base + t
            if e >= n:
                row.append(None)
                continue
            lane, b = e % lanes, e // lanes
            row.append((p0 + b // nq, q0 + b % nq, lane))
        passes.append(row)
    return passes


def staged_forward(features, rois, levels, valid, res, sr, lanes, vec, stage_bytes=STAGE_BYTES):
    """(R, res, res, C) in the features' dtype, roi by roi, slice by slice and
    tile by tile as the kernel computes it, with a slice of lanes * vec
    channels. Also returns every tile with its slot rectangle, for the
    checks."""
    lvls = sorted(features)
    feats = [features[l] for l in lvls]
    batch, c = feats[0].shape[0], feats[0].shape[-1]
    dims = [(f.shape[1], f.shape[2]) for f in feats]
    li, bi, _, _, (ylo, yhi, wylo, wyhi), (xlo, xhi, wxlo, wxhi) = roi_geometry(
        dims, lvls[0], batch, rois, levels, res, sr)
    cap = cap_cells(stage_bytes, lanes, vec, feats[0].element_size(), sr)
    width = lanes * vec
    out = torch.zeros((rois.shape[0], res, res, c), dtype=torch.float32)
    log = []
    for r in range(rois.shape[0]):
        if not valid[r]:
            continue
        ys_lo, ys_hi, rows = axis_slots(ylo[r].reshape(-1), yhi[r].reshape(-1))
        xs_lo, xs_hi, cols = axis_slots(xlo[r].reshape(-1), xhi[r].reshape(-1))
        wy = torch.stack([wylo[r].reshape(-1), wyhi[r].reshape(-1)])  # (2, res * sr) float32
        wx = torch.stack([wxlo[r].reshape(-1), wxhi[r].reshape(-1)])
        ys, xs = (ys_lo, ys_hi), (xs_lo, xs_hi)
        for c0 in range(0, c, width):  # the slices
            fmap = feats[int(li[r])][int(bi[r]), :, :, c0:c0 + width]
            for t, (p0, p1, q0, q1) in enumerate(tiles(xs_lo, xs_hi, ys_lo, ys_hi, res, sr, cap)):
                ra, rb = ys_lo[p0 * sr], ys_hi[(p1 - 1) * sr + sr - 1]
                ca, cb = xs_lo[q0 * sr], xs_hi[(q1 - 1) * sr + sr - 1]
                log.append((r, t, p0, p1, q0, q1, ra, rb, ca, cb, len(rows), len(cols), cap))
                ncol = cb - ca + 1
                # the tile's cells of the slice, read once from the map
                buf = fmap[torch.tensor(rows[ra:rb + 1])][:, torch.tensor(cols[ca:cb + 1])]
                buf = buf.reshape(-1, fmap.shape[-1])
                acc = torch.zeros((p1 - p0, q1 - q0, fmap.shape[-1]), dtype=torch.float32)
                for i in range(sr):
                    ky = [p * sr + i for p in range(p0, p1)]
                    for j in range(sr):
                        kx = [q * sr + j for q in range(q0, q1)]
                        for a in (0, 1):
                            ry = torch.tensor([ys[a][k] - ra for k in ky])
                            for b in (0, 1):
                                cx = torch.tensor([xs[b][k] - ca for k in kx])
                                v = buf[ry[:, None] * ncol + cx[None, :]].float()
                                w = wy[a][ky][:, None] * wx[b][kx][None, :]
                                acc = acc + v * w[..., None]
                out[r, p0:p1, q0:q1, c0:c0 + width] = acc
    return out.to(feats[0].dtype), log


def _check_log(log, res, sr):
    """Every bin of a roi in one tile of each slice; every tile within the
    buffer."""
    by_roi = {}
    for r, t, p0, p1, q0, q1, ra, rb, ca, cb, nrows, ncols, cap in log:
        by_roi.setdefault(r, []).append((t, p0, p1, q0, q1))
        assert 0 <= ra <= rb < nrows <= 2 * res * sr and 0 <= ca <= cb < ncols <= 2 * res * sr
        assert (rb - ra + 1) * (cb - ca + 1) <= cap
    for spans in by_roi.values():
        seen = torch.zeros((res, res), dtype=torch.int32)
        for _, p0, p1, q0, q1 in spans:
            seen[p0:p1, q0:q1] += 1
        n_slices = sum(1 for t, *_ in spans if t == 0)
        assert bool((seen == n_slices).all())


@pytest.mark.parametrize("res,sr", [(7, 2), (14, 2), (7, 1), (7, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_staged_forward_equals_the_plain_twin_bit_for_bit(res, sr, dtype):
    feats, rois, levels, valid = _torch(*fixture_inputs(seed=res + sr), dtype=dtype)
    vec, lanes = kernel_instance(8, feats[2].element_size())  # the fixture's C = 8
    assert (vec, lanes) == (1, 1)
    got, log = staged_forward(feats, rois, levels, valid, res, sr, lanes, vec)
    _check_log(log, res, sr)
    ref = multilevel_roi_align_plain(feats, rois, levels, valid, res, sr)
    assert got.dtype == dtype and torch.equal(got, ref)


@pytest.mark.parametrize("res", [7, 14])
def test_staged_forward_matches_sad_tpu_dense(res):
    inputs = fixture_inputs(seed=5)
    ref = np.asarray(dense_multilevel_roi_align(*_jax(*inputs), res, 2))
    got, _ = staged_forward(*_torch(*inputs), res, 2, 1, 1)  # the instance at C = 8
    err = np.abs(got.numpy() - ref).max()
    assert err <= 1e-5 * np.abs(ref).max() + 1e-6, err


def test_a_roi_wider_than_the_budget_walks_chunks_and_bands():
    """A roi over a whole 64x96 map at res 14: 56 distinct rows and columns,
    more than a small buffer holds, so the block walks column chunks and
    bands; with the buffer of the main instance (L = 8 lanes of 8 bf16) the
    same roi over a whole 200x336 map walks bands, and column chunks too at
    res 28."""
    rng = np.random.RandomState(8)
    feats = {2: torch.from_numpy(rng.randn(1, 64, 96, 4).astype(np.float32)).to(torch.bfloat16)}
    rois = torch.tensor([[0.0, 0.0, 0.0, 383.0, 255.0], [0.0, 30.0, 20.0, 90.0, 70.0]])
    levels, valid = torch.full((2,), 2, dtype=torch.int32), torch.ones(2, dtype=torch.bool)
    # a 512-byte buffer: 64 cells of 8 bytes, column chunks of 16 slots
    got, log = staged_forward(feats, rois, levels, valid, 14, 2, 1, 4, stage_bytes=512)
    _check_log(log, 14, 2)
    whole = [t for t in log if t[0] == 0]
    assert whole[0][10:12] == (56, 56) and len({(t[4], t[5]) for t in whole}) >= 2
    assert len(whole) > 2 and len(log) > len(whole)
    assert torch.equal(got, multilevel_roi_align_plain(feats, rois, levels, valid, 14, 2))
    # the main instance (384 cells of 64 bf16): a whole P2 map of the 800x1344
    # canvas walks bands at res 14 and column chunks of bands at res 28
    assert kernel_instance(256, 2) == (8, 8) and kernel_instance(256, 2, aligned=False) == (1, 1)
    cap = cap_cells(STAGE_BYTES, 8, 8, 2, 2)
    assert cap == 384
    for res, n_chunks in ((14, 1), (28, 2)):
        geo = roi_geometry([(200, 336)], 2, 1, torch.tensor([[0.0, 0.0, 0.0, 1343.0, 799.0]]),
                           torch.tensor([2], dtype=torch.int32), res, 2)
        (ylo, yhi, _, _), (xlo, xhi, _, _) = geo[4], geo[5]
        ys = axis_slots(ylo[0].reshape(-1), yhi[0].reshape(-1))
        xs = axis_slots(xlo[0].reshape(-1), xhi[0].reshape(-1))
        assert len(ys[2]) == len(xs[2]) == 4 * res  # of 200 rows and of 336 columns
        main = tiles(xs[0], xs[1], ys[0], ys[1], res, 2, cap)
        assert len({(t[2], t[3]) for t in main}) == n_chunks and len(main) > 4 * n_chunks


def test_axis_slots_rank_the_distinct_cells():
    # taps of a bin narrower than a cell share cells; a clamped edge tap has lo = hi
    lo, hi = torch.tensor([3, 3, 4, 4, 6, 9, 9]), torch.tensor([4, 4, 5, 5, 7, 9, 9])
    s_lo, s_hi, cells = axis_slots(lo, hi)
    assert cells == [3, 4, 5, 6, 7, 9]
    assert [cells[s] for s in s_lo] == lo.tolist() and [cells[s] for s in s_hi] == hi.tolist()
    # positions that fail to grow: two slots a tap, still each tap's own cells
    lo, hi = torch.tensor([5, 4, 6]), torch.tensor([6, 5, 7])
    s_lo, s_hi, cells = axis_slots(lo, hi)
    assert (s_lo, s_hi) == ([0, 2, 4], [1, 3, 5])
    assert [cells[s] for s in s_lo] == [5, 4, 6] and [cells[s] for s in s_hi] == [6, 5, 7]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_positions_that_fail_to_grow_keep_two_slots_a_tap(dtype):
    """On a map over 2^20 cells wide, rois whose x positions lie past 2^19
    cells: float rounding steps some roi's sample position back a cell (a
    tap's lo cell below the last tap's), so that axis gives every tap two
    slots of its own, and the result is still the plain twin's bit for bit."""
    rng = np.random.RandomState(11)
    w, r, res = 2**20 + 64, 48, 28
    feats = {2: torch.from_numpy(rng.randn(1, 2, w, 1).astype(np.float32)).to(dtype)}
    x1 = rng.uniform(2**21, 2**22, r)  # 2^19..2^20 cells on level 2
    rois = torch.from_numpy(np.stack([np.zeros(r), x1, np.zeros(r), x1 + rng.uniform(0, 12, r),
                                      np.full(r, 6.0)], axis=1).astype(np.float32))
    levels, valid = torch.full((r,), 2, dtype=torch.int32), torch.ones(r, dtype=torch.bool)
    xlo, xhi = (t.reshape(r, -1) for t in roi_geometry([(2, w)], 2, 1, rois, levels, res, 2)[5][:2])
    falls = (xlo[:, 1:] < xlo[:, :-1]).any(1)
    assert 0 < int(falls.sum()) < r
    k = int(falls.nonzero()[0])
    s_lo, s_hi, cells = axis_slots(xlo[k], xhi[k])
    assert (s_lo, s_hi) == (list(range(0, 4 * res, 2)), list(range(1, 4 * res, 2)))
    assert [cells[s] for s in s_lo] == xlo[k].tolist()
    got, log = staged_forward(feats, rois, levels, valid, res, 2, 1, 1)
    _check_log(log, res, 2)
    assert torch.equal(got, multilevel_roi_align_plain(feats, rois, levels, valid, res, 2))


def test_the_wrapper_limit_is_the_kernels_shared_memory():
    """roi_align_kernel.fwd_smem mirrors the source's: at the main shape
    (bf16, res 7, sr 2) the tables and the 48 KB buffer; the most taps an
    axis (kMaxTaps) where the buffer is 48 KB; a bin's 4 sr^2 cells of 128
    bytes outgrow it from sr 10."""
    assert K.fwd_smem(7, 2, 128) == 688 + STAGE_BYTES == 49840
    assert K.fwd_smem(3818, 1, 4) <= K.MAX_SMEM < K.fwd_smem(3819, 1, 4)
    assert K.fwd_smem(1, 9, 128) == 448 + STAGE_BYTES
    assert K.fwd_smem(1, 10, 128) == 496 + 400 * 128
    assert K.STAGE_BYTES == STAGE_BYTES


@pytest.mark.parametrize("lanes,res", [(1, 28), (8, 7), (8, 14)])
def test_threads_take_every_item_once_and_lanes_stay_busy(lanes, res):
    """The mask-target crop (C = 1: one lane a cell, res 28) and the main
    instance: every (p, q, lane) of a tile goes to one thread, every pass but
    the last gives all the block's threads an item, and a whole roi fills the
    block to at least 75 %."""
    threads = block_threads(res, lanes)
    assert threads % 32 == 0 and threads % lanes == 0 and 64 <= threads <= MAX_THREADS
    for p0, p1 in ((0, res), (2, 5)):
        passes = thread_items(p0, p1, 0, res, lanes, threads)
        items = [it for row in passes for it in row if it is not None]
        want = {(p, q, l) for p in range(p0, p1) for q in range(res) for l in range(lanes)}
        assert len(items) == len(want) and set(items) == want
        assert all(None not in row for row in passes[:-1])
        # each thread keeps one lane in every pass (the block is a multiple of the lanes)
        assert all(row[t] is None or row[t][2] == t % lanes for row in passes
                   for t in range(threads))
    whole = thread_items(0, res, 0, res, lanes, threads)
    busy = sum(it is not None for row in whole for it in row) / (len(whole) * threads)
    assert busy >= 0.75


def test_slice_groups_cover_every_slice_once():
    """A block takes `group` consecutive slices of its roi: every (roi,
    slice) once; the serving and training box shapes (8000 and 4096 rois)
    give a block all four slices of C = 256 bf16, the mask shapes (800 and
    1024 rois) one each, so that each launch has MIN_BLOCKS blocks or all
    the slices it can split into."""
    assert [slice_group(r, 4) for r in (8000, 4096, 800, 1024)] == [4, 4, 1, 1]
    assert slice_group(1024, 1) == 1 and slice_group(10, 3, 4) == 3 and slice_group(1, 3, 4) == 1
    for n_rois, slices, min_blocks in ((37, 4, 100), (37, 3, 60), (5, 7, 1), (200, 4, 4096)):
        group = slice_group(n_rois, slices, min_blocks)
        blocks = [(r, g) for r in range(n_rois) for g in range(-(-slices // group))]
        taken = [(r, s) for r, g in blocks
                 for s in range(g * group, min(g * group + group, slices))]
        assert sorted(taken) == [(r, s) for r in range(n_rois) for s in range(slices)]
        assert len(blocks) >= min(min_blocks, n_rois * slices) or group == 1


def test_mask_target_crop_shape_c1_float32():
    """C = 1 float32 at res 28 over gt rasters (the scalar small-C instance,
    one lane of one channel), rois up to the whole raster."""
    rng = np.random.RandomState(9)
    maps = {2: torch.from_numpy((rng.rand(6, 50, 84, 1) > 0.5).astype(np.float32))}
    r = 12
    xy = rng.uniform(0, [300, 170], (r, 2))
    rois = np.concatenate([rng.randint(0, 6, (r, 1)), xy,
                           xy + rng.uniform(8, 200, (r, 2))], axis=1).astype(np.float32)
    rois[0, 1:] = [0, 0, 335, 199]
    rois = torch.from_numpy(rois)
    lv, ok = torch.full((r,), 2, dtype=torch.int32), torch.ones(r, dtype=torch.bool)
    assert kernel_instance(1, 4) == (1, 1) and kernel_instance(3, 4) == (1, 1)
    got, log = staged_forward(maps, rois, lv, ok, 28, 2, 1, 1)
    _check_log(log, 28, 2)
    assert torch.equal(got, multilevel_roi_align_plain(maps, rois, lv, ok, 28, 2))
