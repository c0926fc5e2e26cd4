"""The algorithm of the RoIAlign backward gather kernel of
sad_tpu_torch/csrc/roi_align.cu, written out in PyTorch: each roi's weights
factor into a y part and an x part, so its gradient over its footprint is
``Ay^T . G . Ax``, with Ay (res x h) and Ax (res x w) built from the port's
tap rules (``roi_geometry``). The rois are binned onto 8 x 8 map tiles by the
cells their taps touch, each tile's list is taken in roi order, and the tile
is written once. Held within 1e-5 * max|ref| + 1e-6 at float32 to
``multilevel_roi_align_bwd_plain`` and to ``jax.grad`` of sad_tpu's dense
multilevel RoIAlign (the two sum the same terms in other orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sad_tpu.ops.proposals import dense_multilevel_roi_align
from sad_tpu_torch.ops.roi_align import multilevel_roi_align_bwd_plain, roi_geometry

TILE = 8


def axis_weights(lo, hi, w_lo, w_hi, n):
    """(res, n): the summed weights of each bin's taps on each cell of an axis."""
    a = torch.zeros((lo.shape[0], n), dtype=torch.float32)
    a.scatter_add_(1, lo, w_lo)
    a.scatter_add_(1, hi, w_hi)
    return a


def separable_backward(grad_out, dims, lvl_min, batch, rois, levels, valid, sr):
    """{level: (B, h, w, C)} float32, tile by tile as the gather kernel does."""
    r, res, _, c = grad_out.shape
    li, b, h, w, (ylo, yhi, wylo, wyhi), (xlo, xhi, wxlo, wxhi) = roi_geometry(
        dims, lvl_min, batch, rois, levels, res, sr)
    # bin: the tiles of each valid roi's footprint, and per-tile lists in roi order
    lists = {}
    for k in range(r):
        if not valid[k]:
            continue
        y0, y1 = int(ylo[k].min()) // TILE, int(yhi[k].max()) // TILE
        x0, x1 = int(xlo[k].min()) // TILE, int(xhi[k].max()) // TILE
        for ty in range(y0, y1 + 1):
            for tx in range(x0, x1 + 1):
                lists.setdefault((int(li[k]), int(b[k]), ty, tx), []).append(k)
    out = [torch.zeros((batch, hh, ww, c)) for hh, ww in dims]
    for (lvl, img, ty, tx), rs in lists.items():
        hh, ww = dims[lvl]
        rows = slice(ty * TILE, min((ty + 1) * TILE, hh))
        cols = slice(tx * TILE, min((tx + 1) * TILE, ww))
        acc = torch.zeros((rows.stop - rows.start, cols.stop - cols.start, c))
        for k in sorted(rs):
            ay = axis_weights(ylo[k].reshape(res, -1), yhi[k].reshape(res, -1),
                              wylo[k].reshape(res, -1), wyhi[k].reshape(res, -1), hh)[:, rows]
            ax = axis_weights(xlo[k].reshape(res, -1), xhi[k].reshape(res, -1),
                              wxlo[k].reshape(res, -1), wxhi[k].reshape(res, -1), ww)[:, cols]
            s = torch.einsum("qx,pqc->pxc", ax, grad_out[k].float())  # sum over the bin columns
            acc += torch.einsum("py,pxc->yxc", ay, s)  # then over the bin rows
        out[lvl][img, rows, cols] = acc  # the tile, written once
    return out


def case(seed, canvas, r=14, b=2, c=8, res=7):
    """Rois on every level, with the edge rules' cases in the first slots:
    wholly outside the map, zero area, on the last row and column, 1:40 and
    40:1 aspect ratios, one over the whole canvas on P2 (many tiles); a fifth
    invalid."""
    rng = np.random.RandomState(seed)
    hc, wc = canvas
    x1, y1 = rng.uniform(0, wc * 0.7, r), rng.uniform(0, hc * 0.7, r)
    rois = np.stack([np.sort(rng.randint(0, b, r)).astype(np.float32), x1, y1,
                     np.minimum(x1 + rng.uniform(4, wc * 0.6, r), wc - 1),
                     np.minimum(y1 + rng.uniform(4, hc * 0.6, r), hc - 1)], 1).astype(np.float32)
    special = [[-300.0, -200.0, -250.0, -150.0], [10.0, 10.0, 10.0, 10.0],
               [wc - 30.0, hc - 20.0, wc - 1.0, hc - 1.0], [2.0, 5.0, 3.0, hc - 3.0],
               [4.0, 2.0, wc - 3.0, 3.0], [0.0, 0.0, wc - 1.0, hc - 1.0]]
    rois[:len(special), 1:] = special
    levels = (2 + np.arange(r) % 4).astype(np.int32)
    levels[5] = 2  # the whole canvas on the finest level
    valid = np.ones(r, bool)
    valid[7::5] = False
    g = rng.randn(r, res, res, c).astype(np.float32)
    return rois, levels, valid, g


def jax_grads(canvas, b, c, rois, levels, valid, g, res, sr):
    """jax.grad of the dense form, jitted (op by op it takes ~10 s a case)."""
    feats = {l: jnp.zeros((b, canvas[0] >> l, canvas[1] >> l, c), jnp.float32) for l in range(2, 6)}

    def loss(fd, rois, levels, valid, g):
        return jnp.sum(dense_multilevel_roi_align(fd, rois, levels, valid, res, sr) * g)

    grads = jax.jit(jax.grad(loss))(feats, *(jnp.asarray(a) for a in (rois, levels, valid, g)))
    return {l: np.asarray(v) for l, v in grads.items()}


@pytest.mark.parametrize("canvas,res,sr", [((128, 192), 7, 2), ((128, 192), 14, 1),
                                           ((96, 160), 7, 3), ((32, 64), 7, 2)],
                         ids=["res7-sr2", "res14-sr1", "res7-sr3", "top-level-1x2"])
def test_separable_tiles_match_the_plain_backward_and_jax_grad(canvas, res, sr):
    b, c = 2, 8
    rois, levels, valid, g = case(res * 10 + sr + canvas[0], canvas, b=b, c=c, res=res)
    dims = [(canvas[0] >> l, canvas[1] >> l) for l in range(2, 6)]
    if canvas == (32, 64):
        assert dims[-1] == (1, 2)
    args = (torch.from_numpy(rois), torch.from_numpy(levels), torch.from_numpy(valid))
    got = separable_backward(torch.from_numpy(g), dims, 2, b, *args, sr)
    plain = multilevel_roi_align_bwd_plain(torch.from_numpy(g), dict(zip(range(2, 6), dims)), b,
                                           *args, sr)
    ref = jax_grads(canvas, b, c, rois, levels, valid, g, res, sr)
    ref_max = max(np.abs(v).max() for v in ref.values())
    assert ref_max > 0.1
    for k, l in enumerate(range(2, 6)):
        for other in (plain[l].numpy(), ref[l]):
            err = np.abs(got[k].numpy() - other)
            assert (err <= 1e-5 * ref_max + 1e-6).all(), (l, err.max(), ref_max)


def test_a_roi_spans_several_tiles_and_invalid_rois_add_nothing():
    canvas, res, sr = (128, 192), 7, 2
    rois, levels, valid, g = case(3, canvas, res=res)
    dims = [(canvas[0] >> l, canvas[1] >> l) for l in range(2, 6)]
    _, _, _, _, (ylo, yhi, _, _), (xlo, xhi, _, _) = roi_geometry(
        dims, 2, 2, torch.from_numpy(rois), torch.from_numpy(levels), res, sr)
    spans = [(int(yhi[k].max()) // TILE - int(ylo[k].min()) // TILE + 1)
             * (int(xhi[k].max()) // TILE - int(xlo[k].min()) // TILE + 1) for k in range(len(rois))]
    assert spans[5] == 4 * 6 and max(spans) > 1  # the whole P2 map: every tile of the image
    args = (torch.from_numpy(rois), torch.from_numpy(levels))
    full = separable_backward(torch.from_numpy(g), dims, 2, 2, *args, torch.from_numpy(valid), sr)
    keep = separable_backward(torch.from_numpy(g[valid]), dims, 2, 2, args[0][valid],
                              args[1][valid], torch.ones(int(valid.sum()), dtype=torch.bool), sr)
    none = separable_backward(torch.from_numpy(g), dims, 2, 2, *args,
                              torch.zeros(len(rois), dtype=torch.bool), sr)
    assert all(torch.equal(a, k) for a, k in zip(full, keep))
    assert all(not n.any() for n in none)
