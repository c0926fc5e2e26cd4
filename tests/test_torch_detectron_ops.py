"""The rest of sad_tpu's Detectron op library (sad_tpu/ops/detectron_ops.py:
191-257, :338-345, :430-512) and sad_tpu/utils/segms.py's
``polys_to_mask_wrt_box`` in the port (sad_tpu_torch/ops/detectron_ops.py,
utils/segms.py), on the same numpy inputs. The port's maps are NCHW,
sad_tpu's NHWC: the inputs and outputs are transposed.

- ``roi_pool`` against sad_tpu's jitted op (as its own tests and any jitted
  caller run it; XLA multiplies by float32(1 / res) where sad_tpu divides):
  equal bit for bit at res 4 and 7, scales 1/4 and 1/2, rois inside, across
  and outside the map, degenerate and reversed ones, in one chunk and over
  sad_tpu's 32-roi chunks; the gradient with respect to the map against
  ``jax.grad`` of the same contraction within 1e-6 of its largest entry, on
  random maps (no two cells of a bin are equal: JAX splits a tie's gradient,
  RoIPoolF gives it to the first maximum, which a constant map checks).
- ``group_spatial_softmax``, ``sigmoid_cross_entropy_loss`` (ignored -1
  targets, scale 1.3): values within 1e-6 relative and the gradients that
  sad_tpu's tests take (tests/test_gradient_checks.py) within 1e-6 of their
  largest entry.
- The elementwise and indexing ops (``batch_permutation``, ``sample_as``,
  ``spatial_narrow_as``, ``spatial_l2_loss``, ``spatial_sigmoid``,
  ``affine_channel`` without gradient to its scale and bias,
  ``upsample_nearest``, ``zero_even``) equal sad_tpu's; ``polys_to_mask_wrt_box``
  byte-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sad_tpu.ops.detectron_ops as D
from sad_tpu.utils import segms as j_segms
import sad_tpu_torch.ops as T
from sad_tpu_torch.utils import segms as t_segms
from test_torch_models import one_torch_thread  # noqa: F401


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _rois(rng, n, b, h, w, scale):
    """Image-frame rois over a map of h x w cells at ``scale``: inside,
    across the border, outside, degenerate (x2 < x1) and single-cell ones."""
    ih, iw = h / scale, w / scale
    x1 = rng.uniform(-0.3 * iw, 1.1 * iw, n)
    y1 = rng.uniform(-0.3 * ih, 1.1 * ih, n)
    x2 = x1 + rng.uniform(-4, 0.8 * iw, n)
    y2 = y1 + rng.uniform(-4, 0.8 * ih, n)
    rois = np.stack([rng.randint(0, b, n), x1, y1, x2, y2], 1).astype(np.float32)
    rois[:4, 1:] = [[0, 0, 0, 0], [3, 5, 3, 5], [iw - 1, ih - 1, iw + 9, ih + 9],
                    [-20, -20, -2, -2]]
    return rois


@pytest.mark.parametrize("res,scale,n", [(4, 0.25, 20), (7, 0.5, 20), (7, 0.25, 70)])
def test_roi_pool_matches_sad_tpu(res, scale, n):
    rng = np.random.RandomState(res * 100 + n)
    b, h, w, c = 2, 20, 24, 5
    feats = rng.randn(b, h, w, c).astype(np.float32)
    rois = _rois(rng, n, b, h, w, scale)
    ct = rng.randn(n, res, res, c).astype(np.float32)

    def contraction(f):
        return jnp.sum(D.roi_pool(f, jnp.asarray(rois), scale, res) * ct)

    ref = jax.jit(lambda f: D.roi_pool(f, jnp.asarray(rois), scale, res))(jnp.asarray(feats))
    gref = np.asarray(jax.jit(jax.grad(contraction))(jnp.asarray(feats)))
    f = _nchw(feats).requires_grad_(True)
    got = T.roi_pool(f, torch.from_numpy(rois), scale, res)
    assert got.shape == (n, c, res, res)
    np.testing.assert_array_equal(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(ref))
    assert (got == 0).any() and (got != 0).any()  # empty bins and pooled ones
    (got * torch.from_numpy(ct).permute(0, 3, 1, 2)).sum().backward()
    g = _nhwc(f.grad)
    assert np.abs(g - gref).max() <= 1e-6 * np.abs(gref).max()


def test_roi_pool_gives_a_tie_to_the_first_maximum():
    """On a constant map every bin's gradient goes to its first cell in
    row-major order (RoIPoolF's argmax), the bin's start."""
    f = torch.ones(1, 1, 8, 8, requires_grad=True)
    rois = torch.tensor([[0, 0, 0, 7, 7]], dtype=torch.float32)
    T.roi_pool(f, rois, 1.0, 2).sum().backward()
    want = torch.zeros(8, 8)
    want[0, 0] = want[0, 4] = want[4, 0] = want[4, 4] = 1.0
    assert torch.equal(f.grad[0, 0], want)


def test_group_spatial_softmax_matches_sad_tpu():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 6, 12).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v: D.group_spatial_softmax(v, 4))(jnp.asarray(x)))
    gref = np.asarray(jax.jit(jax.grad(lambda v: jnp.sum(D.group_spatial_softmax(v, 4) ** 2)))(
        jnp.asarray(x)))
    t = _nchw(x).requires_grad_(True)
    got = T.group_spatial_softmax(t, 4)
    assert np.abs(_nhwc(got) - ref).max() <= 1e-6 * np.abs(ref).max()
    (got ** 2).sum().backward()
    assert np.abs(_nhwc(t.grad) - gref).max() <= 1e-6 * np.abs(gref).max()


def test_sigmoid_cross_entropy_loss_matches_sad_tpu():
    rng = np.random.RandomState(2)
    x = (rng.randn(3, 7, 9) * 4).astype(np.float32)
    t = rng.randint(-1, 2, x.shape).astype(np.int32)

    def loss(v):
        return D.sigmoid_cross_entropy_loss(v, jnp.asarray(t), scale=1.3)

    ref = float(jax.jit(loss)(jnp.asarray(x)))
    gref = np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = T.sigmoid_cross_entropy_loss(xt, torch.from_numpy(t), scale=1.3)
    assert abs(float(got.detach()) - ref) <= 1e-6 * abs(ref)
    got.backward()
    assert np.abs(xt.grad.numpy() - gref).max() <= 1e-6 * np.abs(gref).max()
    # all ignored: the count clamps to 1 and the loss is 0
    assert float(T.sigmoid_cross_entropy_loss(xt.detach(), torch.full(x.shape, -1))) == 0.0


def _elementwise_cases():
    rng = np.random.RandomState(3)
    x4 = rng.randn(4, 6, 5, 3).astype(np.float32)  # NHWC
    x2 = rng.randn(5, 3).astype(np.float32)
    s, b = rng.uniform(0.5, 1.5, 3).astype(np.float32), rng.randn(3).astype(np.float32)
    perm = np.array([2, 0, 3, 1], np.int32)
    labels = np.array([0, 3, 0, 1, 2, 0, 5], np.int32)
    rows = rng.randn(7, 2, 3).astype(np.float32)
    y4 = rng.randn(*x4.shape).astype(np.float32)
    return {
        "batch_permutation": (lambda: D.batch_permutation(jnp.asarray(x4), jnp.asarray(perm)),
                              lambda: _nhwc(T.batch_permutation(_nchw(x4), torch.from_numpy(
                                  perm)))),
        "zero_even": (lambda: D.zero_even(jnp.asarray(x2)),
                      lambda: T.zero_even(torch.from_numpy(x2)).numpy()),
        "spatial_narrow_as": (lambda: D.spatial_narrow_as(jnp.asarray(x4), x4[:, :4, :3]),
                              lambda: _nhwc(T.spatial_narrow_as(_nchw(x4),
                                                                _nchw(x4[:, :4, :3])))),
        "upsample_nearest": (lambda: D.upsample_nearest(jnp.asarray(x4), 3),
                             lambda: _nhwc(T.upsample_nearest(_nchw(x4), 3))),
        "spatial_sigmoid": (lambda: D.spatial_sigmoid(jnp.asarray(x4)),
                            lambda: _nhwc(T.spatial_sigmoid(_nchw(x4)))),
        "spatial_l2_loss": (lambda: D.spatial_l2_loss(jnp.asarray(x4), jnp.asarray(y4), 0.7),
                            lambda: T.spatial_l2_loss(_nchw(x4), _nchw(y4), 0.7).numpy()),
        "affine_channel": (lambda: D.affine_channel(jnp.asarray(x4), jnp.asarray(s),
                                                    jnp.asarray(b)),
                           lambda: _nhwc(T.affine_channel(_nchw(x4), torch.from_numpy(s),
                                                          torch.from_numpy(b)))),
        "sample_as": (lambda: D.sample_as(jnp.asarray(rows), jnp.asarray(labels), 5),
                      lambda: tuple(v.numpy() for v in T.sample_as(
                          torch.from_numpy(rows), torch.from_numpy(labels), 5))),
        "sample_as_short": (lambda: D.sample_as(jnp.asarray(rows), jnp.asarray(labels), 3),
                            lambda: tuple(v.numpy() for v in T.sample_as(
                                torch.from_numpy(rows), torch.from_numpy(labels), 3))),
    }


@pytest.mark.parametrize("name", sorted(_elementwise_cases()))
def test_elementwise_op_matches_sad_tpu(name):
    ref_fn, got_fn = _elementwise_cases()[name]
    ref, got = ref_fn(), got_fn()
    for r, g in zip(jax.tree_util.tree_leaves(ref), jax.tree_util.tree_leaves(got)):
        r, g = np.asarray(r), np.asarray(g)
        assert r.shape == g.shape and r.dtype == g.dtype, (name, r.shape, g.shape)
        np.testing.assert_allclose(g, r, rtol=1e-6, atol=0)


def test_affine_channel_gradient_reaches_x_only():
    x = torch.randn(2, 3, 4, 4, requires_grad=True)
    s = torch.rand(3, requires_grad=True)
    b = torch.randn(3, requires_grad=True)
    T.affine_channel(x, s, b).sum().backward()
    assert s.grad is None and b.grad is None
    assert torch.equal(x.grad, s.detach().view(1, 3, 1, 1).expand(2, 3, 4, 4))


@pytest.mark.parametrize("poly,box,res", [
    ([[0, 0, 20, 0, 20, 20, 0, 20]], [0, 0, 20, 20], 14),
    ([[3.5, 2.0, 30.2, 8.7, 17.1, 25.9], [1, 1, 4, 1, 4, 4]], [2.5, 1.0, 28.0, 24.0], 28),
    ([[10, 10, 11, 10, 11, 11]], [10.0, 10.0, 10.5, 10.5], 7),
])
def test_polys_to_mask_wrt_box_matches_sad_tpu(poly, box, res):
    ref = j_segms.polys_to_mask_wrt_box(poly, np.asarray(box), res)
    got = t_segms.polys_to_mask_wrt_box(poly, np.asarray(box), res)
    assert got.dtype == ref.dtype and got.shape == (res, res)
    np.testing.assert_array_equal(got, ref)


def test_the_package_exports_the_op_library():
    """sad_tpu_torch.ops exports the op library beside its submodules: its
    ``roi_align`` stays the multilevel RoIAlign module, which callers import
    from the package."""
    import types

    from sad_tpu_torch.ops import detectron_ops, roi_align

    assert isinstance(roi_align, types.ModuleType) and hasattr(roi_align,
                                                              "multilevel_roi_align_plain")
    for name in ("roi_pool", "group_spatial_softmax", "sigmoid_cross_entropy_loss",
                 "batch_permutation", "sample_as", "spatial_narrow_as", "spatial_l2_loss",
                 "spatial_sigmoid", "affine_channel", "upsample_nearest", "zero_even"):
        assert name in T.__all__ and getattr(T, name) is getattr(detectron_ops, name), name
