"""The R-CNN training losses of the port against sad_tpu's, values and
gradients, float32 on the CPU: ``smooth_l1_loss``, ``rpn_losses``,
``fast_rcnn_losses`` (n_groups 1 and 2), ``mask_targets_on_device`` and
``mask_loss``. Values within 1e-5 relative + 1e-7, gradients within 1e-5 of
their largest entry + 1e-8 (reductions sum in other orders). Mask targets
are binary and must be equal."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sad_tpu.config as jcfg
import sad_tpu_torch.config as tcfg
from sad_tpu.ops.losses import smooth_l1_loss as j_smooth_l1
from sad_tpu.train import mask_keypoint as jmk
from sad_tpu.train import rcnn_train as jrt
from sad_tpu_torch.config.config import merge_cfg_from_dict as t_merge
from sad_tpu_torch.ops.losses import smooth_l1_loss
from sad_tpu_torch.train import mask_keypoint as tmk
from sad_tpu_torch.train import rcnn_train as trt
from test_torch_models import one_torch_thread  # noqa: F401  (autouse)


def close(got, ref, rel=1e-5, abs_=1e-7):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rel * np.abs(ref).max() + abs_, (got, ref)


def grad_close(got, ref):
    close(got, ref, rel=1e-5, abs_=1e-8)
    assert np.abs(np.asarray(ref)).max() > 0


@pytest.mark.parametrize("beta,scale", [(1.0, 1.0), (1.0 / 9.0, 1.0), (0.5, 2.5)])
def test_smooth_l1_loss(beta, scale):
    rng = np.random.RandomState(0)
    y_hat, y = rng.randn(6, 5, 4).astype(np.float32), rng.randn(6, 5, 4).astype(np.float32)
    y_hat[0] = y[0] + 0.01  # inside the quadratic zone
    w_in = (rng.rand(6, 5, 4) > 0.4).astype(np.float32)
    w_out = rng.rand(6, 5, 4).astype(np.float32)
    ref, gref = jax.jit(jax.value_and_grad(
        lambda p: j_smooth_l1(p, jnp.asarray(y), jnp.asarray(w_in), jnp.asarray(w_out),
                              beta=beta, scale=scale)))(jnp.asarray(y_hat))
    p = torch.from_numpy(y_hat).requires_grad_(True)
    got = smooth_l1_loss(p, torch.from_numpy(y), torch.from_numpy(w_in), torch.from_numpy(w_out),
                         beta=beta, scale=scale)
    got.backward()
    close(got.detach().numpy(), ref)
    grad_close(p.grad.numpy(), gref)


def _rpn_case(seed=1, b=3, a=3):
    rng = np.random.RandomState(seed)
    hw = {2: (6, 8), 3: (3, 4), 4: (2, 2)}
    logits = {l: (3 * rng.randn(b, h, w, a)).astype(np.float32) for l, (h, w) in hw.items()}
    deltas = {l: rng.randn(b, h, w, 4 * a).astype(np.float32) for l, (h, w) in hw.items()}
    labels = {l: rng.randint(-1, 2, (b, h, w, a)).astype(np.int32) for l, (h, w) in hw.items()}
    batch = {"rpn_labels": labels,
             "rpn_bbox_targets": {l: rng.randn(b, h, w, a, 4).astype(np.float32)
                                  for l, (h, w) in hw.items()},
             "rpn_bbox_inside_weights": {l: (labels[l] == 1)[..., None].repeat(4, -1)
                                         .astype(np.float32) for l in hw},
             "rpn_bbox_outside_weights": {l: ((labels[l] >= 0)[..., None].repeat(4, -1) / 37.0)
                                          .astype(np.float32) for l in hw}}
    return logits, deltas, batch


def test_rpn_losses():
    logits, deltas, batch = _rpn_case()
    jc, tc = jcfg.Config(), tcfg.Config()
    to_j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    (ref, ref_m), (g_lg, g_dl) = jax.jit(jax.value_and_grad(  # one compile, not eager
        lambda lg, dl: jrt.rpn_losses(jc, lg, dl, to_j(batch), 1), argnums=(0, 1),
        has_aux=True))(to_j(logits), to_j(deltas))
    to_t = lambda t: jax.tree_util.tree_map(torch.from_numpy, t)
    lg = {l: torch.from_numpy(v).requires_grad_(True) for l, v in logits.items()}
    dl = {l: torch.from_numpy(v).requires_grad_(True) for l, v in deltas.items()}
    got, got_m = trt.rpn_losses(tc, lg, dl, to_t(batch))
    got.backward()
    close(got.detach().numpy(), ref)
    assert sorted(got_m) == sorted(ref_m)
    for k in ref_m:
        close(got_m[k].detach().numpy(), ref_m[k])
    for l in logits:
        grad_close(lg[l].grad.numpy(), g_lg[l])
        grad_close(dl[l].grad.numpy(), g_dl[l])


@pytest.mark.parametrize("n_groups", [1, 2])
def test_fast_rcnn_losses(n_groups):
    rng = np.random.RandomState(2)
    r, c = 12, 5
    cls_score = (2 * rng.randn(r, c)).astype(np.float32)
    bbox_pred = rng.randn(r, 4 * c).astype(np.float32)
    labels = rng.randint(-1, c, r).astype(np.int32)
    labels[:6] = [2, 0, -1, 1, 0, 0]  # group 0 differs from group 1 in its live count
    valid = labels >= 0
    valid[7] = False
    tgt = rng.randn(r, 4 * c).astype(np.float32)
    w = np.zeros((r, c, 4), np.float32)
    for i in np.where(labels > 0)[0]:
        w[i, labels[i]] = 1.0
    w = w.reshape(r, -1)
    jc, tc = jcfg.Config(), tcfg.Config()
    (ref, ref_m), (g_cls, g_box) = jax.jit(jax.value_and_grad(
        lambda s, p: jrt.fast_rcnn_losses(
            jc, s, jnp.asarray(labels), p, jnp.asarray(tgt), jnp.asarray(w), jnp.asarray(w),
            jnp.asarray(valid), n_groups, n_images=2), argnums=(0, 1), has_aux=True))(
        jnp.asarray(cls_score), jnp.asarray(bbox_pred))
    s = torch.from_numpy(cls_score).requires_grad_(True)
    p = torch.from_numpy(bbox_pred).requires_grad_(True)
    got, got_m = trt.fast_rcnn_losses(
        tc, s, torch.from_numpy(labels), p, torch.from_numpy(tgt), torch.from_numpy(w),
        torch.from_numpy(w), torch.from_numpy(valid), n_groups)
    got.backward()
    close(got.detach().numpy(), ref)
    assert sorted(got_m) == sorted(ref_m) == ["accuracy_cls", "loss_bbox", "loss_cls"]
    for k in ref_m:
        close(got_m[k].detach().numpy(), ref_m[k])
    grad_close(s.grad.numpy(), g_cls)
    grad_close(p.grad.numpy(), g_box)


def _mask_scene(seed, b=2, g=3, stride=4, hm=24, wm=32):
    """Blocky gt rasters (rectangles and an ellipse) and rois around them."""
    rng = np.random.RandomState(seed)
    rast = np.zeros((b, g, hm, wm), np.float32)
    yy, xx = np.mgrid[:hm, :wm]
    boxes = np.zeros((b, g, 4), np.float32)
    for i in range(b):
        for j in range(g):
            y0, x0 = rng.randint(0, hm - 8), rng.randint(0, wm - 8)
            h, w = rng.randint(4, 8), rng.randint(4, 8)
            if j == 0:
                rast[i, j] = (((yy - y0 - h / 2) / (h / 2)) ** 2
                              + ((xx - x0 - w / 2) / (w / 2)) ** 2) <= 1.0
            else:
                rast[i, j, y0:y0 + h, x0:x0 + w] = 1.0
            boxes[i, j] = np.array([x0, y0, x0 + w, y0 + h], np.float32) * stride
    r = 7
    matched = rng.randint(0, g, (b, r))
    rois = np.take_along_axis(boxes, matched[..., None], 1) + rng.uniform(-9.3, 9.3, (b, r, 4))
    return rast, rois.astype(np.float32), matched.astype(np.int32)


@pytest.mark.parametrize("stride,res", [(4, 14), (8, 7), (4, 28)])
def test_mask_targets_on_device(stride, res):
    rast, rois, matched = _mask_scene(seed=stride + res, stride=stride)
    ref = np.stack([np.asarray(jmk.mask_targets_on_device(
        jnp.asarray(rast[i]), jnp.asarray(rois[i]), jnp.asarray(matched[i]), res, float(stride)))
        for i in range(rast.shape[0])])
    got = tmk.mask_targets_on_device(torch.from_numpy(rast), torch.from_numpy(rois),
                                     torch.from_numpy(matched), res, float(stride))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2 * 7, res, res)
    got = got.numpy().reshape(ref.shape)
    assert set(np.unique(got)) <= {0.0, 1.0} and 0.05 < got.mean() < 0.95
    np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError, match="power of two"):
        tmk.mask_targets_on_device(torch.from_numpy(rast), torch.from_numpy(rois),
                                   torch.from_numpy(matched), res, 6.0)


@pytest.mark.parametrize("n_groups", [1, 2])
@pytest.mark.parametrize("cls_specific", [True, False])
def test_mask_loss(n_groups, cls_specific):
    rng = np.random.RandomState(5)
    r, m, c = 8, 6, 5 if cls_specific else 1
    logits = (2 * rng.randn(r, m, m, c)).astype(np.float32)
    targets = (rng.rand(r, m, m) > 0.5).astype(np.float32)
    labels = rng.randint(0, 5, r).astype(np.int32)
    is_fg = labels > 0
    is_fg[:4] = [True, False, False, False]  # uneven fg counts between the groups
    cfg = SimpleNamespace(MRCNN=SimpleNamespace(CLS_SPECIFIC_MASK=cls_specific,
                                                WEIGHT_LOSS_MASK=1.5))
    ref, gref = jax.jit(jax.value_and_grad(lambda x: jmk.mask_loss(
        cfg, x, jnp.asarray(targets), jnp.asarray(labels), jnp.asarray(is_fg), n_groups)))(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = tmk.mask_loss(cfg, x, torch.from_numpy(targets), torch.from_numpy(labels),
                        torch.from_numpy(is_fg), n_groups)
    got.backward()
    close(got.detach().numpy(), ref)
    grad_close(x.grad.numpy(), gref)
