"""The port's RoIAlign backward (its plain version, and autograd through its
plain forward: on this CPU the wrapper takes them because the tensors lie on
the CPU) against ``jax.grad`` through sad_tpu's multilevel RoIAlign: the
dense tent-matmul form, and against the read-modify-write Pallas kernel
``_mlra_bwd_kernel`` run in interpret mode through ``_windowed_backward``.

Tolerance at float32: 1e-5 * max|ref| + 1e-6 (the port adds 16 taps a bin
one after another, sad_tpu contracts transposed weight matrices). At
bfloat16 the port keeps float32 sums and rounds once: half a bf16 ulp (2^-8
relative) of the float32 result, plus 1e-5 * max|ref| where a sum cancels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sad_tpu.ops import pallas_roi_align
from sad_tpu.ops.proposals import dense_multilevel_roi_align
from sad_tpu_torch.ops import roi_align_kernel
from sad_tpu_torch.ops.roi_align import (
    multilevel_roi_align, multilevel_roi_align_bwd_plain, multilevel_roi_align_plain,
)
from test_torch_models import one_torch_thread  # noqa: F401  (autouse)


def case(seed=0, b=2, c=8, canvas=(128, 192), r=12, res=7):
    """Rois on every level P2..P5 (levels given, not derived), one wholly
    outside the map, one of zero area, one on the last row and column, a
    fifth invalid; and the weights of a weighted sum of the output."""
    rng = np.random.RandomState(seed)
    hc, wc = canvas
    feats = {l: rng.randn(b, hc >> l, wc >> l, c).astype(np.float32) for l in (2, 3, 4, 5)}
    x1, y1 = rng.uniform(0, wc * 0.7, r), rng.uniform(0, hc * 0.7, r)
    w, h = rng.uniform(4, wc * 0.6, r), rng.uniform(4, hc * 0.6, r)
    rois = np.stack([np.sort(rng.randint(0, b, r)).astype(np.float32), x1, y1,
                     np.minimum(x1 + w, wc - 1), np.minimum(y1 + h, hc - 1)], 1).astype(np.float32)
    rois[0, 1:] = [10.0, 10.0, 10.0, 10.0]
    rois[1, 1:] = [-300.0, -200.0, -250.0, -150.0]
    rois[2, 1:] = [wc - 40.0, hc - 30.0, wc - 1.0, hc - 1.0]
    levels = (2 + np.arange(r) % 4).astype(np.int32)
    valid = np.ones(r, bool)
    valid[3::5] = False
    weights = rng.randn(r, res, res, c).astype(np.float32)
    return feats, rois, levels, valid, weights


def jax_grads(fn, feats, rois, levels, valid, weights, res, sr=2, dtype=jnp.float32):
    jf = {l: jnp.asarray(f).astype(dtype) for l, f in feats.items()}

    def loss(fd):
        out = fn(fd, jnp.asarray(rois), jnp.asarray(levels), jnp.asarray(valid), res, sr)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(weights))

    return {l: np.asarray(g.astype(jnp.float32)) for l, g in jax.grad(loss)(jf).items()}


def port_grads(feats, rois, levels, valid, weights, res, sr=2, dtype=torch.float32):
    """(plain backward, autograd through the wrapper's CPU path)."""
    tf = {l: torch.from_numpy(f).to(dtype).requires_grad_(True) for l, f in feats.items()}
    args = (torch.from_numpy(rois), torch.from_numpy(levels), torch.from_numpy(valid))
    g = torch.from_numpy(weights).to(dtype)
    plain = multilevel_roi_align_bwd_plain(
        g, {l: f.shape[1:3] for l, f in feats.items()}, feats[2].shape[0], *args, sr)
    out = multilevel_roi_align(tf, *args, res, sr)
    auto = torch.autograd.grad(out, [tf[l] for l in sorted(tf)], g)
    return ({l: p.float().numpy() for l, p in plain.items()},
            {l: a.float().numpy() for l, a in zip(sorted(tf), auto)})


def assert_close(got, ref):
    ref_max = max(np.abs(r).max() for r in ref.values())
    assert ref_max > 0.1
    for l in ref:
        assert got[l].shape == ref[l].shape
        err = np.abs(got[l] - ref[l])
        assert (err <= 1e-5 * ref_max + 1e-6).all(), (l, err.max(), ref_max)


@pytest.mark.parametrize("res,sr", [(7, 2), (14, 2), (7, 1), (7, 3)])
def test_plain_backward_matches_jax_grad_of_the_dense_form(res, sr):
    feats, rois, levels, valid, weights = case(seed=res + sr, res=res)
    ref = jax_grads(dense_multilevel_roi_align, feats, rois, levels, valid, weights, res, sr)
    plain, auto = port_grads(feats, rois, levels, valid, weights, res, sr)
    assert_close(plain, ref)
    assert_close(auto, ref)
    assert all(np.abs(ref[l]).max() > 0 for l in ref)  # every level got a roi


def test_plain_backward_matches_the_interpreted_rmw_kernel():
    """``_windowed_backward``, the function that launches _mlra_bwd_kernel
    (in interpret mode on the CPU), on the same cotangent; kept tiny: the
    interpreter pays per roi."""
    feats, rois, levels, valid, weights = case(seed=5, canvas=(256, 256), r=5)
    ref = pallas_roi_align._windowed_backward(
        {l: jnp.asarray(f) for l, f in feats.items()}, jnp.asarray(rois), jnp.asarray(levels),
        jnp.asarray(valid), 7, 2, jnp.asarray(weights))
    ref = {l: np.asarray(g) for l, g in ref.items()}
    plain, auto = port_grads(feats, rois, levels, valid, weights, 7)
    assert_close(plain, ref)
    assert_close(auto, ref)


def test_bf16_features_round_once():
    """RoIAlign is linear in the features, so its gradient depends on the
    cotangent alone: the bf16 result must be the float32 gradient of the same
    (bf16-valued) cotangent rounded once, i.e. within half a bf16 ulp (2^-8
    relative) of jax.grad's float32 result, plus 1e-5 * max|ref|."""
    feats, rois, levels, valid, weights = case(seed=6)
    g = torch.from_numpy(weights).to(torch.bfloat16)
    ref = jax_grads(dense_multilevel_roi_align, feats, rois, levels, valid,
                    g.float().numpy(), 7)
    plain = multilevel_roi_align_bwd_plain(
        g, {l: f.shape[1:3] for l, f in feats.items()}, 2, torch.from_numpy(rois),
        torch.from_numpy(levels), torch.from_numpy(valid), 2)
    assert all(p.dtype == torch.bfloat16 for p in plain.values())
    ref_max = max(np.abs(r).max() for r in ref.values())
    for l in ref:
        got = plain[l].float().numpy()
        assert (np.abs(got - ref[l]) <= 2.0 ** -8 * np.abs(ref[l]) + 1e-5 * ref_max).all(), l
    # and autograd through the bf16 forward hands back bf16 gradients
    tf = {l: torch.from_numpy(f).to(torch.bfloat16).requires_grad_(True)
          for l, f in feats.items()}
    out = multilevel_roi_align(tf, torch.from_numpy(rois), torch.from_numpy(levels),
                               torch.from_numpy(valid), 7, 2)
    auto = torch.autograd.grad(out, list(tf.values()), g)
    assert all(a.dtype == torch.bfloat16 for a in auto)


def test_two_plain_backwards_agree_and_invalid_rois_add_nothing():
    feats, rois, levels, valid, weights = case(seed=7)
    plain, auto = port_grads(feats, rois, levels, valid, weights, 7)
    assert_close(plain, auto)
    none_valid = np.zeros_like(valid)
    plain0, auto0 = port_grads(feats, rois, levels, none_valid, weights, 7)
    assert all((p == 0).all() for p in plain0.values())
    assert all((a == 0).all() for a in auto0.values())
    # dropping the invalid rois changes nothing
    keep = valid
    plain_k, _ = port_grads(feats, rois[keep], levels[keep], valid[keep], weights[keep], 7)
    for l in plain:
        np.testing.assert_array_equal(plain[l], plain_k[l])


def test_no_gradient_reaches_the_rois_and_cpu_never_launches():
    feats, rois, levels, valid, weights = case(seed=8)
    tf = {l: torch.from_numpy(f).requires_grad_(True) for l, f in feats.items()}
    trois = torch.from_numpy(rois).requires_grad_(True)
    before = roi_align_kernel.launches, roi_align_kernel.bwd_launches
    out = multilevel_roi_align(tf, trois, torch.from_numpy(levels), torch.from_numpy(valid), 7, 2)
    (out * torch.from_numpy(weights)).sum().backward()
    assert trois.grad is None and all(f.grad is not None for f in tf.values())
    assert (roi_align_kernel.launches, roi_align_kernel.bwd_launches) == before
    ref = multilevel_roi_align_plain({l: f.detach() for l, f in tf.items()}, trois.detach(),
                                     torch.from_numpy(levels), torch.from_numpy(valid), 7, 2)
    assert torch.equal(out.detach(), ref)


def test_backward_wrapper_refuses_cpu_tensors_and_bad_levels():
    feats, rois, levels, valid, weights = case(seed=9)
    before = roi_align_kernel.bwd_launches
    with pytest.raises(ValueError, match="CUDA"):
        roi_align_kernel.roi_align_bwd_cuda(
            torch.from_numpy(weights), [f.shape[1:3] for f in feats.values()], 2, 2,
            torch.from_numpy(rois), torch.from_numpy(levels), torch.from_numpy(valid), 2)
    assert roi_align_kernel.bwd_launches == before
    with pytest.raises(ValueError, match="consecutive"):
        multilevel_roi_align_bwd_plain(
            torch.from_numpy(weights), {2: (32, 48), 4: (8, 12)}, 2, torch.from_numpy(rois),
            torch.from_numpy(levels), torch.from_numpy(valid), 2)
