"""The port's multilevel RoIAlign (its plain twin: on this CPU the wrapper
takes it because the tensors lie on the CPU) against sad_tpu's: the windowed
Pallas kernel run in interpret mode and the dense tent-matmul form, on the
fixture shapes of tests/test_pallas_roi_align.py.

Tolerance at float32: 1e-5 * max|ref| + 1e-6 (the twin sums 16 taps a bin
one after another, sad_tpu contracts per-axis weight sums in two matmuls).
At bfloat16 both keep float32 sums and round once: within one bf16 ulp
(2^-8 relative) of the float32 result's magnitude."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sad_tpu.ops import pallas_roi_align
from sad_tpu.ops.pallas_roi_align import multilevel_roi_align_windowed
from sad_tpu.ops.proposals import dense_multilevel_roi_align
from sad_tpu.ops.proposals import map_rois_to_fpn_levels as j_map_levels
from sad_tpu_torch.ops import roi_align_kernel
from sad_tpu_torch.ops.proposals import multilevel_roi_align as reexported
from sad_tpu_torch.ops.roi_align import multilevel_roi_align, multilevel_roi_align_plain
from test_torch_models import one_torch_thread  # noqa: F401  (autouse)


def fixture_inputs(seed=0, b=2, c=8, canvas=(256, 384), thin=False):
    """tests/test_pallas_roi_align.py:24-56: small, large, extreme-aspect and
    degenerate rois over P2..P5, image-major batch column, some invalid.
    ``thin`` keeps every other roi and the three special ones (12 of 21), for
    the interpreted Pallas kernel, which pays per roi."""
    rng = np.random.RandomState(seed)
    hc, wc = canvas
    feats = {l: rng.randn(b, hc // 2 ** l, wc // 2 ** l, c).astype(np.float32)
             for l in (2, 3, 4, 5)}
    r = 21
    x1 = rng.uniform(0, wc * 0.8, r)
    y1 = rng.uniform(0, hc * 0.8, r)
    w = np.concatenate([rng.uniform(6, 40, 8), rng.uniform(100, 300, 5),
                        rng.uniform(2, 6, 4), rng.uniform(200, 370, 4)])
    h = np.concatenate([rng.uniform(6, 40, 8), rng.uniform(100, 200, 5),
                        rng.uniform(150, 250, 4), rng.uniform(1, 4, 4)])
    rois = np.stack([np.sort(rng.randint(0, b, r)).astype(np.float32), x1, y1,
                     np.minimum(x1 + w, wc - 1), np.minimum(y1 + h, hc - 1)],
                    axis=1).astype(np.float32)
    rois[-1, 1:] = [10.0, 10.0, 10.0, 10.0]  # zero area -> the 1-cell-bin rule
    rois[-2, 1:] = [-300.0, -200.0, -250.0, -150.0]  # wholly outside the map
    rois[-3, 1:] = [wc - 40.0, hc - 30.0, wc - 1.0, hc - 1.0]  # last row and column
    levels = np.array(j_map_levels(jnp.asarray(rois[:, 1:]), 2, 5))
    valid = rng.rand(r) > 0.15
    if thin:
        keep = np.r_[0:18:2, 18:21]
        rois, levels, valid = rois[keep], levels[keep], valid[keep]
    return feats, rois, levels, valid


def _torch(feats, rois, levels, valid, dtype=torch.float32):
    return ({l: torch.from_numpy(f).to(dtype) for l, f in feats.items()},
            torch.from_numpy(rois), torch.from_numpy(levels), torch.from_numpy(valid))


def _jax(feats, rois, levels, valid, dtype=jnp.float32):
    return ({l: jnp.asarray(f).astype(dtype) for l, f in feats.items()},
            jnp.asarray(rois), jnp.asarray(levels), jnp.asarray(valid))


@pytest.mark.parametrize("res", [7, 14])
@pytest.mark.parametrize("ref_form", ["windowed_interpreted", "dense"])
def test_plain_twin_matches_sad_tpu_f32(res, ref_form, monkeypatch):
    inputs = fixture_inputs(thin=ref_form != "dense")
    if ref_form == "dense":
        ref = dense_multilevel_roi_align(*_jax(*inputs), res, 2)
    else:
        monkeypatch.setattr(pallas_roi_align, "USE_PALLAS_ROI_ALIGN", True)
        ref = multilevel_roi_align_windowed(*_jax(*inputs), res, 2)
    ref = np.asarray(ref)
    got = multilevel_roi_align(*_torch(*inputs), res, 2)
    assert got.dtype == torch.float32 and tuple(got.shape) == (len(inputs[1]), res, res, 8)
    err = np.abs(got.numpy() - ref).max()
    assert err <= 1e-5 * np.abs(ref).max() + 1e-6, err
    valid = inputs[3]
    assert (got.numpy()[~valid] == 0).all() and np.abs(got.numpy()[valid]).max() > 0.1


def test_plain_twin_matches_windowed_bf16(monkeypatch):
    inputs = fixture_inputs(seed=1, thin=True)
    monkeypatch.setattr(pallas_roi_align, "USE_PALLAS_ROI_ALIGN", True)
    ref = multilevel_roi_align_windowed(*_jax(*inputs, dtype=jnp.bfloat16), 7, 2)
    assert ref.dtype == jnp.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    got = multilevel_roi_align(*_torch(*inputs, dtype=torch.bfloat16), 7, 2)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    # both round a float32 sum once: at most one bf16 ulp apart
    assert (np.abs(got - ref) <= 2.0 ** -8 * np.maximum(np.abs(ref), 2.0 ** -6)).all()
    assert (got == ref).mean() > 0.98


@pytest.mark.parametrize("sr", [1, 3])
def test_other_sampling_ratios_match_dense(sr):
    inputs = fixture_inputs(seed=2)
    ref = np.asarray(dense_multilevel_roi_align(*_jax(*inputs), 7, sr))
    got = multilevel_roi_align(*_torch(*inputs), 7, sr).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max() + 1e-6


def test_tiny_top_level_and_odd_channels():
    """A 1x2 top level and C = 3: shapes sad_tpu's windowed kernel refuses
    (it degrades to the dense form there); the port has one path for all."""
    rng = np.random.RandomState(3)
    feats = {l: rng.randn(1, 8 >> (l - 2), 16 >> (l - 2), 3).astype(np.float32)
             for l in (2, 3, 4, 5)}
    assert feats[5].shape[1:3] == (1, 2)
    rois = np.array([[0, 0, 0, 63, 31], [0, 5, 3, 40, 20], [0, 30, 2, 33, 29],
                     [0, 60, 28, 63, 31]], np.float32)
    levels = np.array([5, 4, 3, 2], np.int32)
    valid = np.ones(4, bool)
    ref = np.asarray(dense_multilevel_roi_align(*_jax(feats, rois, levels, valid), 7, 2))
    got = multilevel_roi_align(*_torch(feats, rois, levels, valid), 7, 2).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max() + 1e-6


def test_constant_maps_select_the_rois_level():
    feats = {2: torch.full((1, 16, 16, 2), 2.0), 3: torch.full((1, 8, 8, 2), 3.0)}
    rois = torch.tensor([[0, 0, 0, 31, 31], [0, 0, 0, 31, 31]], dtype=torch.float32)
    out = multilevel_roi_align(feats, rois, torch.tensor([2, 3], dtype=torch.int32),
                               torch.tensor([True, True]), 2, 2)
    assert torch.equal(out[0], torch.full((2, 2, 2), 2.0))
    assert torch.equal(out[1], torch.full((2, 2, 2), 3.0))


def test_batch_column_is_read():
    """The port always reads the rois' batch column (sad_tpu's slots_per_im
    path ignores it): rois in an order that is not image-major still pool
    from their own image."""
    rng = np.random.RandomState(4)
    feats = {2: torch.from_numpy(rng.randn(3, 16, 16, 4).astype(np.float32))}
    box = [4.0, 6.0, 40.0, 50.0]
    rois = torch.tensor([[2.0, *box], [0.0, *box], [1.0, *box]])
    lv, ok = torch.full((3,), 2, dtype=torch.int32), torch.ones(3, dtype=torch.bool)
    out = multilevel_roi_align(feats, rois, lv, ok, 7, 2)
    for slot, image in enumerate((2, 0, 1)):
        alone = multilevel_roi_align({2: feats[2][image:image + 1]},
                                     torch.tensor([[0.0, *box]]), lv[:1], ok[:1], 7, 2)
        assert torch.equal(out[slot], alone[0])


def test_dispatch_and_reexport():
    assert reexported is multilevel_roi_align
    inputs = _torch(*fixture_inputs())
    before = roi_align_kernel.launches
    assert torch.equal(multilevel_roi_align(*inputs, 7, 2),
                       multilevel_roi_align_plain(*inputs, 7, 2))
    assert roi_align_kernel.launches == before  # CPU tensors never reach the kernel
    meta = ({l: f.to("meta") for l, f in inputs[0].items()}, *(t.to("meta") for t in inputs[1:]))
    with pytest.raises(ValueError, match="no path"):
        multilevel_roi_align(*meta, 7, 2)
    with pytest.raises(ValueError, match="consecutive"):
        multilevel_roi_align({2: inputs[0][2], 4: inputs[0][4]}, *inputs[1:], 7, 2)


def test_cuda_wrapper_refuses_cpu_tensors():
    feats, rois, levels, valid = _torch(*fixture_inputs())
    before = roi_align_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        roi_align_kernel.roi_align_fwd_cuda([feats[l] for l in (2, 3, 4, 5)], 2, rois, levels,
                                            valid, 7, 2)
    assert roi_align_kernel.launches == before
