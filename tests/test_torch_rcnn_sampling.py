"""The port's ``sample_proposal_labels`` (batched over images) against
sad_tpu's (one image, under vmap in its step), with the uniforms that JAX
draws handed to the port. On slots that are valid: labels, is_fg, valid and
matched_gt exactly, rois and targets within 1e-6 (absolute, on values of
order 1..100 px and 0..10); pad slots may hold other boxes. Also
``bbox_overlaps`` and ``bbox_transform_inv`` against sad_tpu's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sad_tpu.ops import box_transforms as jbox
from sad_tpu.ops.proposals import sample_proposal_labels as j_sample
from sad_tpu.ops.proposals import sampled_fg_cap as j_fg_cap
from sad_tpu_torch.ops import box_transforms as tbox
from sad_tpu_torch.ops.proposals import sample_proposal_labels, sampled_fg_cap
from test_torch_models import one_torch_thread  # noqa: F401  (autouse)

ARGS = dict(batch_size_per_im=16, fg_fraction=0.25, fg_thresh=0.5, bg_thresh_hi=0.5,
            bg_thresh_lo=0.0, num_classes=5)


def boxes_near(rng, gt, n, jitter):
    """n boxes: the gt boxes in turn, moved by up to ``jitter`` px."""
    b = gt[rng.randint(0, len(gt), n)] + rng.uniform(-jitter, jitter, (n, 4))
    # well-formed, as the RPN's clipped and size-filtered proposals are
    lo, hi = np.minimum(b[:, :2], b[:, 2:]), np.maximum(b[:, :2], b[:, 2:]) + 1.0
    return np.concatenate([lo, hi], axis=1).astype(np.float32)


def scene(kind, seed, p=40, g=6):
    rng = np.random.RandomState(seed)
    n_gt = {"no_gt": 0}.get(kind, 3)
    xy = rng.uniform(0, 150, (g, 2))
    gt = np.concatenate([xy, xy + rng.uniform(20, 80, (g, 2))], 1).astype(np.float32)
    cls = np.zeros(g, np.int32)
    cls[:n_gt] = rng.randint(1, 5, n_gt)
    gt[n_gt:] = 0.0
    if kind == "fg_cap":  # many proposals on the gt boxes: more fg than the cap
        props = boxes_near(rng, gt[:n_gt], p, 4.0)
    elif kind == "no_fg":  # proposals far from every gt box
        props = boxes_near(rng, gt[:n_gt] + 400.0, p, 4.0)
    else:
        props = np.concatenate([boxes_near(rng, gt[:max(n_gt, 1)], p // 4, 6.0),
                                boxes_near(rng, gt[:max(n_gt, 1)], p - p // 4, 60.0)])
    valid = rng.rand(p) > 0.1
    if kind == "all_invalid":
        valid[:] = False
    return props, valid, gt, cls


KINDS = ["mixed", "fg_cap", "no_fg", "no_gt", "all_invalid"]


@pytest.fixture(scope="module")
def jitted():
    return jax.jit(lambda key, *a: j_sample(key, *a, **ARGS))


@pytest.mark.parametrize("seed", [0, 1])
def test_sample_matches_sad_tpu_with_jax_uniforms(jitted, seed):
    scenes = [scene(k, seed * 10 + i) for i, k in enumerate(KINDS)]
    keys = jax.random.split(jax.random.PRNGKey(seed), len(scenes))
    refs, u_fg, u_bg = [], [], []
    for key, sc in zip(keys, scenes):
        refs.append({k: np.asarray(v) for k, v in
                     jitted(key, *(jnp.asarray(a) for a in sc)).items()})
        r1, r2 = jax.random.split(key)
        n = sc[0].shape[0] + sc[2].shape[0]
        u_fg.append(np.asarray(jax.random.uniform(r1, (n,))))
        u_bg.append(np.asarray(jax.random.uniform(r2, (n,))))
    batch = [torch.from_numpy(np.stack([sc[i] for sc in scenes])) for i in range(4)]
    got = sample_proposal_labels(
        *batch, **ARGS,
        uniforms=(torch.from_numpy(np.stack(u_fg)), torch.from_numpy(np.stack(u_bg))))
    got = {k: v.numpy() for k, v in got.items()}
    assert sorted(got) == sorted(refs[0])
    fg_cap = sampled_fg_cap(16, 0.25)
    for i, (kind, ref) in enumerate(zip(KINDS, refs)):
        ok = ref["valid"]
        np.testing.assert_array_equal(got["valid"][i], ok)
        for k in ("labels", "is_fg"):
            np.testing.assert_array_equal(got[k][i], ref[k])
        np.testing.assert_array_equal(got["matched_gt"][i][ok], ref["matched_gt"][ok])
        for k in ("rois", "bbox_targets", "bbox_inside_weights", "bbox_outside_weights"):
            assert got[k][i].shape == ref[k].shape
            np.testing.assert_allclose(got[k][i][ok], ref[k][ok], rtol=0, atol=1e-6)
        # what each scene is there to show
        n_fg = int(got["is_fg"][i].sum())
        assert not got["is_fg"][i][fg_cap:].any()  # fg only in the leading slots
        if kind == "fg_cap":
            assert n_fg == fg_cap and int(ok.sum()) == fg_cap  # no bg to fill the rest
        if kind in ("no_fg", "no_gt", "all_invalid"):
            assert n_fg == (3 if kind in ("no_fg", "all_invalid") else 0)  # the gt boxes
        if kind == "all_invalid":
            assert int(ok.sum()) == 3 and (got["labels"][i][~ok] == -1).all()
        if kind == "no_gt":
            assert (got["labels"][i][ok] == 0).all() and not got["bbox_inside_weights"][i].any()


def test_generator_draws_and_slot_count_guard():
    props, valid, gt, cls = (torch.from_numpy(a)[None] for a in scene("mixed", 3))
    a = sample_proposal_labels(props, valid, gt, cls, **ARGS,
                               generator=torch.Generator().manual_seed(5))
    b = sample_proposal_labels(props, valid, gt, cls, **ARGS,
                               generator=torch.Generator().manual_seed(5))
    c = sample_proposal_labels(props, valid, gt, cls, **ARGS,
                               generator=torch.Generator().manual_seed(6))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["rois"], c["rois"])
    assert a["rois"].shape == (1, 16, 4) and a["bbox_targets"].shape == (1, 16, 20)
    assert a["labels"].dtype == cls.dtype
    with pytest.raises(ValueError, match="cannot fill"):
        sample_proposal_labels(props[:, :5], valid[:, :5], gt, cls, **ARGS)


@pytest.mark.parametrize("bs,frac", [(512, 0.25), (64, 0.25), (8, 0.25), (10, 0.35), (7, 0.5)])
def test_sampled_fg_cap(bs, frac):
    assert sampled_fg_cap(bs, frac) == j_fg_cap(bs, frac)


def test_box_ops_match_sad_tpu():
    rng = np.random.RandomState(4)
    xy = rng.uniform(-20, 200, (2, 30, 2))
    a = np.concatenate([xy, xy + rng.uniform(-5, 90, (2, 30, 2))], -1).astype(np.float32)
    q = a[:, ::3] + rng.uniform(-8, 8, (2, 10, 4)).astype(np.float32)
    got = tbox.bbox_overlaps(torch.from_numpy(a), torch.from_numpy(q)).numpy()
    for i in range(2):
        ref = np.asarray(jbox.bbox_overlaps(jnp.asarray(a[i]), jnp.asarray(q[i])))
        np.testing.assert_allclose(got[i], ref, rtol=0, atol=1e-6)
    ex, gt = a[..., :10, :], np.abs(q) + np.array([0, 0, 30, 30], np.float32)
    ex = np.abs(ex) + np.array([0, 0, 30, 30], np.float32)
    w = (10.0, 10.0, 5.0, 5.0)
    ref = np.asarray(jbox.bbox_transform_inv(jnp.asarray(ex), jnp.asarray(gt), w))
    got = tbox.bbox_transform_inv(torch.from_numpy(ex), torch.from_numpy(gt), w).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    back = tbox.bbox_transform(torch.from_numpy(ex), torch.from_numpy(got), w).numpy()
    np.testing.assert_allclose(back, gt, rtol=0, atol=2e-3)
