"""The port's RPN proposal ops against sad_tpu's on identical numpy inputs:
indices and valid masks exactly, boxes within 1e-5 relative + 1e-4 px (exp
XX
tests run it on this CPU (the fori_loop form; its Pallas kernel, interpreted,
is held equal to that in tests/test_pallas_nms.py and to the port's in
tests/test_torch_nms.py). Scores are continuous, so no tie decides a top-k."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sad_tpu.data.anchors import field_of_anchors as j_field
from sad_tpu.data.anchors import generate_cell_anchors as j_cell
from sad_tpu.ops import proposals as jp
from sad_tpu.ops.box_transforms import clip_boxes as j_clip_boxes
from sad_tpu_torch.data.anchors import rpn_cell_anchors
from sad_tpu_torch.models.rcnn import rpn_anchor_field_on
from sad_tpu_torch.ops import proposals as tp
from sad_tpu_torch.ops.box_transforms import clip_boxes
from test_torch_models import one_torch_thread, sad_tpu_native_loaded  # noqa: F401  (autouse)

ARS = (0.5, 1.0, 2.0)


def _boxes_close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-5, atol=1e-4)


def j_anchors(level, h, w, min_level=2, start=32):
    """sad_tpu/models/rcnn.py:293-307."""
    stride = 2.0 ** level
    size = start * 2 ** (level - min_level)
    cell = np.concatenate([j_cell(stride, (size,), (ar,)) for ar in ARS])
    return j_field(cell, stride, h, w).astype(np.float32)


def rpn_outputs(seed, b, h, w, a=3):
    rng = np.random.RandomState(seed)
    scores = rng.uniform(0, 1, (b, h, w, a)).astype(np.float32)
    deltas = (rng.randn(b, h, w, a, 4) * 0.3).astype(np.float32)
    im_hw = np.stack([rng.uniform(0.6, 1.0, b) * h * 8, rng.uniform(0.6, 1.0, b) * w * 8],
                     axis=1).astype(np.float32)
    return scores, deltas, im_hw


@pytest.mark.parametrize("level,h,w", [(2, 16, 24), (3, 8, 12), (6, 1, 2)])
def test_anchor_fields_equal_sad_tpu(level, h, w):
    got = rpn_anchor_field_on(torch.device("cpu"), level, 2, 32.0, ARS, h, w)
    assert got.dtype == torch.float32 and not got.is_inference()
    np.testing.assert_array_equal(got.numpy(), j_anchors(level, h, w))
    np.testing.assert_array_equal(rpn_cell_anchors(level, 2, 32, ARS).shape, (3, 4))
    assert rpn_anchor_field_on(torch.device("cpu"), level, 2, 32.0, ARS, h, w) is got  # cached


def test_clip_boxes_elementwise():
    rng = np.random.RandomState(0)
    boxes = rng.uniform(-50, 400, (3, 40, 4)).astype(np.float32)
    hw = np.array([[200, 300], [150, 380], [399, 120]], np.float32)
    ref = jax.vmap(lambda bx, s: j_clip_boxes(bx, s[0], s[1]))(jnp.asarray(boxes), jnp.asarray(hw))
    t_hw = torch.from_numpy(hw)
    got = clip_boxes(torch.from_numpy(boxes), t_hw[:, 0:1], t_hw[:, 1:2])
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    one = clip_boxes(torch.from_numpy(boxes[0]), t_hw[0, 0], t_hw[0, 1])
    np.testing.assert_array_equal(one.numpy(), np.asarray(ref)[0])


def test_map_rois_to_fpn_levels():
    rng = np.random.RandomState(1)
    xy = rng.uniform(0, 600, (500, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0, 700, (500, 2))], axis=1).astype(np.float32)
    boxes[:5] = [[0, 0, 55, 55], [0, 0, 111, 111], [0, 0, 223, 223], [0, 0, 447, 447],
                 [0, 0, 2000, 2000]]
    boxes[5] = [7, 7, 7, 7]
    boxes[6] = [9, 9, 3, 3]  # negative extent: the 1e-6 floor
    ref = np.asarray(jp.map_rois_to_fpn_levels(jnp.asarray(boxes), 2, 5))
    got = tp.map_rois_to_fpn_levels(torch.from_numpy(boxes), 2, 5)
    assert got.dtype == torch.int32 and got[:5].tolist() == [2, 3, 4, 5, 5]
    # a level boundary is a float32 log2 landing on an integer: the box sizes
    # here are continuous, and the five exact ones agree above
    np.testing.assert_array_equal(got.numpy(), ref)
    batched = tp.map_rois_to_fpn_levels(torch.from_numpy(boxes).reshape(5, 100, 4), 2, 5)
    np.testing.assert_array_equal(batched.reshape(-1).numpy(), ref)


@pytest.mark.parametrize("min_size", [0.0, 16.0])
def test_proposal_candidates_batched_and_single(min_size):
    b, h, w = 3, 8, 12
    scores, deltas, im_hw = rpn_outputs(2, b, h, w)
    anchors = j_anchors(3, h, w)
    ref = jax.vmap(lambda s, d, hw: jp.proposal_candidates(
        s, d, jnp.asarray(anchors), hw, 100, min_size))(
            jnp.asarray(scores), jnp.asarray(deltas), jnp.asarray(im_hw))
    got = tp.proposal_candidates(torch.from_numpy(scores), torch.from_numpy(deltas),
                                 torch.from_numpy(anchors), torch.from_numpy(im_hw), 100, min_size)
    assert tuple(got[0].shape) == (b, 100, 4)
    _boxes_close(got[0], ref[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    if min_size:
        assert 0 < (got[2].numpy() < -1e29).sum() < got[2].numel()
    one = tp.proposal_candidates(torch.from_numpy(scores[1]), torch.from_numpy(deltas[1]),
                                 torch.from_numpy(anchors), torch.from_numpy(im_hw[1]), 100, min_size)
    for x, y in zip(one, got):
        assert torch.equal(x, y[1])


def test_proposal_candidates_caps_k_at_the_level_size():
    scores, deltas, im_hw = rpn_outputs(3, 2, 1, 2)
    anchors = j_anchors(6, 1, 2)
    boxes, top, masked = tp.proposal_candidates(
        torch.from_numpy(scores), torch.from_numpy(deltas), torch.from_numpy(anchors),
        torch.from_numpy(im_hw), 1000)
    assert tuple(boxes.shape) == (2, 6, 4) and tuple(masked.shape) == (2, 6)


def test_generate_proposals_one_level_one_image():
    h, w = 8, 12
    scores, deltas, im_hw = rpn_outputs(4, 1, h, w)
    anchors = j_anchors(3, h, w)
    ref = jp.generate_proposals(jnp.asarray(scores[0]), jnp.asarray(deltas[0]),
                                jnp.asarray(anchors), jnp.asarray(im_hw[0]), 120, 30, 0.7)
    got = tp.generate_proposals(torch.from_numpy(scores[0]), torch.from_numpy(deltas[0]),
                                torch.from_numpy(anchors), torch.from_numpy(im_hw[0]), 120, 30, 0.7)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    _boxes_close(got[0], ref[0])
    valid = got[2].numpy()
    assert 5 < valid.sum() and (np.diff(got[1].numpy()[valid]) <= 0).all()


def test_generate_proposals_min_size_filter():
    anchors = torch.tensor([[[[0, 0, 1.5, 1.5], [10, 10, 40, 40]]]])
    scores = torch.tensor([[[0.9, 0.8]]])
    boxes, sc, valid = tp.generate_proposals(scores, torch.zeros(1, 1, 2, 4), anchors,
                                             torch.tensor([64.0, 64.0]), 2, 2, 0.7, min_size=5.0)
    assert valid.tolist() == [True, False]  # the tiny box is filtered despite its score
    assert boxes[0].tolist() == [10, 10, 40, 40] and sc.tolist() == pytest.approx([0.8, 0.0])


def _prop_levels(seed, b=2):
    """Candidates of three levels with different k (the coarsest holds fewer
    anchors than PRE_NMS_TOP_N), from identical numpy inputs for both."""
    out = []
    for lvl, (h, w) in ((3, (8, 12)), (4, (4, 6)), (6, (1, 2))):
        scores, deltas, im_hw = rpn_outputs(seed + lvl, b, h, w)
        im_hw[:] = [[60, 90], [64, 96]][:b]
        anchors = j_anchors(lvl, h, w)
        bx, ts, ms = tp.proposal_candidates(
            torch.from_numpy(scores), torch.from_numpy(deltas), torch.from_numpy(anchors),
            torch.from_numpy(im_hw), 60, 4.0)
        out.append((lvl, bx, ts, ms))
    return out


def test_nms_levels_batched_pads_short_levels():
    levels = _prop_levels(5)
    assert [bx.shape[1] for _, bx, _, _ in levels] == [60, 60, 6]
    ref = jp.nms_levels_batched(
        [(l, jnp.asarray(bx.numpy()), jnp.asarray(ts.numpy()), jnp.asarray(ms.numpy()))
         for l, bx, ts, ms in levels], 0.7, 20)
    got = tp.nms_levels_batched(levels, 0.7, 20)
    for lvl in (3, 4, 6):
        valid = got[2][lvl].numpy()
        np.testing.assert_array_equal(valid, np.asarray(ref[2][lvl]))
        np.testing.assert_array_equal(got[1][lvl].numpy(), np.asarray(ref[1][lvl]))
        # padded slots point at candidate 0 in both; compare the valid ones
        np.testing.assert_array_equal(got[0][lvl].numpy()[valid], np.asarray(ref[0][lvl])[valid])
    assert got[2][6].sum() <= 2 * 6 and got[2][3].sum() > 10


def test_collect_and_distribute_batched_and_single():
    levels = _prop_levels(6)
    lv_b, lv_s, lv_v = tp.nms_levels_batched(levels, 0.7, 20)
    ref = jax.vmap(lambda bb, ss, vv: jp.collect_and_distribute_fpn_proposals(
        bb, ss, vv, 30, 2, 5))(
            {l: jnp.asarray(v.numpy()) for l, v in lv_b.items()},
            {l: jnp.asarray(v.numpy()) for l, v in lv_s.items()},
            {l: jnp.asarray(v.numpy()) for l, v in lv_v.items()})
    got = tp.collect_and_distribute_fpn_proposals(lv_b, lv_s, lv_v, 30, 2, 5)
    valid = got[2].numpy()
    np.testing.assert_array_equal(valid, np.asarray(ref[2]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    # invalid slots all carry NEG_INF: which of them a top-k reports is free
    np.testing.assert_array_equal(got[0].numpy()[valid], np.asarray(ref[0])[valid])
    np.testing.assert_array_equal(got[3].numpy()[valid], np.asarray(ref[3])[valid])
    assert got[3].dtype == torch.int32 and valid.sum() > 30
    one = tp.collect_and_distribute_fpn_proposals(
        {l: v[1] for l, v in lv_b.items()}, {l: v[1] for l, v in lv_s.items()},
        {l: v[1] for l, v in lv_v.items()}, 30, 2, 5)
    for x, y in zip(one, got):
        assert torch.equal(x, y[1])


def test_collect_takes_global_topk_and_drops_invalid():
    lb = {2: torch.tensor([[0, 0, 10, 10], [0, 0, 20, 20.0]]),
          3: torch.tensor([[0, 0, 150, 150], [0, 0, 200, 200.0]])}
    ls = {2: torch.tensor([0.9, 0.1]), 3: torch.tensor([0.8, 0.5])}
    lv = {2: torch.tensor([True, True]), 3: torch.tensor([True, False])}
    boxes, scores, valid, lvls = tp.collect_and_distribute_fpn_proposals(lb, ls, lv, 3, 2, 5)
    assert scores.tolist() == pytest.approx([0.9, 0.8, 0.1]) and valid.all()
    assert lvls.tolist() == [2, 3, 2]
    _, s4, v4, _ = tp.collect_and_distribute_fpn_proposals(lb, ls, lv, 9, 2, 5)
    assert v4.tolist() == [True, True, True, False] and s4[3] == 0.0
