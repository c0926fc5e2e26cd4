"""Label assignment at ties: the port's RetinaNet and RPN labels against
sad_tpu's on seeded gt boxes that reach the tie rule ("every anchor tied at
a gt's best overlap", retinanet.py:198-250, rpn.py:150-170).

sad_tpu assigns labels with its float32 native pass (sad_tpu/native, the
reference's cython_bbox works in float32). Equality of two IoUs depends on
the precision, so a float64 pass marks other anchors as tied: on these
seeds the float64 tie mask differs from the float32 one (checked below, so
the cases do reach such ties), and with it the pre-stomp fg count
``num_fg`` (the focal loss's normalizer), the fg mask and the RPN labels.
The port's labels, masks, targets and counts must be sad_tpu's."""

import numpy as np
import pytest

import sad_tpu.config as jcfg
import sad_tpu.data.anchors as janchors
import sad_tpu.native as jnative
import sad_tpu_torch.config as tcfg
import sad_tpu_torch.data.anchors as tanchors
from sad_tpu.config.config import merge_cfg_from_dict as jmerge
from sad_tpu.data import rpn_minibatch as jrm
from sad_tpu_torch.config.config import merge_cfg_from_dict as tmerge
from sad_tpu_torch.data import rpn_minibatch as trm
from test_torch_models import one_torch_thread, sad_tpu_native_loaded  # noqa: F401  (autouse)

CANVAS = (640, 1024)  # the flagship configs' landscape canvas
LEVELS = (3, 4, 5, 6, 7)
RPN_CFG = {
    "MODEL": {"TYPE": "generalized_rcnn", "FASTER_RCNN": True, "NUM_CLASSES": 81,
              "CONV_BODY": "FPN.add_fpn_ResNet50_conv5_body"},
    "FPN": {"FPN_ON": True, "MULTILEVEL_RPN": True, "MULTILEVEL_ROIS": True,
            "RPN_MIN_LEVEL": 2, "RPN_MAX_LEVEL": 6},
}


def image_gt(seed, k=8):
    """k gt boxes on integer pixels of an image scaled by 0.5-1.7 to the
    canvas (as the minibatch builder scales a COCO image), their classes and
    the scaled image's extent."""
    rng = np.random.RandomState(seed)
    s = rng.uniform(0.5, 1.7)
    h, w = int(CANVAS[0] / s), int(CANVAS[1] / s)
    x1, y1 = rng.randint(0, w - 20, k), rng.randint(0, h - 20, k)
    x2 = np.minimum(x1 + rng.randint(8, w // 2, k), w - 1)
    y2 = np.minimum(y1 + rng.randint(8, h // 2, k), h - 1)
    boxes = (np.stack([x1, y1, x2, y2], 1) * s).astype(np.float32)
    return boxes, rng.randint(1, 81, k).astype(np.int32), min(CANVAS[0], h * s), min(CANVAS[1], w * s)


def float64_ties_differ(flat, boxes):
    """Whether a float64 IoU pass marks other anchors as tied than sad_tpu's
    float32 native pass does."""
    iou = janchors._iou_matrix(flat.astype(np.float64), boxes.astype(np.float64))
    ties64 = (iou == iou.max(axis=0)[None, :]).any(axis=1)
    return not np.array_equal(ties64, jnative.assign_overlaps(flat, boxes)[2])


SEEDS = (9, 12, 15, 27, 41, 45)  # each a case where the two precisions tie other anchors


@pytest.fixture(scope="module")
def grids():
    j = janchors.all_field_anchors(LEVELS, 4.0, (1.0, 2.0, 0.5), 3, *CANVAS)
    t = tanchors.all_field_anchors(LEVELS, 4.0, (1.0, 2.0, 0.5), 3, *CANVAS)
    assert np.array_equal(j.flat_anchors(), t.flat_anchors())
    return j, t


@pytest.mark.parametrize("seed", SEEDS)
def test_retinanet_labels_equal_sad_tpu_at_ties(grids, seed):
    jgrid, tgrid = grids
    boxes, classes, im_h, im_w = image_gt(seed)
    assert float64_ties_differ(jgrid.flat_anchors(), boxes)
    jl, jt, jm, jfg, jbg = janchors.assign_retinanet_labels(jgrid, boxes, classes, im_h, im_w)
    tl, tt, tm, tfg, tbg = tanchors.assign_retinanet_labels(tgrid, boxes, classes, im_h, im_w)
    assert (tfg, tbg) == (jfg, jbg)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(b, a)
    for a, b in zip(jm, tm):
        np.testing.assert_array_equal(b, a)
    for a, b in zip(jt, tt):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)


def symmetric_gt(flat, seed):
    """A gt box over an anchor and its neighbour a stride s to the right,
    inset by the same d on both sides (and e top and bottom): the two
    anchors' IoUs are equal in exact arithmetic, but the box's float32
    corners round differently, so float64 sees two IoUs a few ulps apart
    and float32 may or may not. The RPN's anchors sit on integer pixels and
    one size a level, and image-like boxes reached such ties on none of
    40,000 seeds; these boxes do, and on these seeds the tie changes the
    sampled labels."""
    rng = np.random.RandomState(seed)
    a = flat[rng.randint(0, len(flat))].astype(np.float64)
    s = rng.choice([4, 8, 16, 32, 64])
    d, e = rng.uniform(0, s / 2), rng.uniform(0, (a[3] - a[1] + 1) / 4)
    return np.array([[a[0] + d, a[1] + e, a[2] + s - d, a[3] - e]], np.float32)


RPN_SEEDS = (762, 783, 1445, 2188, 3359, 4346)


@pytest.mark.parametrize("seed", RPN_SEEDS)
def test_rpn_labels_equal_sad_tpu_at_ties(seed):
    jc, tc = jmerge(jcfg.Config(), RPN_CFG), tmerge(tcfg.Config(), RPN_CFG)
    jgrid, tgrid = jrm.rpn_anchor_grid(jc, *CANVAS), trm.rpn_anchor_grid(tc, *CANVAS)
    boxes = symmetric_gt(jgrid.flat_anchors(), seed)
    im_h, im_w = CANVAS
    assert float64_ties_differ(jgrid.flat_anchors(), boxes)
    ref = jrm.assign_rpn_labels(jc, jgrid, boxes, im_h, im_w, np.random.RandomState(seed))
    got = trm.assign_rpn_labels(tc, tgrid, boxes, im_h, im_w, np.random.RandomState(seed))
    for ref_levels, got_levels in zip(ref, got):  # labels, targets, inside_w, outside_w
        for a, b in zip(ref_levels, got_levels):
            assert a.dtype == b.dtype
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
