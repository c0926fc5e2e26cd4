"""The port's keypoint utilities (sad_tpu_torch/utils/keypoints.py) against
sad_tpu's (sad_tpu/utils/keypoints.py) on seeded numpy inputs.

sad_tpu resizes heatmaps with cv2 where cv2 imports and with numpy
otherwise, so its decode computes one thing on a host with cv2 and another
on one without. The port has the numpy path only. So the comparisons pin
sad_tpu's path: bit-equal to its numpy path (``_cv2`` set to None with
monkeypatch), and within 1e-4 of the largest magnitude of its cv2 path where
cv2 imports. The flip maps and the skeleton are equal.
"""

import numpy as np
import pytest
from PIL import Image

from sad_tpu.utils import keypoints as jkp
from sad_tpu.utils import vis as jvis
from sad_tpu_torch.utils import keypoints as tkp
from sad_tpu_torch.utils import vis as tvis
from test_torch_models import one_torch_thread  # noqa: F401  (autouse)


def heatmaps(seed, r=6, s=56, k=17):
    """(R, S, S, K) float32 logits: one Gaussian bump a channel on noise,
    so that every channel has one clear peak, as a trained head gives."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
    cy, cx = rng.uniform(4, s - 4, (2, r, 1, 1, k))
    bump = 8.0 * np.exp(-((yy[None, :, :, None] - cy) ** 2 + (xx[None, :, :, None] - cx) ** 2)
                        / 18.0)
    return (bump + rng.randn(r, s, s, k)).astype(np.float32)


def rois(seed, r=6):
    """(R, 4) boxes of 7..160 px, fractional corners, one thinner than a pixel."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 300, (r, 2))
    wh = rng.uniform(7, 160, (r, 2))
    wh[0, 0] = 0.4
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


@pytest.fixture
def numpy_path(monkeypatch):
    monkeypatch.setattr(jkp, "_cv2", None)


def test_flip_maps_and_names_equal():
    assert tkp.COCO_KEYPOINTS == jkp.COCO_KEYPOINTS
    assert tkp.get_keypoints() == jkp.get_keypoints()
    np.testing.assert_array_equal(tkp.flip_keypoint_channels(), jkp.flip_keypoint_channels())
    for names in (["center", "left_tip", "right_tip", "top_tip", "bottom_tip"],
                  ["left_a", "x", "right_a", "left_b"], []):
        np.testing.assert_array_equal(tkp.flip_idx_for_names(names), jkp.flip_idx_for_names(names))
    assert tvis.kp_connections() == jvis.kp_connections()


@pytest.mark.parametrize("shape", [(56, 56, 17, 37, 90), (28, 28, 5, 1, 1), (56, 56, 17, 161, 12)],
                         ids=["56to37x90", "28to1x1", "56to161x12"])
def test_resize_bicubic_bit_equal_to_the_numpy_path(numpy_path, shape):
    s, _, k, h, w = shape
    m = np.random.RandomState(h + w).randn(s, s, k).astype(np.float32)
    got = tkp._resize_bicubic(m, h, w)
    assert got.shape == (h, w, k) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jkp._resize_bicubic(m, h, w))
    np.testing.assert_array_equal(tkp._cubic_weights(np.linspace(0, 1, 9)),
                                  jkp._cubic_weights(np.linspace(0, 1, 9)))


@pytest.mark.parametrize("min_size", [0.0, 64.0])
def test_heatmaps_to_keypoints_bit_equal_to_the_numpy_path(numpy_path, min_size):
    hm, bx = heatmaps(1), rois(2)
    got = tkp.heatmaps_to_keypoints(hm, bx, min_size=min_size)
    assert got.shape == (6, 4, 17) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jkp.heatmaps_to_keypoints(hm, bx, min_size=min_size))
    # every keypoint lands inside its (clamped-to-1-px) box
    w = np.maximum(bx[:, 2] - bx[:, 0], 1.0)
    assert ((got[:, 0] >= bx[:, :1]) & (got[:, 0] <= (bx[:, 0] + w)[:, None])).all()


def test_nms_oks_and_compute_oks_equal(numpy_path):
    """Overlapping predictions: rois jittered copies of three, so that OKS
    suppresses some and keeps others."""
    rng = np.random.RandomState(4)
    base = rois(5, r=3)
    base[0, 2] += 30.0  # no box thinner than the jitter
    bx = (np.repeat(base, 4, axis=0) + rng.uniform(-2, 2, (12, 4))).astype(np.float32)
    hm = np.repeat(heatmaps(6, r=3), 4, axis=0) + 0.2 * rng.randn(12, 56, 56, 17).astype(np.float32)
    kp_j = jkp.heatmaps_to_keypoints(hm, bx)
    kp_t = tkp.heatmaps_to_keypoints(hm, bx)
    np.testing.assert_array_equal(kp_t, kp_j)
    np.testing.assert_array_equal(tkp.compute_oks(kp_t[0], bx[0], kp_t[1:], bx[1:]),
                                  jkp.compute_oks(kp_j[0], bx[0], kp_j[1:], bx[1:]))
    for thresh in (0.3, 0.9):
        keep = tkp.nms_oks(kp_t, bx, thresh)
        assert keep == jkp.nms_oks(kp_j, bx, thresh)
    assert 3 <= len(tkp.nms_oks(kp_t, bx, 0.3)) < 12


def test_against_the_cv2_path():
    """Where cv2 imports, sad_tpu's resize is cv2.resize INTER_CUBIC: the
    port's numpy resize within 1e-4 * max of it, and the decode's logit and
    probability rows within 1e-4 * max; the argmax positions are equal on
    these heatmaps (one clear peak a channel)."""
    if jkp._cv2 is None:
        pytest.skip("cv2 is not installed: sad_tpu takes the numpy path here")
    m = np.random.RandomState(7).randn(56, 56, 17).astype(np.float32)
    for h, w in ((37, 90), (161, 12), (56, 56)):
        ref = jkp._resize_bicubic(m, h, w)
        assert np.abs(tkp._resize_bicubic(m, h, w) - ref).max() <= 1e-4 * np.abs(ref).max()
    hm, bx = heatmaps(8), rois(9)
    ref, got = jkp.heatmaps_to_keypoints(hm, bx), tkp.heatmaps_to_keypoints(hm, bx)
    for row in (2, 3):
        assert np.abs(got[:, row] - ref[:, row]).max() <= 1e-4 * np.abs(ref[:, row]).max()
    np.testing.assert_allclose(got[:, :2], ref[:, :2], rtol=0, atol=1e-3)


def test_vis_skeleton_equal():
    """The keypoint overlay draws the same pixels as sad_tpu's, from decode
    rows and from COCO triplets; a skeleton pair past K draws nothing."""
    im = np.zeros((80, 96, 3), np.uint8)
    boxes = np.array([[4, 4, 60, 70], [30, 10, 90, 50]], np.float32)
    rng = np.random.RandomState(10)
    rows = np.zeros((4, 17), np.float32)
    rows[0], rows[1], rows[2] = rng.uniform(5, 60, 17), rng.uniform(5, 70, 17), rng.uniform(0, 4, 17)
    trip = np.stack([rows[0], rows[1], (rows[2] > 1).astype(np.float32)], axis=1).ravel()
    kw = dict(keypoints=[rows, trip])
    a = np.asarray(tvis.vis_one_image(im, boxes, np.ones(2), np.ones(2, int), **kw))
    b = np.asarray(jvis.vis_one_image(im, boxes, np.ones(2), np.ones(2, int), **kw))
    np.testing.assert_array_equal(a, b)
    assert a.any()
    five = np.asarray(tvis.vis_one_image(im, boxes[:1], np.ones(1), np.ones(1, int),
                                         keypoints=[rows[:, :5]]))
    assert isinstance(Image.fromarray(five), Image.Image)
