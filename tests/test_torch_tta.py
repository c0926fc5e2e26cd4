"""Test-time augmentation, box voting and soft-NMS in the port against
sad_tpu on the CPU, float32, at the tiny R-CNN size of tests/test_torch_rcnn.py
(CHANNEL_RATIO 0.0625), converted weights and the same PNG images.

- eval/test_augmentation against sad_tpu's on the same arrays: box_voting
  with each of the six scoring methods and postprocess_detections (soft-NMS
  linear and gaussian, NMS, voting) bit-equal (both run the same g++ host
  kernels); the transform lists, the UNION merge with flips, the three mask
  heuristics, HM_AVG / HM_MAX and the size-dependent combining, both flips
  equal. The port gathers each detection's class channel before the mask
  flip, so its flip reverses the last axis: a flip of the gathered masks on
  sad_tpu's axis (second to last) is shown to differ.
- run_inference_on_roidb with BBOX_AUG + MASK_AUG + KPS_AUG + BBOX_VOTE
  (scales 48 and 80, each also flipped: 6 box passes and 5 passes of each
  aux head on a batch of 2 images; 80 is clamped to the 64x128 canvas) on
  one model with the mask and the keypoint heads, against sad_tpu's
  engine: the same
  detection count, boxes within 2e-3 px, scores within 1e-4 (the
  whole-slice tolerances of tests/test_torch_rcnn_inference.py); the
  combined masks within 1e-3 and, pasted at sad_tpu's box, pixel for pixel
  (a pixel may differ only where sad_tpu's probability lies within 1e-3 of
  THRESH_BINARIZE); as written, at most 0.1 % of all pasted pixels differ,
  each at the edge of a box with a coordinate within 2e-3 of an integer
  (the paste truncates coordinates). Keypoints with KPS_AUG's HM_AVG and
  SCALE_SIZE_DEP (an AREA_TH that splits the detections), sad_tpu pinned
  to its numpy heatmap resize: within 1e-3 px (ties excepted, see the
  test). Then all once more with TEST.SOFT_NMS on.
- The refusals where sad_tpu silently ignores an option.

sad_tpu's box and aux functions depend on no option that differs between
the two runs (TTA, soft-NMS and voting are host steps), so each is jitted
once and the runs share its compile.
"""

import numpy as np
import pytest
import torch

import sad_tpu.config as jcfg
import sad_tpu_torch.config as tcfg
from sad_tpu.config.config import merge_cfg_from_dict as j_merge
from sad_tpu.data.dataset import CocoDataset as JCocoDataset
from sad_tpu.eval import rcnn_inference as j_rcnn_inference
from sad_tpu.eval import test_augmentation as jta
from sad_tpu.eval import test_engine as j_engine
from sad_tpu.models import create_model as j_create_model
from sad_tpu.utils import keypoints as jkp
from sad_tpu.utils import segms as j_segms
from sad_tpu_torch.config.config import merge_cfg_from_dict as t_merge
from sad_tpu_torch.convert import load_params
from sad_tpu_torch.data.dataset import CocoDataset
from sad_tpu_torch.data.synth_coco import generate_synthetic_coco
from sad_tpu_torch.eval import test_augmentation as ta
from sad_tpu_torch.eval import test_engine
from sad_tpu_torch.models import GeneralizedRCNN
from sad_tpu_torch.utils import keypoints as tkp
from test_torch_keypoint_rcnn import KRCNN
from test_torch_models import one_torch_thread  # noqa: F401  (autouse)
from test_torch_rcnn import TINY, rcnn_params

TTA_VAL = "torch_tta_val"
AREA_TH = 4.0 ** 2  # KPS_AUG.AREA_TH: splits these random weights' small detections
SCALES = (48, 80)
AUG = {"ENABLED": True, "H_FLIP": True, "SCALES": SCALES, "MAX_SIZE": 128,
       "SCALE_H_FLIP": True}
# Mask and Keypoint R-CNN in one model: every detection carries a mask and
# keypoints, so one run holds box, mask and keypoint TTA
TTA = dict(TINY, MODEL=dict(TINY["MODEL"], NUM_CLASSES=9, MASK_ON=True, KEYPOINTS_ON=True),
           KRCNN=KRCNN,
           TEST=dict(TINY["TEST"], DATASETS=(TTA_VAL,), BBOX_AUG=AUG,
                     MASK_AUG=dict(AUG, HEUR="SOFT_AVG"),
                     KPS_AUG=dict(AUG, HEUR="HM_AVG", SCALE_SIZE_DEP=True, AREA_TH=AREA_TH),
                     BBOX_VOTE={"ENABLED": True, "VOTE_TH": 0.9}))
SOFT = dict(TTA, TEST=dict(TTA["TEST"], SOFT_NMS={"ENABLED": True, "METHOD": "linear"}))


def pair(over):
    return j_merge(jcfg.Config(), over), t_merge(tcfg.Config(), over)


# ---------------------------------------------------------- host functions


def _dets(rng, n, spread=60.0):
    xy = rng.uniform(0, spread, (n, 2))
    wh = rng.uniform(6, 30, (n, 2))
    return np.concatenate([xy, xy + wh, rng.uniform(0.05, 1.0, (n, 1))], 1).astype(np.float32)


@pytest.mark.parametrize("method", ["ID", "TEMP_AVG", "AVG", "IOU_AVG", "GENERALIZED_AVG",
                                    "QUASI_SUM"])
def test_box_voting_each_scoring_method(method):
    rng = np.random.RandomState(1)
    all_dets = _dets(rng, 40)
    top = all_dets[::4].copy()
    ref = jta.box_voting(top, all_dets, 0.5, method, beta=1.5)
    got = ta.box_voting(top, all_dets, 0.5, method, beta=1.5)
    np.testing.assert_array_equal(got, ref)
    assert not np.array_equal(got[:, :4], top[:, :4])  # the votes moved boxes


@pytest.mark.parametrize("soft,vote", [(None, True), ("linear", False), ("linear", True),
                                       ("gaussian", True)])
def test_postprocess_detections_bit_equal(soft, vote):
    over = {"TEST": {"NMS": 0.5, "DETECTIONS_PER_IM": 30,
                     "SOFT_NMS": {"ENABLED": soft is not None, "METHOD": soft or "linear"},
                     "BBOX_VOTE": {"ENABLED": vote, "VOTE_TH": 0.8,
                                   "SCORING_METHOD": "IOU_AVG"}}}
    jc, tc = pair(over)
    rng = np.random.RandomState(2)
    d = _dets(rng, 120)
    classes = rng.randint(1, 4, 120).astype(np.int32)
    valid = rng.rand(120) > 0.2
    args = (d[:, :4], d[:, 4], classes, valid, 4)
    ref = jta.postprocess_detections(jc, *args)
    got = ta.postprocess_detections(tc, *args)
    assert len(got[1]) == 30  # the DETECTIONS_PER_IM cap bit
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b, a)


def test_transform_lists_and_union_merge():
    over = {"TEST": {"SCALES": (64,), "MAX_SIZE": 96, "BBOX_AUG": dict(AUG),
                     "MASK_AUG": dict(AUG, H_FLIP=False), "KPS_AUG": dict(AUG)}}
    jc, tc = pair(over)
    assert ta.bbox_aug_transforms(tc) == jta.bbox_aug_transforms(jc)
    assert len(ta.bbox_aug_transforms(tc)) == 6
    for sec in ("MASK_AUG", "KPS_AUG"):
        got = ta.aux_aug_transforms(getattr(tc.TEST, sec), tc)
        assert got == jta.aux_aug_transforms(getattr(jc.TEST, sec), jc)
    assert [t["ds"] for t in got] == [False, True, True, False, False]
    rng = np.random.RandomState(3)
    per = [{"boxes": _dets(rng, 7)[:, :4], "scores": rng.rand(7).astype(np.float32),
            "classes": rng.randint(1, 4, 7), "valid": rng.rand(7) > 0.3} for _ in range(3)]
    flips = [False, True, True]
    ref = jta.merge_aug_detections(per, 90.0, flips)
    got = ta.merge_aug_detections(per, 90.0, flips)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    np.testing.assert_array_equal(got["boxes"][7:14, 0], 90.0 - per[1]["boxes"][:, 2] - 1)


@pytest.mark.parametrize("heur", ["SOFT_AVG", "SOFT_MAX", "LOGIT_AVG"])
def test_mask_heuristics_and_gather_then_combine(heur):
    """On full (B, K, m, m, C) stacks as sad_tpu combines them, and gathered
    to each detection's class first as the port does: the same numbers."""
    rng = np.random.RandomState(4)
    stack = [rng.uniform(0.01, 0.99, (2, 5, 8, 8, 3)).astype(np.float32) for _ in range(4)]
    classes = rng.randint(0, 3, (2, 5))
    ref = jta.combine_soft_masks(stack, heur)
    np.testing.assert_array_equal(ta.combine_soft_masks(stack, heur), ref)
    gathered = [test_engine.gather_class_masks(torch.from_numpy(s), torch.from_numpy(classes))
                .numpy() for s in stack]
    got = ta.combine_soft_masks(gathered, heur)
    want = np.take_along_axis(ref, classes[:, :, None, None, None], axis=4)[..., 0]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("heur", ["HM_AVG", "HM_MAX"])
def test_heatmap_combining(heur):
    rng = np.random.RandomState(5)
    stack = [rng.randn(2, 4, 6, 6, 17).astype(np.float32) for _ in range(5)]
    np.testing.assert_array_equal(ta.combine_heatmaps(stack, heur),
                                  jta.combine_heatmaps(stack, heur))
    ds, us = [False, True, True, False, False], [False, False, False, True, True]
    boxes = _dets(rng, 8, spread=100)[:, :4].reshape(2, 4, 4)
    ref = jta.combine_heatmaps_size_dep(stack, ds, us, boxes, heur, 20.0 ** 2)
    got = ta.combine_heatmaps_size_dep(stack, ds, us, boxes, heur, 20.0 ** 2)
    np.testing.assert_array_equal(got, ref)
    areas = (boxes[..., 2] - boxes[..., 0] + 1) * (boxes[..., 3] - boxes[..., 1] + 1)
    assert (areas < 400).any() and (areas >= 400).any()  # both subsets taken


def test_flips_and_the_mask_flip_axis():
    rng = np.random.RandomState(6)
    mp = rng.rand(2, 3, 7, 7, 4).astype(np.float32)
    hm = rng.randn(2, 3, 6, 6, 17).astype(np.float32)
    np.testing.assert_array_equal(ta.flip_heatmaps(hm), jta.flip_heatmaps(hm))
    classes = torch.from_numpy(rng.randint(0, 4, (2, 3)))
    gathered = test_engine.gather_class_masks(torch.from_numpy(mp), classes).numpy()
    want = test_engine.gather_class_masks(torch.from_numpy(jta.flip_mask_probs(mp).copy()),
                                          classes).numpy()
    np.testing.assert_array_equal(ta.flip_mask_probs(gathered), want)
    # sad_tpu's axis (the second to last) on the gathered (B, K, m, m) masks
    # flips the height: that would be a wrong mask
    assert not np.array_equal(gathered[..., ::-1, :], want)


# -------------------------------------------------------- the whole engine


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """A 2-image split, both landscape (one batch of the one canvas, one
    compile of each sad_tpu function), in both catalogs."""
    root = str(tmp_path_factory.mktemp("tta_data"))
    img_dir, js = generate_synthetic_coco(root, "tta", 2, seed=7, size_range=(80, 160),
                                          objects_per_image=(1, 3))
    jcfg.register_dataset(TTA_VAL, img_dir, js, allow_override=True)
    tcfg.register_dataset(TTA_VAL, img_dir, js, allow_override=True)


class _Recorder:
    """Wraps a function and keeps each call's array arguments and result."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args, **kw):
        out = self.fn(*args, **kw)
        self.calls.append(tuple(np.asarray(a).copy() for a in args[:2]) + (out,))
        return out


@pytest.fixture(scope="module")
def models(split):
    jc, tc = pair(TTA)
    jmodel = j_create_model(jc)
    params = rcnn_params(jmodel, seed=21)
    logits = params["mask_head"]["mask_fcn_logits"]
    logits["kernel"] = logits["kernel"] * 20.0  # probabilities away from the threshold
    lowres = params["kps_head"]["kps_score_lowres"]
    lowres["kernel"] = lowres["kernel"] * 4.0  # each channel's peak out of the float32 noise
    return jmodel, params, load_params(GeneralizedRCNN(tc).eval(), params)


@pytest.fixture(scope="module", params=["nms_vote", "soft_nms_vote"])
def served(request, models):
    """Both engines over the split with TTA (and soft-NMS): sad_tpu's box and
    aux functions jitted once for both runs (they depend on no option that
    differs between them), each paste and keypoint decode recorded."""
    over = SOFT if request.param == "soft_nms_vote" else TTA
    jmodel, params, port = models
    jc, tc = pair(over)
    recs = {k: (_Recorder(getattr(jmod, k)), _Recorder(getattr(test_engine, k)))
            for k, jmod in (("paste_mask_into_image", j_segms),
                            ("heatmaps_to_keypoints", jkp))}
    mp = pytest.MonkeyPatch()
    for name in ("make_rcnn_inference_fn", "make_aux_on_boxes_fn"):
        fn = getattr(j_rcnn_inference, name)
        mp.setattr(j_rcnn_inference, name, lambda cfg, model, _f=fn, _n=name: _JITTED.setdefault(
            (_n, id(model)), _f(cfg, model)))
    for k, jmod in (("paste_mask_into_image", j_segms), ("heatmaps_to_keypoints", jkp)):
        mp.setattr(jmod, k, recs[k][0])
        mp.setattr(test_engine, k, recs[k][1])
    mp.setattr(jkp, "_cv2", None)
    timing = {}
    try:
        jds, tds = JCocoDataset(TTA_VAL), CocoDataset(TTA_VAL)
        ref = j_engine.run_inference_on_roidb(jc, jmodel, params, jds.get_roidb(include_gt=False),
                                              jds.contiguous_to_json, batch_size=2)
        got = test_engine.run_inference_on_roidb(tc, port, tds.get_roidb(include_gt=False),
                                                 tds.contiguous_to_json, batch_size=2,
                                                 timing=timing)
    finally:
        mp.undo()
    return tc, ref, got, recs, timing


_JITTED = {}


def _matched(ref, got):
    """(i, j) pairs of sad_tpu's and the port's detections: the same image and
    category, scores within 1e-4, boxes within 2e-3 px. TTA makes exact
    score ties (a box and its flipped pass's twin vote alike), and tied
    detections come out in either order, so each of sad_tpu's takes the
    port's nearest unused one of its image and category."""
    assert len(got) == len(ref) > 5
    free = set(range(len(got)))
    pairs = []
    for i in sorted(range(len(ref)), key=lambda i: -ref[i]["score"]):
        a = ref[i]
        cands = [j for j in free if (got[j]["image_id"], got[j]["category_id"]) == (
            a["image_id"], a["category_id"]) and abs(got[j]["score"] - a["score"]) <= 1e-4]
        assert cands, a
        j = min(cands, key=lambda j: np.abs(np.subtract(got[j]["bbox"], a["bbox"])).max())
        np.testing.assert_allclose(got[j]["bbox"], a["bbox"], rtol=0, atol=2e-3)
        free.discard(j)
        pairs.append((i, j))
    return pairs


def _resized_prob(mp, box, h, w):
    """sad_tpu's paste before its threshold (tests/test_torch_test_net.py)."""
    from test_torch_test_net import _resized_prob as rp

    return rp(mp, box, h, w)


def _check_masks(ref, got, recs):
    """The port's combined mask, pasted at sad_tpu's box, against sad_tpu's
    pixel for pixel (a pixel may differ only where sad_tpu's probability lies
    within 1e-3 of the threshold); the results as written differ in at most
    0.1 % of the pixels, and only for boxes with a coordinate within 2e-3 of
    an integer, where the paste's integer truncation takes the other pixel
    (voted boxes clipped to the image edge)."""
    rec_ref, rec_got = recs
    assert len(rec_ref.calls) == len(ref) and len(rec_got.calls) == len(got)
    at_threshold = differ = total = filled = 0
    for i, j in _matched(ref, got):
        a = j_segms.rle_to_mask(ref[i]["segmentation"])
        b = j_segms.rle_to_mask(got[j]["segmentation"])
        h, w = a.shape
        (mp_r, box_r, _), (mp_g, box_g, _) = rec_ref.calls[i], rec_got.calls[j]
        np.testing.assert_allclose(mp_g, mp_r, rtol=0, atol=1e-3)
        same_box = j_segms.paste_mask_into_image(mp_g, box_r, h, w, 0.5)
        diff = a != same_box
        if diff.any():
            prob = _resized_prob(mp_r, box_r, h, w)
            assert (np.abs(prob[diff] - 0.5) <= 1e-3).all()
            at_threshold += int(diff.sum())
        if (a != b).any():
            frac = np.abs(box_g - np.round(box_g))
            assert (frac <= 2e-3).any(), (box_r, box_g)
            differ += int((a != b).sum())
        total += a.size
        filled += bool(b.any())
    assert at_threshold + differ <= 1e-3 * total, (at_threshold, differ, total)
    assert filled > len(got) // 2


def test_box_and_mask_tta_match_sad_tpu(served):
    _, ref, got, recs, timing = served
    _check_masks(ref, got, recs["paste_mask_into_image"])
    assert len({d["image_id"] for d in got}) == 2
    assert timing["batches"] == 1 and set(test_engine.SPLIT_KEYS) <= set(timing)
    assert min(timing[k] for k in ("aug_box_passes", "aug_merge", "aug_aux_passes",
                                   "aug_combine", "kps_decode")) > 0


def test_keypoint_tta_size_dep_matches_sad_tpu(served):
    """The combined heatmaps within 1e-3 * max|ref| (the heatmap tolerance of
    tests/test_torch_keypoint_rcnn.py), the port's decode of sad_tpu's
    combined heatmaps equal to sad_tpu's keypoints, and the keypoints within
    1e-3 px but where the map holds two peaks within that tolerance of each
    other (averaging 6 passes flattens peaks; the argmax may take either):
    there sad_tpu's own map at the port's position must lie within twice the
    tolerance of its maximum, and the peaks of both decodes agree. A roi
    whose side lies within 2e-3 of an integer is decoded on another pixel
    grid (the ceil of its extent): at most a tenth of them, not compared."""
    tc, ref, got, recs, _ = served
    decodes = recs["heatmaps_to_keypoints"]
    assert len(decodes[0].calls) == len(decodes[1].calls) == 2
    ties = straddles = rois = 0
    for (hm_r, bx_r, xy_r), (hm_g, bx_g, xy_g) in zip(*(d.calls for d in decodes)):
        tol = 1e-3 * np.abs(hm_r).max()
        np.testing.assert_array_equal(
            tkp.heatmaps_to_keypoints(hm_r, bx_r, min_size=tc.KRCNN.INFERENCE_MIN_SIZE), xy_r)
        assert len(bx_g) == len(bx_r)
        free = set(range(len(bx_g)))
        for i in range(len(bx_r)):
            # the port's roi of this box (tied scores may swap two slots)
            j = min(free, key=lambda j: np.abs(bx_g[j] - bx_r[i]).max())
            free.discard(j)
            rois += 1
            np.testing.assert_allclose(bx_g[j], bx_r[i], rtol=0, atol=2e-3)
            assert np.abs(hm_g[j] - hm_r[i]).max() <= tol
            size = [np.ceil(np.maximum(b[2:] - b[:2], 1.0)) for b in (bx_r[i], bx_g[j])]
            if (size[0] != size[1]).any():
                # a side within 2e-3 of an integer: the decode resizes to
                # another pixel grid, so positions and peaks move apart
                straddles += 1
                continue
            np.testing.assert_allclose(xy_g[j, 2], xy_r[i, 2], rtol=0, atol=2 * tol)  # peaks
            for kp in np.nonzero(np.abs(xy_g[j, :2] - xy_r[i, :2]).max(axis=0) > 1e-3)[0]:
                # a tie: sad_tpu's own resized map at the port's position lies
                # within twice the tolerance of its maximum
                w, h = (int(max(v, tc.KRCNN.INFERENCE_MIN_SIZE)) for v in size[0])
                roi_map = tkp._resize_bicubic(hm_r[i].astype(np.float32), h, w)[..., kp]
                ext = np.maximum(bx_r[i, 2:] - bx_r[i, :2], 1.0)
                px = int((xy_g[j, 0, kp] - bx_r[i, 0]) / (ext[0] / w))
                py = int((xy_g[j, 1, kp] - bx_r[i, 1]) / (ext[1] / h))
                assert roi_map.max() - roi_map[py, px] <= 2 * tol, (i, kp)
                ties += 1
    assert ties <= 8 and straddles <= 0.1 * rois, (ties, straddles, rois)
    areas = [got[j]["bbox"][2] * got[j]["bbox"][3] for _, j in _matched(ref, got)]
    # AREA_TH splits the detections: both subsets of passes are taken
    assert min(areas) < AREA_TH <= max(areas)
    assert all(len(d["keypoints"]) == 51 for d in got)


@pytest.mark.parametrize("over,match", [
    ({"TEST": {"SOFT_NMS": {"ENABLED": True}}}, "TEST.SOFT_NMS without TEST.BBOX_AUG"),
    ({"TEST": {"BBOX_VOTE": {"ENABLED": True}}}, "TEST.BBOX_VOTE without TEST.BBOX_AUG"),
    ({"TEST": {"BBOX_AUG": dict(AUG, ASPECT_RATIOS=(0.5,))}}, "aspect-ratio TTA"),
    ({"TEST": {"BBOX_AUG": dict(AUG, SCORE_HEUR="AVG")}}, "UNION"),
    ({"MODEL": {"MASK_ON": True}, "TEST": {"MASK_AUG": dict(AUG, SCALE_SIZE_DEP=True)}},
     "Size dependent"),
    ({"TEST": {"PROPOSAL_FILES": ("p.pkl",)}}, "FASTER_RCNN True"),
    ({"MODEL": {"RPN_ONLY": True}}, "RPN_ONLY"),
])
def test_what_sad_tpu_ignores_is_refused(over, match):
    """Refused before any work, both entry points, each naming ROADMAP.md's
    note (aspect ratios: sad_tpu refuses them too)."""
    tc = t_merge(t_merge(tcfg.Config(), TINY),
                 {k: dict(TINY.get(k, {}), **v) for k, v in over.items()})
    for call in (lambda: test_engine.run_inference_on_roidb(tc, None, [], {}),
                 lambda: test_engine.test_net_on_dataset(tc, None, "coco_2017_val")):
        with pytest.raises(NotImplementedError, match=match) as e:
            call()
        assert "ROADMAP.md Queue 3" in str(e.value) or "Size dependent" in match


def test_retinanet_ignores_tta_as_sad_tpu_does():
    """RetinaNet's serving takes none of the options: the inference
    function is built (tests/test_torch_inference.py serves it)."""
    over = {"MODEL": {"TYPE": "retinanet"}, "TEST": {"BBOX_AUG": AUG,
                                                     "SOFT_NMS": {"ENABLED": True},
                                                     "BBOX_VOTE": {"ENABLED": True}}}
    test_engine._refuse_unported_inference(t_merge(tcfg.Config(), over))
