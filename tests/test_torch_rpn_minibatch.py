"""The port's copy of the R-CNN training batches (data/rpn_minibatch.py,
utils/segms.py) against sad_tpu's originals, array for array, on seeded
roidb entries with polygon and RLE instances: labels and rasters exactly,
images and targets within 1e-6. Both read the same image files, and both
take the IoU from the same float32 native pass (sad_tpu/native and its copy
in sad_tpu_torch/native), so ties resolve alike
(tests/test_torch_label_ties.py)."""

import numpy as np
import pytest
from PIL import Image

import sad_tpu.config as jcfg
import sad_tpu_torch.config as tcfg
from sad_tpu.config.config import merge_cfg_from_dict as j_merge
from sad_tpu.data import rpn_minibatch as jrm
from sad_tpu.utils import segms as jsegms
from sad_tpu_torch.config.config import merge_cfg_from_dict as t_merge
from sad_tpu_torch.data import rpn_minibatch as trm
from sad_tpu_torch.data.dataset import flip_entry
from sad_tpu_torch.utils import segms as tsegms
from test_torch_models import one_torch_thread  # noqa: F401  (autouse)

OVER = {
    "MODEL": {"TYPE": "generalized_rcnn", "FASTER_RCNN": True, "MASK_ON": True, "NUM_CLASSES": 5,
              "CONV_BODY": "FPN.add_fpn_ResNet50_conv5_body"},
    "FPN": {"FPN_ON": True, "MULTILEVEL_RPN": True, "MULTILEVEL_ROIS": True,
            "COARSEST_STRIDE": 32},
    "TRAIN": {"SCALES": (96, 128), "MAX_SIZE": 192, "RPN_BATCH_SIZE_PER_IM": 64},
}


def cfgs(**top):
    over = dict(OVER, **top)
    return j_merge(jcfg.Config(), over), t_merge(tcfg.Config(), over)


def entries(tmp_path, seed, n=3):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        h, w = int(rng.randint(80, 140)), int(rng.randint(140, 200))
        path = tmp_path / f"im{seed}_{i}.png"
        Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8)).save(path)
        k = int(rng.randint(1, 5))
        x1, y1 = rng.uniform(0, w - 40, k), rng.uniform(0, h - 40, k)
        x2, y2 = x1 + rng.uniform(12, 38, k), y1 + rng.uniform(12, 38, k)
        boxes = np.stack([x1, y1, x2, y2], 1).astype(np.float32)
        segs = []
        for j in range(k):
            if j % 2:  # an RLE instance: the box itself
                m = np.zeros((h, w), np.uint8)
                m[int(y1[j]):int(y2[j]), int(x1[j]):int(x2[j])] = 1
                segs.append(jsegms.mask_to_rle(m))
            else:  # two polygons: a triangle and a quadrilateral
                segs.append([[x1[j], y1[j], x2[j], y1[j], x1[j], y2[j]],
                             [x1[j], y2[j], x2[j], y2[j], x2[j], y1[j] + 3, x1[j] + 2, y1[j] + 5]])
        crowd = np.zeros(k, bool)
        crowd[-1] = k > 2  # a crowd region is no target
        out.append({"image": str(path), "height": h, "width": w, "flipped": False,
                    "boxes": boxes, "gt_classes": rng.randint(1, 5, k).astype(np.int32),
                    "is_crowd": crowd, "segms": segs})
    return out


def same(ref, got, exact):
    assert type(ref) is type(got) or np.isscalar(ref)
    if isinstance(ref, dict):
        assert sorted(ref) == sorted(got)
        for k in ref:
            same(ref[k], got[k], exact)
    elif np.isscalar(ref):
        assert ref == got
    else:
        assert ref.shape == got.shape and ref.dtype == got.dtype
        if exact:
            np.testing.assert_array_equal(got, ref)
        else:
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_builder_matches_sad_tpu(tmp_path, seed):
    jc, tc = cfgs()
    es = entries(tmp_path, seed)
    ref = jrm.RCNNMinibatchBuilder(jc, max_gt=6).build(es, seed=seed)
    got = trm.RCNNMinibatchBuilder(tc, max_gt=6).build(es, seed=seed)
    assert sorted(ref) == sorted(got)
    for k in ref:
        same(ref[k], got[k], exact=k in ("rpn_labels", "gt_classes", "gt_mask_rasters",
                                         "gt_mask_stride"))
    assert got["gt_mask_rasters"].shape[1:] == (6, 128 // 4, 192 // 4)
    assert got["gt_mask_rasters"].sum() > 50
    assert any((v == 1).any() for v in got["rpn_labels"].values())
    # the uint8 form: the same geometry and targets, raw pixels and their extents
    images = [np.asarray(Image.open(e["image"]).convert("RGB"))[:, :, ::-1].copy() for e in es]
    u8 = trm.RCNNMinibatchBuilder(tc, max_gt=6, device_normalize=True).build(
        es, seed=seed, images_bgr=images)
    assert "data" not in u8 and u8["data_u8"].dtype == np.uint8
    np.testing.assert_array_equal(u8["content_hw"], got["im_hw"])
    for k in ("rpn_labels", "rpn_bbox_targets", "gt_boxes", "gt_mask_rasters"):
        same(got[k], u8[k], exact=True)
    from sad_tpu_torch.data.minibatch import normalize_image
    h, w = (int(v) for v in u8["content_hw"][0])
    np.testing.assert_allclose(
        normalize_image(u8["data_u8"][0, :h, :w], tc.PIXEL_MEANS, tc.PIXEL_DIV, tc.PIXEL_STD),
        got["data"][0, :h, :w], rtol=0, atol=1e-6)


@pytest.mark.parametrize("straddle", [0.0, -1.0])
def test_rpn_labels_and_grid_match(straddle):
    jc, tc = cfgs(TRAIN=dict(OVER["TRAIN"], RPN_STRADDLE_THRESH=straddle))
    jg, tg = jrm.rpn_anchor_grid(jc, 128, 192), trm.rpn_anchor_grid(tc, 128, 192)
    assert jg.levels == tg.levels and jg.field_hw == tg.field_hw
    for a, b in zip(jg.anchors, tg.anchors):
        np.testing.assert_array_equal(a, b)
    gt = np.array([[10, 12, 60, 70], [90, 30, 170, 110], [20, 20, 28, 30]], np.float32)
    for gts in (gt, gt[:0]):
        ref = jrm.assign_rpn_labels(jc, jg, gts, 128, 192, np.random.RandomState(3))
        got = trm.assign_rpn_labels(tc, tg, gts, 128, 192, np.random.RandomState(3))
        for r_lvls, g_lvls, exact in zip(ref, got, (True, False, True, False)):
            for r, g in zip(r_lvls, g_lvls):
                same(r, g, exact)


def test_segms_copy_and_flip(tmp_path):
    rng = np.random.RandomState(4)
    polys = [[3.2, 4.1, 30.5, 6.0, 25.0, 28.7, 5.5, 22.2], [40.0, 10.0, 55.0, 12.0, 47.0, 30.0]]
    np.testing.assert_array_equal(tsegms.polys_to_mask(polys, 40, 64),
                                  jsegms.polys_to_mask(polys, 40, 64))
    m = (rng.rand(17, 23) > 0.6).astype(np.uint8)
    rle = tsegms.mask_to_rle(m)
    assert rle == jsegms.mask_to_rle(m)
    np.testing.assert_array_equal(tsegms.rle_to_mask(rle), m)
    np.testing.assert_array_equal(tsegms.rle_to_mask(rle), jsegms.rle_to_mask(rle))
    assert tsegms.rle_string_to_counts("52203") == jsegms.rle_string_to_counts("52203")
    assert tsegms.flip_segm(polys, 64) == jsegms.flip_segm(polys, 64)
    assert tsegms.flip_segm(rle, 23) == jsegms.flip_segm(rle, 23)
    e = entries(tmp_path, 5, n=1)[0]
    f = flip_entry(e)
    assert f["flipped"] and len(f["segms"]) == len(e["segms"])
    assert f["segms"][0] == jsegms.flip_segm(e["segms"][0], e["width"])


def test_what_is_left_for_later_raises():
    """Nothing is left: the single-scale grid (no MULTILEVEL_RPN) is
    sad_tpu's, one level at log2(RPN.STRIDE) (more in
    tests/test_torch_single_scale.py)."""
    jc, tc = cfgs(FPN=dict(OVER["FPN"], MULTILEVEL_RPN=False))
    ref, got = jrm.rpn_anchor_grid(jc, 128, 192), trm.rpn_anchor_grid(tc, 128, 192)
    assert got.levels == ref.levels == (4,) and got.field_hw == ref.field_hw
    np.testing.assert_array_equal(got.anchors[0], ref.anchors[0])
    # keypoint and proposal batches are ported (tests/test_torch_keypoint_rcnn.py
    # and tests/test_torch_fast_rcnn.py hold them)
    assert trm.RCNNMinibatchBuilder(cfgs(MODEL=dict(OVER["MODEL"], KEYPOINTS_ON=True))[1]).kps_on
    assert trm.RCNNMinibatchBuilder(cfgs(MODEL=dict(OVER["MODEL"], FASTER_RCNN=False))[1]
                                    ).use_proposals


@pytest.mark.parametrize("hflip", [False, True])
def test_pad_proposals_matches_sad_tpu(tmp_path, hflip):
    """Proposals packed at a cap (fewer, more and none an image), scaled to
    network input, and mirrored for a flipped TTA pass: sad_tpu's arrays."""
    ents = entries(tmp_path, 6, n=3)
    rng = np.random.RandomState(1)
    ents[0]["proposal_boxes"] = rng.uniform(0, 80, (7, 4)).astype(np.float32)
    ents[1]["proposal_boxes"] = rng.uniform(0, 80, (30, 4)).astype(np.float32)
    scales = np.float32([0.5, 1.25, 2.0])
    ref = jrm.pad_proposals(ents, 12, scales, hflip=hflip)
    got = trm.pad_proposals(ents, 12, scales, hflip=hflip)
    for a, b in zip(ref, got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)
    assert got[1].sum(axis=1).tolist() == [7, 12, 0]
