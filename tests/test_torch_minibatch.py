"""The port's copies of the host data modules against sad_tpu's, on the same
entries and images: anchors and label assignment, the minibatch builder
(labels, fg_mask and fg_num exactly equal, bbox targets within 1e-6), the
uint8 resize (the same bytes on an upscale and a downscale), the COCO
dataset reader, and the R-CNN-only branches that the copies refuse.

sad_tpu's label assignment takes its native C++ pass when the extension
builds (float32 IoU), its float64 numpy pass otherwise; the port always takes
its own copy of the native pass. The assignment test runs sad_tpu both ways:
its seeds reach no tie where the two precisions part
(tests/test_torch_label_ties.py holds seeds that do)."""

import numpy as np
import pytest

import sad_tpu.config as jcfg
import sad_tpu.data.anchors as janchors
import sad_tpu.data.minibatch as jmb
import sad_tpu_torch.config as tcfg
import sad_tpu_torch.data.anchors as tanchors
import sad_tpu_torch.data.minibatch as tmb
from sad_tpu.config.config import merge_cfg_from_dict as jmerge
from sad_tpu.data.dataset import CocoDataset as JDataset
from sad_tpu.data.synth_coco import generate_synthetic_coco
from sad_tpu_torch.config.config import merge_cfg_from_dict as tmerge
from sad_tpu_torch.data import dataset as tdataset
from sad_tpu_torch.data.dataset import CocoDataset as TDataset
from sad_tpu_torch.utils.vis import vis_one_image
from test_torch_models import one_torch_thread  # noqa: F401  (autouse)

CFG = {
    "MODEL": {"TYPE": "distillation", "NUM_CLASSES": 81},
    "FPN": {"FPN_ON": True, "RPN_MIN_LEVEL": 3, "RPN_MAX_LEVEL": 7,
            "EXTRA_CONV_LEVELS": True, "COARSEST_STRIDE": 128},
    "RETINANET": {"RETINANET_ON": True, "ASPECT_RATIOS": (1.0, 2.0, 0.5),
                  "SCALES_PER_OCTAVE": 3},
    "TRAIN": {"SCALES": (192, 224), "MAX_SIZE": 320, "IMS_PER_BATCH": 2},
    "PIXEL_STD": (57.375, 57.12, 58.395),
}


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    img_dir, ann = generate_synthetic_coco(str(root), n_images=16, seed=4,
                                           size_range=(120, 420), n_categories=8)
    jcfg.register_dataset("torch_mb_synth", img_dir, ann, allow_override=True)
    tcfg.register_dataset("torch_mb_synth", img_dir, ann, allow_override=True)
    return "torch_mb_synth"


def test_dataset_reader_equal(synth):
    jr, tr = JDataset(synth).get_roidb(), TDataset(synth).get_roidb()
    assert len(jr) == len(tr) == 16
    for a, b in zip(jr, tr):
        assert sorted(a) == sorted(b)
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
            else:
                assert a[k] == b[k], k


def test_cell_anchors_equal():
    for lvl in range(3, 8):
        assert np.array_equal(
            tanchors.retinanet_cell_anchors(lvl, 4.0, (1.0, 2.0, 0.5), 3),
            janchors.retinanet_cell_anchors(lvl, 4.0, (1.0, 2.0, 0.5), 3))


def _assign_equal(jout, tout):
    (jl, jt, jm, jfg, jbg), (tl, tt, tm, tfg, tbg) = jout, tout
    assert (jfg, jbg) == (tfg, tbg)
    for a, b in zip(jl, tl):
        assert np.array_equal(a, b)
    for a, b in zip(jm, tm):
        assert np.array_equal(a, b)
    for a, b in zip(jt, tt):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)


@pytest.mark.parametrize("native", [True, False], ids=["sad_tpu_native", "sad_tpu_numpy"])
def test_label_assignment_equal(monkeypatch, native):
    rng = np.random.RandomState(7)
    jgrid = janchors.all_field_anchors((3, 4, 5, 6, 7), 4.0, (1.0, 2.0, 0.5), 3, 384, 384)
    tgrid = tanchors.all_field_anchors((3, 4, 5, 6, 7), 4.0, (1.0, 2.0, 0.5), 3, 384, 384)
    assert np.array_equal(jgrid.flat_anchors(), tgrid.flat_anchors())
    if not native:
        import sad_tpu.native as jnative

        def refuse(*_):
            raise RuntimeError("native pass disabled for this case")

        monkeypatch.setattr(jnative, "assign_overlaps", refuse)
        monkeypatch.setattr(jnative, "bbox_overlaps", refuse)
    for _ in range(6):
        k = rng.randint(1, 9)
        x1, y1 = rng.uniform(0, 300, k), rng.uniform(0, 200, k)
        boxes = np.stack([x1, y1, x1 + rng.uniform(4, 200, k), y1 + rng.uniform(4, 160, k)],
                         1).astype(np.float32)
        classes = rng.randint(1, 81, k).astype(np.int32)
        _assign_equal(janchors.assign_retinanet_labels(jgrid, boxes, classes, 256, 384),
                      tanchors.assign_retinanet_labels(tgrid, boxes, classes, 256, 384))


@pytest.mark.parametrize("device_normalize", [True, False])
def test_minibatch_builder_equal(synth, device_normalize):
    jc = jmerge(jcfg.Config(), CFG)
    tc = tmerge(tcfg.Config(), CFG)
    teacher = {"PIXEL_MEANS": (100.0, 110.0, 120.0)}
    jb = jmb.RetinaNetMinibatchBuilder(jc, jmerge(jc, teacher), device_normalize)
    tb = tmb.RetinaNetMinibatchBuilder(tc, tmerge(tc, teacher), device_normalize)
    roidb = [e for e in TDataset(synth).get_roidb() if e["width"] >= e["height"]][:4]
    assert len(roidb) == 4
    for seed in (0, 3):
        j, t = jb.build(roidb, seed=seed), tb.build(roidb, seed=seed)
        for key in ("data", "teacher_data", "data_u8", "content_hw", "fg_num", "im_hw",
                    "im_scale"):
            a, b = getattr(j, key), getattr(t, key)
            assert (a is None) == (b is None), key
            if a is not None:
                assert a.dtype == b.dtype and np.array_equal(a, b), key
        for lvl in tc.fpn_levels():
            assert np.array_equal(j.labels[lvl], t.labels[lvl])
            assert np.array_equal(j.fg_mask[lvl], t.fg_mask[lvl])
            np.testing.assert_allclose(t.bbox_targets[lvl], j.bbox_targets[lvl], rtol=0,
                                       atol=1e-6)
        assert t.fg_num.sum() > 0


@pytest.mark.parametrize("scale", [1.6, 0.55], ids=["upscale", "downscale"])
def test_resize_same_bytes(scale):
    im = np.random.RandomState(2).randint(0, 256, (97, 131, 3), dtype=np.uint8)
    a, b = jmb.resize_bgr_u8(im, scale), tmb.resize_bgr_u8(im, scale)
    assert a.shape == b.shape == (round(97 * scale), round(131 * scale), 3)
    assert a.dtype == b.dtype == np.uint8 and a.tobytes() == b.tobytes()


def test_resize_bilinear_numpy_path_equals_cv2(monkeypatch):
    """The copy's numpy fallback (taken where cv2 is missing) against cv2."""
    if tmb._cv2 is None:
        pytest.skip("cv2 is not installed: the numpy path is the one that runs")
    m = np.random.RandomState(3).uniform(0, 255, (61, 83, 3)).astype(np.float32)
    want = tmb._resize_bilinear(m, 37, 50)
    monkeypatch.setattr(tmb, "_cv2", None)
    got = tmb._resize_bilinear(m, 37, 50)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_rcnn_only_branches_refuse():
    entry = {"width": 10, "boxes": np.zeros((1, 4), np.float32), "segms": [[[0, 0, 1, 1, 2, 2]]],
             "gt_keypoints": np.zeros((0, 17, 3), np.float32)}
    # segmentations flip with the entry (Mask R-CNN training); keypoints wait
    assert tdataset.flip_entry(entry)["segms"] == [[[9.0, 0.0, 8.0, 1.0, 7.0, 2.0]]]
    entry = dict(entry, segms=[], gt_keypoints=np.ones((1, 17, 3), np.float32))
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        tdataset.flip_entry(entry)
    flipped = tdataset.flip_entry(dict(entry, gt_keypoints=np.zeros((0, 17, 3), np.float32)))
    assert flipped["flipped"] and flipped["boxes"][0, 0] == 9.0
    im = np.zeros((8, 8, 3), np.uint8)
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        vis_one_image(im, np.zeros((1, 4)), np.ones(1), np.ones(1, int),
                      keypoints=[np.zeros(51)])
    assert vis_one_image(im, np.zeros((1, 4)), np.ones(1), np.ones(1, int)).size == (8, 8)
    # mask overlays serve Mask R-CNN's results (ported): a mask tints its pixels
    mask = np.zeros((8, 8), np.uint8)
    mask[2:6, 2:6] = 1
    out = np.asarray(vis_one_image(im, np.zeros((1, 4)), np.ones(1), np.ones(1, int),
                                   segms=[mask]))
    assert out[3:5, 3:5].any() and not out[7, 7].any()
