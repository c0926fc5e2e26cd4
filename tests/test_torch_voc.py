"""PASCAL VOC on the CPU: the dataset layer (data/voc_dataset.py), the VOC
protocol (eval/voc_eval.py) and test_net on a ``voc_`` dataset, each against
sad_tpu's counterpart on the same seeded inputs.

- The roidb and ``as_coco_gt`` of a seeded devkit (16 JPEGs at 500x375, 1-6
  objects of the 20 classes, some difficult): equal to sad_tpu's, arrays
  bit for bit.
- ``voc_ap`` (VOC07's 11 points and the area) and ``voc_eval_boxes`` over
  seeded detections with duplicates, misses, difficult and crowd ground
  truth: exactly equal, for both metrics.
- test_net --device cpu with a tiny RetinaNet on that devkit registered as
  ``voc_2007_<split>``: the same detections as sad_tpu's
  test_net_on_dataset within the tolerances of tests/test_torch_test_net.py,
  and the VOC07 results (per-class AP and mAP) within 1e-6; with
  TEST.FORCE_JSON_DATASET_EVAL the COCO evaluator's 12 keys.
"""

import json
import os

import numpy as np
import pytest

from sad_tpu.data import voc_dataset as j_voc
from sad_tpu.eval import voc_eval as j_voc_eval
from sad_tpu_torch.data import voc_dataset
from sad_tpu_torch.data.synth_devkits import write_voc_devkit
from sad_tpu_torch.eval import voc_eval
from sad_tpu_torch.tools import test_net
from test_torch_models import one_torch_thread, random_params, sad_tpu_native_loaded  # noqa: F401
from test_torch_test_net import BBOX_KEYS, RETINA, _matched, _read, _register, _run_pair, _yaml

VOC_NAME = "voc_2007_torchvoc"


@pytest.fixture(scope="module")
def devkit(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("vocdevkit"))
    write_voc_devkit(root, "2007", "test", 16, seed=5)
    return root


def _equal_entries(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k


def test_roidb_and_coco_gt_equal_sad_tpus(devkit):
    ref = j_voc.VOCDataset(devkit, "2007", "test")
    got = voc_dataset.VOCDataset(devkit, "2007", "test")
    assert got.classes == ref.classes and got.image_ids == ref.image_ids
    r_roidb, g_roidb = ref.get_roidb(), got.get_roidb()
    assert len(g_roidb) == 16
    for a, b in zip(r_roidb, g_roidb):
        _equal_entries(a, b)
    n = [len(e["boxes"]) for e in g_roidb]
    assert min(n) >= 1 and max(n) <= 6
    assert any(e["difficult"].any() for e in g_roidb)
    assert got.as_coco_gt(g_roidb) == ref.as_coco_gt(r_roidb)
    for a, b in zip(ref.get_roidb(include_gt=False), got.get_roidb(include_gt=False)):
        _equal_entries(a, b)


@pytest.mark.parametrize("use_07", [True, False])
def test_voc_ap_equals_sad_tpus(use_07):
    rng = np.random.RandomState(3)
    for n in (1, 7, 50):
        rec = np.sort(rng.uniform(0, 1, n))
        prec = rng.uniform(0, 1, n)
        assert voc_eval.voc_ap(rec, prec, use_07) == j_voc_eval.voc_ap(rec, prec, use_07)


def _gt_and_dets(seed):
    """A COCO-format ground truth of 6 images and 3 classes, with difficult
    and crowd boxes, and detections: jittered copies of most boxes (some
    twice), misses and false positives, scores with ties."""
    rng = np.random.RandomState(seed)
    images, anns, dets = [], [], []
    for i in range(1, 7):
        images.append({"id": i, "height": 200, "width": 300})
        for _ in range(rng.randint(1, 6)):
            x, y = rng.uniform(0, 200), rng.uniform(0, 120)
            w, h = rng.uniform(10, 90), rng.uniform(10, 70)
            a = {"id": len(anns) + 1, "image_id": i, "category_id": int(rng.randint(1, 4)),
                 "bbox": [x, y, w, h], "area": w * h, "iscrowd": int(rng.rand() < 0.1),
                 "difficult": bool(rng.rand() < 0.2)}
            anns.append(a)
            for _ in range(rng.choice([0, 1, 1, 2])):
                j = rng.normal(0, 3, 4)
                dets.append({"image_id": i, "category_id": a["category_id"],
                             "bbox": [x + j[0], y + j[1], w + j[2], h + j[3]],
                             "score": float(np.round(rng.uniform(0, 1), 2))})
        for _ in range(rng.randint(0, 3)):
            dets.append({"image_id": i, "category_id": int(rng.randint(1, 4)),
                         "bbox": list(rng.uniform(0, 150, 4) + [0, 0, 5, 5]),
                         "score": float(np.round(rng.uniform(0, 1), 2))})
    cats = [{"id": c, "name": f"c{c}"} for c in (1, 2, 3)]
    return {"images": images, "annotations": anns, "categories": cats}, dets


@pytest.mark.parametrize("use_07", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_voc_eval_boxes_equals_sad_tpus(seed, use_07):
    gt, dets = _gt_and_dets(seed)
    ref = j_voc_eval.voc_eval_boxes(gt, dets, use_07_metric=use_07)
    got = voc_eval.voc_eval_boxes(gt, dets, use_07_metric=use_07)
    assert got == ref
    assert 0.0 < got["mAP"] < 1.0
    perfect = [{"image_id": a["image_id"], "category_id": a["category_id"], "bbox": a["bbox"],
                "score": 1.0} for a in gt["annotations"]]
    # the 11 points add eleven 1/11 in float64
    assert voc_eval.voc_eval_boxes(gt, perfect, use_07_metric=use_07)["mAP"] == pytest.approx(
        1.0, rel=0, abs=1e-12)


@pytest.fixture(scope="module")
def voc_pair(devkit, tmp_path_factory):
    """The devkit as a COCO json registered in both catalogs under a voc_
    name; sad_tpu's test_net_on_dataset and the port's test_net on the same
    tiny RetinaNet (21 classes)."""
    import sad_tpu.config as jcfg
    from sad_tpu.config.config import merge_cfg_from_dict as j_merge
    from sad_tpu.models import create_model as j_create_model

    tmp = tmp_path_factory.mktemp("voc_test_net")
    ds = voc_dataset.VOCDataset(devkit, "2007", "test")
    js = str(tmp / "voc_2007_test.json")
    with open(js, "w") as f:
        json.dump(ds.as_coco_gt(), f)
    _register(VOC_NAME, os.path.join(ds.root, "JPEGImages"), js)
    over = dict(RETINA, MODEL=dict(RETINA["MODEL"], NUM_CLASSES=21),
                TEST=dict(RETINA["TEST"], DATASETS=(VOC_NAME,)))
    jmodel = j_create_model(j_merge(jcfg.Config(), over))
    params = random_params(jmodel, np.zeros((1, 128, 128, 3), np.float32), seed=3)
    return _run_pair(tmp, over, params) + (over,)


def test_test_net_on_a_voc_dataset_matches_sad_tpu(voc_pair):
    ref_dir, got_dir, _, _, _ = voc_pair
    ref, got = _read(ref_dir, "bbox_results.json"), _read(got_dir, "bbox_results.json")
    _matched(ref, got)
    rr, rg = _read(ref_dir, "results.json"), _read(got_dir, "results.json")
    assert sorted(rg) == sorted(rr) and "mAP" in rg and "AP75" not in rg
    assert len(rg) > 10  # the classes the devkit holds, and mAP
    for k in rr:
        assert abs(rg[k] - rr[k]) <= 1e-6, (k, rg[k], rr[k])
    assert _read(got_dir, "timing.json")["eval_bbox"] > 0


def test_force_json_dataset_eval_takes_the_coco_evaluator(voc_pair, tmp_path):
    _, _, _, pkl, over = voc_pair
    cfg = dict(over, TEST=dict(over["TEST"], FORCE_JSON_DATASET_EVAL=True))
    results = test_net.main(["--cfg", _yaml(tmp_path / "cfg.yaml", cfg), "--weights", pkl,
                             "--device", "cpu", "--batch-size", "2", "OUTPUT_DIR",
                             str(tmp_path)])
    assert sorted(results) == sorted(BBOX_KEYS)
