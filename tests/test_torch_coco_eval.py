"""The port's COCO evaluator, mask paste and EXPECTED_RESULTS gate against
sad_tpu's on this CPU.

- COCOEvaluator: all 12 stats (10 under the keypoint protocol) within 1e-12
  of sad_tpu's on seeded datasets: boxes with crowds, explicit 'ignore'
  fields, 'area' fields other than w*h, duplicate detections and empty
  categories (the scenarios of tests/test_coco_eval_oracle.py plus an empty
  category and exact duplicates); masks with polygon, uncompressed-RLE and
  compressed-RLE ground truth and detections in both RLE forms; the
  keypoints of the port's synthetic COCO. The two are the same algorithm on
  the same numpy, so they agree to the last bit; 1e-12 leaves room for
  nothing but summation order.
- Ground truth handed back as detections scores AP 1.0 (bbox and segm).
- paste_mask_into_image bit-equal to sad_tpu's on 200 boxes (partly outside
  the image, sub-pixel, 1 px wide, zero width), with cv2 and with the numpy
  resize that stands in where cv2 does not import.
- check_expected_results passes, fails and reports a missing metric, as
  sad_tpu's does.
"""

import json

import numpy as np
import pytest

import sad_tpu.config as jcfg
import sad_tpu_torch.config as tcfg
from sad_tpu.config.config import merge_cfg_from_dict as j_merge
from sad_tpu.eval import task_evaluation as j_task
from sad_tpu.eval.coco_eval import COCOEvaluator as JEvaluator
from sad_tpu.utils import segms as j_segms
from sad_tpu_torch.config.config import merge_cfg_from_dict as t_merge
from sad_tpu_torch.data import minibatch as t_minibatch
from sad_tpu_torch.data.synth_coco import generate_synthetic_coco
from sad_tpu_torch.eval import task_evaluation as t_task
from sad_tpu_torch.eval.coco_eval import COCOEvaluator, evaluate_boxes
from sad_tpu_torch.utils import segms as t_segms
from test_coco_eval_oracle import _random_scenario

BBOX_KEYS = ("AP", "AP50", "AP75", "APs", "APm", "APl",
             "AR1", "AR10", "AR100", "ARs", "ARm", "ARl")


def counts_to_string(counts):
    """pycocotools' compressed RLE string (maskApi.c rleToString): 5-bit
    groups in ascii 48+, a continuation bit, delta-coded against
    counts[i-2] from the fourth count on."""
    out = []
    for i, x in enumerate(counts):
        x = int(x) - (int(counts[i - 2]) if i > 2 else 0)
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = x != -1 if c & 0x10 else x != 0
            out.append(chr(c + 48 + (0x20 if more else 0)))
    return "".join(out)


def _same_stats(gt, dets, iou_type="bbox"):
    got = COCOEvaluator(gt, iou_type=iou_type).evaluate(dets)
    ref = JEvaluator(gt, iou_type=iou_type).evaluate(dets)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-12, (k, got[k], ref[k])
    return got


@pytest.mark.parametrize("seed", range(6))
def test_bbox_stats_match_sad_tpu(seed):
    rng = np.random.RandomState(seed)
    gt, dets = _random_scenario(rng)
    # an empty category, and exact duplicates of a third of the detections
    gt["categories"].append({"id": 99, "name": "empty"})
    dets = dets + [dict(d) for d in dets[::3]]
    assert any(a["iscrowd"] for a in gt["annotations"]) and any(
        "ignore" in a for a in gt["annotations"])
    got = _same_stats(gt, dets)
    assert sorted(got) == sorted(BBOX_KEYS) and 0 < got["AP"] < 1
    assert evaluate_boxes(gt, dets) == got


def _segm_scenario(seed, h=48, w=64):
    """Masks on 4 images of h x w: polygon ground truth, uncompressed-RLE
    and compressed-RLE ground truth (some crowd), and detections that are
    shifted or cropped copies of them, as uncompressed or compressed RLE,
    plus pure false positives."""
    rng = np.random.RandomState(seed)
    images = [{"id": i + 1, "height": h, "width": w} for i in range(4)]
    cats = [{"id": 1, "name": "a"}, {"id": 2, "name": "b"}, {"id": 3, "name": "empty"}]
    anns, dets = [], []
    for im in images:
        for cat in (1, 2):
            for n in range(rng.randint(1, 4)):
                cx, cy = rng.uniform(8, w - 8), rng.uniform(8, h - 8)
                rx, ry = rng.uniform(2, 14), rng.uniform(2, 12)
                t = np.linspace(0, 2 * np.pi, 9)[:-1]
                poly = np.stack([np.clip(cx + rx * np.cos(t), 0, w - 1),
                                 np.clip(cy + ry * np.sin(t), 0, h - 1)], 1).reshape(-1)
                mask = t_segms.polys_to_mask([poly.tolist()], h, w)
                if mask.sum() < 2:
                    continue
                form = rng.randint(3)
                if form == 0:
                    seg = [poly.tolist()]
                else:
                    seg = t_segms.mask_to_rle(mask)
                    if form == 2:
                        seg = {"size": seg["size"], "counts": counts_to_string(seg["counts"])}
                ys, xs = np.where(mask)
                anns.append({"id": len(anns) + 1, "image_id": im["id"], "category_id": cat,
                             "bbox": [float(xs.min()), float(ys.min()),
                                      float(xs.max() - xs.min() + 1),
                                      float(ys.max() - ys.min() + 1)],
                             "area": float(mask.sum()), "segmentation": seg,
                             "iscrowd": int(form != 0 and rng.rand() < 0.2)})
                for _ in range(rng.randint(1, 3)):
                    dm = np.roll(mask, (rng.randint(-3, 4), rng.randint(-3, 4)), (0, 1))
                    if rng.rand() < 0.3:
                        dm = dm.copy()
                        dm[:, int(cx):] = 0
                    rle = t_segms.mask_to_rle(dm)
                    if rng.rand() < 0.5:
                        rle = {"size": rle["size"], "counts": counts_to_string(rle["counts"])}
                    dets.append({"image_id": im["id"], "category_id": cat, "score": rng.rand(),
                                 "bbox": [cx - rx, cy - ry, 2 * rx, 2 * ry], "segmentation": rle})
            fp = np.zeros((h, w), np.uint8)
            fp[rng.randint(h - 6):, rng.randint(w - 6):][:5, :5] = 1
            dets.append({"image_id": im["id"], "category_id": cat, "score": rng.rand(),
                         "bbox": [0.0, 0.0, 5.0, 5.0], "segmentation": t_segms.mask_to_rle(fp)})
    return {"images": images, "annotations": anns, "categories": cats}, dets


@pytest.mark.parametrize("seed", range(3))
def test_segm_stats_match_sad_tpu(seed):
    gt, dets = _segm_scenario(seed)
    forms = {type(a["segmentation"]).__name__ + str(type(a["segmentation"]).__name__ == "dict"
             and isinstance(a["segmentation"]["counts"], str)) for a in gt["annotations"]}
    assert forms == {"listFalse", "dictFalse", "dictTrue"}
    assert any(isinstance(d["segmentation"]["counts"], str) for d in dets)
    got = _same_stats(gt, dets, "segm")
    assert 0 < got["AP"] < 1


def test_compressed_rle_round_trip():
    """The test's encoder is pycocotools' format: the port's decoder reads
    it back to the counts it was given (negative deltas included)."""
    rng = np.random.RandomState(5)
    for _ in range(20):
        counts = rng.randint(0, 3000, rng.randint(1, 40)).tolist()
        assert t_segms.rle_string_to_counts(counts_to_string(counts)) == counts


def test_keypoint_stats_match_sad_tpu(tmp_path):
    _, js = generate_synthetic_coco(str(tmp_path), "kp", 6, seed=3, size_range=(120, 200),
                                    with_keypoints=True)
    with open(js) as f:
        gt = json.load(f)
    rng = np.random.RandomState(0)
    dets = []
    for a in gt["annotations"]:
        if a.get("iscrowd") or "keypoints" not in a:
            continue
        for _ in range(rng.randint(1, 3)):
            kp = np.asarray(a["keypoints"], np.float64).reshape(-1, 3).copy()
            kp[:, :2] += rng.randn(len(kp), 2) * rng.uniform(0.5, 6)
            kp[:, 2] = 1
            dets.append({"image_id": a["image_id"], "category_id": a["category_id"],
                         "keypoints": kp.reshape(-1).tolist(), "score": rng.rand(),
                         "bbox": a["bbox"]})
    got = _same_stats(gt, dets, "keypoints")
    assert "APs" not in got or got["APs"] == -1.0
    assert got["AP"] > 0


def test_ground_truth_as_detections_scores_one(tmp_path):
    _, js = generate_synthetic_coco(str(tmp_path), "gt", 5, seed=4, size_range=(80, 120),
                                    crowd_frac=0.6)
    with open(js) as f:
        gt = json.load(f)
    dets = []
    for a in gt["annotations"]:
        if a["iscrowd"]:
            continue
        h, w = next((im["height"], im["width"]) for im in gt["images"]
                    if im["id"] == a["image_id"])
        mask = t_segms.polys_to_mask(a["segmentation"], h, w)
        dets.append({"image_id": a["image_id"], "category_id": a["category_id"],
                     "bbox": a["bbox"], "score": 1.0, "segmentation": t_segms.mask_to_rle(mask)})
    assert any(a["iscrowd"] for a in gt["annotations"])
    box = COCOEvaluator(gt).evaluate(dets)
    segm = COCOEvaluator(gt, iou_type="segm").evaluate(dets)
    assert box["AP"] == 1.0 and box["AP50"] == 1.0 and box["AR100"] == 1.0
    assert segm["AP"] == 1.0 and segm["AP75"] == 1.0


def _paste_cases(n=200, res=28, seed=0):
    """Boxes that meet the image, as the clipped decode leaves them (the
    reference's paste indexes out of range for a box wholly outside)."""
    rng = np.random.RandomState(seed)
    im_h, im_w = 90, 130
    for i in range(n):
        mp = rng.rand(res, res).astype(np.float32)
        kind = i % 5
        x1, y1 = rng.uniform(0, im_w - 2), rng.uniform(0, im_h - 2)
        if kind == 0:  # over an edge of the image
            x1, y1 = rng.uniform(-40, im_w - 10), rng.uniform(-40, im_h - 10)
            w, h = rng.uniform(max(10, 2 - x1), 120), rng.uniform(max(10, 2 - y1), 90)
        elif kind == 1:  # sub-pixel
            w, h = rng.uniform(0.05, 0.9), rng.uniform(0.05, 0.9)
        elif kind == 2:  # 1 px wide or tall
            w, h = (1.0, rng.uniform(3, 50)) if i % 2 else (rng.uniform(3, 50), 1.0)
        elif kind == 3:  # zero width or height, as clipping to the image can leave
            w, h = (0.0, rng.uniform(1, 20)) if i % 2 else (rng.uniform(1, 20), 0.0)
        else:
            w, h = rng.uniform(2, 29), rng.uniform(2, 29)
        box = np.array([x1, y1, x1 + w, y1 + h], np.float32)
        yield mp, box, im_h, im_w, float(rng.choice([0.5, 0.3]))


@pytest.mark.parametrize("resize", ["cv2", "numpy"])
def test_paste_is_bit_equal_to_sad_tpu(resize, monkeypatch):
    if resize == "numpy":
        monkeypatch.setattr(j_segms, "_cv2", None)
        monkeypatch.setattr(t_minibatch, "_cv2", None)
    else:
        assert t_minibatch._cv2 is not None and j_segms._cv2 is not None
    filled = 0
    for mp, box, h, w, thr in _paste_cases():
        ref = j_segms.paste_mask_into_image(mp, box, h, w, thr)
        got = t_segms.paste_mask_into_image(mp, box, h, w, thr)
        assert got.dtype == ref.dtype == np.uint8 and got.shape == (h, w)
        np.testing.assert_array_equal(got, ref)
        filled += bool(got.any())
        assert t_segms.mask_to_rle(got) == j_segms.mask_to_rle(ref)
        np.testing.assert_array_equal(t_segms.mask_to_bbox(got), j_segms.mask_to_bbox(ref))
    assert filled > 100


def test_polygon_area_matches_sad_tpu():
    rng = np.random.RandomState(1)
    for _ in range(10):
        poly = rng.uniform(0, 50, 2 * rng.randint(3, 9)).tolist()
        assert t_segms.polygon_area(poly) == j_segms.polygon_area(poly)


def _gate_cfgs(expected):
    over = {"EXPECTED_RESULTS": expected, "EXPECTED_RESULTS_RTOL": 0.0,
            "EXPECTED_RESULTS_ATOL": 0.01}
    return j_merge(jcfg.Config(), over), t_merge(tcfg.Config(), over)


@pytest.mark.parametrize("expected,fails", [
    ((("ds", "box", "AP", 0.5), ("ds", "box", "box_ap", 0.5)), 0),
    ((("ds", "box", "AP", 0.99), ("ds", "box", "AP50", 0.7)), 1),
    ((("ds", "box", "APx", 0.5), ("other", "box", "AP", 0.5)), 2),
])
def test_check_expected_results_matches_sad_tpu(expected, fails):
    results = {"ds": {"box": {"AP": 0.505, "AP50": 0.7}}}
    jc, tc = _gate_cfgs(expected)
    got = t_task.check_expected_results(tc, results, raise_on_failure=False)
    assert got == j_task.check_expected_results(jc, results, raise_on_failure=False)
    assert len(got) == fails
    if fails == 2:
        assert all(m.startswith("missing result") for m in got)
    if fails:
        with pytest.raises(t_task.ExpectedResultsError, match="ds/box|missing"):
            t_task.check_expected_results(tc, results)
    else:
        assert t_task.check_expected_results(tc, results) == []
    assert t_task.aggregate_results(results) is results
