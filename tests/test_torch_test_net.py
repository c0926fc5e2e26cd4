"""The port's evaluation path on the CPU: ``test_net.main --device cpu``
against sad_tpu's ``test_net_on_dataset`` on synthetic COCO val splits of
3 images (batch 2, so the last batch of each canvas is padded), for a tiny
RetinaNet and a tiny Mask R-CNN (CHANNEL_RATIO 0.0625) whose float32 weights
sad_tpu saved as native pickles, loaded through --weights.

- Detections: the same (image, category) multiset, scores within 1e-4 and
  boxes within 2e-3 px (the whole-slice tolerances of
  tests/test_torch_rcnn_inference.py).
- The 12 bbox stats (and 12 segm_ ones) within 1e-6: the same detections up
  to those tolerances move no IoU across a threshold on these seeds.
- Masks: the mask logits layer is scaled 20x so that probabilities stand away
  from THRESH_BINARIZE, as spread_rcnn_outputs does on the card. A pasted
  pixel may differ only where sad_tpu's resized probability lies within
  1e-3 of the threshold (float32 convolutions sum in other orders in the two
  frameworks); on this seed none differs (the count is asserted).
- The class gather on the device equals sad_tpu's full-array indexing, and
  the results pasted from it are identical.
- Fast R-CNN on TEST.PROPOSAL_FILES (the Mask R-CNN weights with
  MODEL.FASTER_RCNN False, 16 seeded proposals an image): detections, bbox
  and segm stats, masks, as above.
- --range, --vis, the EXPECTED_RESULTS gate, the default device, and every
  branch that stays unported raising NotImplementedError with its
  ROADMAP.md item.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

import sad_tpu.config as jcfg
import sad_tpu_torch.config as tcfg
from sad_tpu.config.config import merge_cfg_from_dict as j_merge
from sad_tpu.eval import test_engine as j_engine
from sad_tpu.models import create_model as j_create_model
from sad_tpu.train import checkpoint as jck
from sad_tpu.utils import segms as j_segms
from sad_tpu_torch.config.config import cfg_to_yaml
from sad_tpu_torch.config.config import merge_cfg_from_dict as t_merge
from sad_tpu_torch.data.synth_coco import generate_synthetic_coco
from sad_tpu_torch.data.synthetic import random_proposals
from sad_tpu_torch.eval import test_engine
from sad_tpu_torch.eval.task_evaluation import ExpectedResultsError
from sad_tpu_torch.tools import test_net
from test_torch_models import one_torch_thread, random_params  # noqa: F401
from test_torch_rcnn import TINY, rcnn_params

RETINA_VAL, MASK_VAL = "torch_tn_retina_val", "torch_tn_mask_val"
BBOX_KEYS = ("AP", "AP50", "AP75", "APs", "APm", "APl",
             "AR1", "AR10", "AR100", "ARs", "ARm", "ARl")
RETINA = {
    "MODEL": {"TYPE": "retinanet", "NUM_CLASSES": 9,
              "CONV_BODY": "FPN.add_fpn_ResNet50_conv5_body"},
    "RESNETS": {"CHANNEL_RATIO": 0.0625},
    "FPN": {"FPN_ON": True, "RPN_MIN_LEVEL": 3, "RPN_MAX_LEVEL": 7,
            "EXTRA_CONV_LEVELS": True, "COARSEST_STRIDE": 128},
    "RETINANET": {"RETINANET_ON": True},
    "TEST": {"SCALES": (64,), "MAX_SIZE": 128, "DATASETS": (RETINA_VAL,)},
    "PIXEL_STD": (57.375, 57.12, 58.395),
    "COMPUTE_DTYPE": "float32",
}
MASK = dict(TINY, MODEL=dict(TINY["MODEL"], NUM_CLASSES=9, MASK_ON=True),
            TEST=dict(TINY["TEST"], DATASETS=(MASK_VAL,)))


def _register(name, img_dir, js):
    jcfg.register_dataset(name, img_dir, js, allow_override=True)
    tcfg.register_dataset(name, img_dir, js, allow_override=True)


@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    """Two val splits of 3 images, sides 80-160: landscape, portrait,
    landscape (both canvases, a padded batch of each) and three landscape
    ones (one canvas for the costlier Mask R-CNN)."""
    root = str(tmp_path_factory.mktemp("test_net_data"))
    out = {}
    for name, split, seed in ((RETINA_VAL, "retina", 0), (MASK_VAL, "mask", 7)):
        img_dir, js = generate_synthetic_coco(root, split, 3, seed=seed, size_range=(80, 160),
                                              objects_per_image=(1, 3))
        _register(name, img_dir, js)
        out[name] = (img_dir, js)
    return out


def _yaml(path, over):
    with open(path, "w") as f:
        f.write(cfg_to_yaml(t_merge(tcfg.Config(), over)))
    return str(path)


def _read(out_dir, name):
    with open(os.path.join(out_dir, name)) as f:
        return json.load(f)


class _Recorder:
    """Wraps a paste_mask_into_image and keeps each call's probabilities
    and box, in the order of the detections they become."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, mp, box, h, w, thresh):
        self.calls.append((np.asarray(mp, np.float32).copy(), np.asarray(box).copy()))
        return self.fn(mp, box, h, w, thresh)


def _run_pair(tmp, over, params, extra=()):
    """sad_tpu's test_net_on_dataset and the port's test_net.main on the same
    weights (a native pickle sad_tpu saved): both output dirs, both pastes'
    recorders and the pickle."""
    jc = j_merge(jcfg.Config(), over)
    pkl = str(tmp / "model.pkl")
    jck.save_checkpoint(pkl, params)
    recs = (_Recorder(j_segms.paste_mask_into_image),
            _Recorder(test_engine.paste_mask_into_image))
    mp = pytest.MonkeyPatch()
    mp.setattr(j_segms, "paste_mask_into_image", recs[0])
    mp.setattr(test_engine, "paste_mask_into_image", recs[1])
    try:
        ref_dir = str(tmp / "jax")
        j_engine.test_net_on_dataset(jc, j_create_model(jc), params, batch_size=2,
                                     output_dir=ref_dir)
        out = str(tmp / "torch")
        test_net.main(["--cfg", _yaml(tmp / "cfg.yaml", over), "--weights", pkl, "--device", "cpu",
                       "--batch-size", "2", *extra, "OUTPUT_DIR", out])
    finally:
        mp.undo()
    got_dir = os.path.join(out, "test", over["TEST"]["DATASETS"][0])
    return ref_dir, got_dir, recs, pkl


@pytest.fixture(scope="module")
def retina_pair(splits, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("test_net_retina")
    jmodel = j_create_model(j_merge(jcfg.Config(), RETINA))
    params = random_params(jmodel, np.zeros((1, 128, 128, 3), np.float32), seed=3)
    return _run_pair(tmp, RETINA, params)


@pytest.fixture(scope="module")
def mask_pair(splits, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("test_net_mask")
    params = rcnn_params(j_create_model(j_merge(jcfg.Config(), MASK)), seed=21)
    logits = params["mask_head"]["mask_fcn_logits"]
    logits["kernel"] = logits["kernel"] * 20.0
    return _run_pair(tmp, MASK, params, ("--vis", "VIS_TH", "0.0"))


def _key(d):
    return d["image_id"], d["category_id"], -d["score"]


def _matched(ref, got):
    assert len(got) == len(ref) > 10
    order_r = sorted(range(len(ref)), key=lambda i: _key(ref[i]))
    order_g = sorted(range(len(got)), key=lambda i: _key(got[i]))
    for i, j in zip(order_r, order_g):
        a, b = ref[i], got[j]
        assert (a["image_id"], a["category_id"]) == (b["image_id"], b["category_id"])
        assert abs(a["score"] - b["score"]) <= 1e-4
        np.testing.assert_allclose(b["bbox"], a["bbox"], rtol=0, atol=2e-3)
    return list(zip(order_r, order_g))


@pytest.mark.parametrize("model", ["retina", "mask"])
def test_detections_and_bbox_stats_match_sad_tpu(model, request):
    ref_dir, got_dir, _, _ = request.getfixturevalue(f"{model}_pair")
    ref, got = _read(ref_dir, "bbox_results.json"), _read(got_dir, "bbox_results.json")
    _matched(ref, got)
    assert len({d["image_id"] for d in got}) == 3
    rr, rg = _read(ref_dir, "results.json"), _read(got_dir, "results.json")
    keys = BBOX_KEYS + (tuple(f"segm_{k}" for k in BBOX_KEYS) if model == "mask" else ())
    assert sorted(rg) == sorted(rr) == sorted(keys)
    for k in keys:
        assert abs(rg[k] - rr[k]) <= 1e-6, (k, rg[k], rr[k])
    timing = _read(got_dir, "timing.json")
    assert timing["images"] == 3 and timing["batches"] == 2
    assert set(test_engine.SPLIT_KEYS) <= set(timing) and timing["eval_bbox"] > 0
    assert ("eval_segm" in timing) == (model == "mask")


def _resized_prob(mp, box, h, w):
    """sad_tpu's paste before its threshold: the probability each image
    pixel is binarized from (0 outside the pasted box)."""
    m = mp.shape[0]
    scale = (m + 2.0) / m
    w_half, h_half = (box[2] - box[0]) * 0.5 * scale, (box[3] - box[1]) * 0.5 * scale
    x_c, y_c = (box[2] + box[0]) * 0.5, (box[3] + box[1]) * 0.5
    ref = np.array([x_c - w_half, y_c - h_half, x_c + w_half, y_c + h_half]).astype(np.int32)
    padded = np.zeros((m + 2, m + 2), np.float32)
    padded[1:-1, 1:-1] = mp
    rw, rh = max(int(ref[2] - ref[0] + 1), 1), max(int(ref[3] - ref[1] + 1), 1)
    prob = j_segms._resize_bilinear(padded, rh, rw)
    out = np.zeros((h, w), np.float32)
    x0, y0 = max(int(ref[0]), 0), max(int(ref[1]), 0)
    x1, y1 = min(int(ref[2]) + 1, w), min(int(ref[3]) + 1, h)
    out[y0:y1, x0:x1] = prob[y0 - ref[1]:y1 - ref[1], x0 - ref[0]:x1 - ref[0]]
    return out


def test_masks_match_sad_tpu(mask_pair):
    ref_dir, got_dir, (rec_ref, rec_got), _ = mask_pair
    ref, got = _read(ref_dir, "bbox_results.json"), _read(got_dir, "bbox_results.json")
    assert len(rec_ref.calls) == len(ref) and len(rec_got.calls) == len(got)
    differ = filled = 0
    for i, j in _matched(ref, got):
        a, b = j_segms.rle_to_mask(ref[i]["segmentation"]), j_segms.rle_to_mask(
            got[j]["segmentation"])
        assert a.shape == b.shape
        filled += bool(b.any())
        diff = a != b
        if diff.any():
            h, w = a.shape
            prob = _resized_prob(*rec_ref.calls[i], h, w)
            assert (np.abs(prob[diff] - 0.5) <= 1e-3).all()
            differ += int(diff.sum())
        np.testing.assert_allclose(rec_got.calls[j][0], rec_ref.calls[i][0], rtol=0, atol=1e-3)
    assert differ == 0
    assert filled > len(got) // 2
    # the scaled logits leave few probabilities near the threshold
    probs = np.stack([mp for mp, _ in rec_ref.calls])
    assert (np.abs(probs - 0.5) < 0.05).mean() < 0.1, (np.abs(probs - 0.5) < 0.05).mean()
    vis = sorted(os.listdir(os.path.join(got_dir, "vis")))
    assert len(vis) == 3 and all(v.endswith(".png") for v in vis)


def test_class_gather_equals_the_full_array_path():
    """What the engine copies to the host (each kept detection's own class
    channel, gathered where mask_prob lies) against sad_tpu's indexing of the
    whole array on the host, at bfloat16 as the flagship config serves:
    equal values, and so equal pastes."""
    gen = torch.Generator().manual_seed(0)
    mask_prob = torch.rand((2, 6, 28, 28, 9), generator=gen).to(torch.bfloat16)
    classes = torch.randint(0, 9, (2, 6), generator=gen, dtype=torch.int32)
    got = test_engine.gather_class_masks(mask_prob, classes)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 6, 28, 28)
    full = mask_prob.float().numpy()
    box = np.array([10.3, 4.7, 60.2, 41.9], np.float32)
    for j in range(2):
        for k in range(6):
            want = full[j, k, :, :, int(classes[j, k])]
            np.testing.assert_array_equal(got[j, k].numpy(), want)
            np.testing.assert_array_equal(
                test_engine.paste_mask_into_image(got[j, k].numpy(), box, 50, 70, 0.5),
                j_segms.paste_mask_into_image(want, box, 50, 70, 0.5))


def test_range_slices_the_roidb(retina_pair, tmp_path):
    """--range 1 3: the detections of images 2 and 3 only (a portrait and a
    landscape image, each a padded batch of its canvas), the same as the
    whole run's for those images; padding makes none."""
    _, got_dir, _, pkl = retina_pair
    full = _read(got_dir, "bbox_results.json")
    out = str(tmp_path / "out")
    test_net.main(["--cfg", _yaml(tmp_path / "cfg.yaml", RETINA), "--weights", pkl,
                   "--device", "cpu", "--batch-size", "2", "--range", "1", "3",
                   "OUTPUT_DIR", out])
    got = _read(os.path.join(out, "test", RETINA_VAL), "bbox_results.json")
    want = [d for d in full if d["image_id"] in (2, 3)]
    assert {d["image_id"] for d in got} == {2, 3}
    _matched(want, got)


def test_expected_results_gate_and_default_device(splits, retina_pair, tmp_path):
    pkl = retina_pair[3]
    yml = _yaml(tmp_path / "cfg.yaml", RETINA)
    opts = ["OUTPUT_DIR", str(tmp_path / "out"), "EXPECTED_RESULTS",
            f"(('{RETINA_VAL}', 'box', 'AP', 0.99),)", "EXPECTED_RESULTS_RTOL", "0.0",
            "EXPECTED_RESULTS_ATOL", "0.0"]
    with pytest.raises(ExpectedResultsError, match="AP"):
        test_net.main(["--cfg", yml, "--weights", pkl, "--device", "cpu", *opts])
    # results were written before the gate ran
    assert sorted(_read(os.path.join(tmp_path, "out", "test", RETINA_VAL), "results.json")) == \
        sorted(BBOX_KEYS)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="does not fall back"):
        test_net.main(["--cfg", yml, "--weights", pkl])


@pytest.mark.parametrize("dataset,base,over,match", [
    ("voc_2007_tn", "retina", {}, "item 9"),
    ("cityscapes_fine_instanceonly_seg_tn", "mask", {}, "item 9"),
    ("vid_tn", "retina", {}, "item 9"),
])
def test_unported_branches_raise_with_their_item(tmp_path, dataset, base, over, match):
    """Each raises before it reads a dataset or builds a model's output."""
    cfg = {"retina": RETINA, "mask": MASK}[base]
    if dataset:
        over = dict(over, TEST={"DATASETS": (dataset,)})
    cfg = dict(cfg, **{k: {**cfg.get(k, {}), **v} for k, v in over.items()})
    yml = _yaml(tmp_path / "cfg.yaml", cfg)
    with pytest.raises(NotImplementedError, match=match):
        test_net.main(["--cfg", yml, "--device", "cpu", "OUTPUT_DIR", str(tmp_path)])


@pytest.fixture(scope="module")
def fast_pair(splits, tmp_path_factory):
    """Fast R-CNN with the mask head (MODEL.FASTER_RCNN False) on a proposal
    file of 30 seeded proposals an image, TEST.PROPOSAL_LIMIT 16: the Mask
    R-CNN weights of ``mask_pair`` (the same tree), both packages."""
    tmp = tmp_path_factory.mktemp("test_net_fast")
    doc = json.load(open(splits[MASK_VAL][1]))
    rng = np.random.RandomState(4)
    pkl = str(tmp / "props.pkl")
    with open(pkl, "wb") as f:
        pickle.dump({"ids": [im["id"] for im in doc["images"]],
                     "boxes": [random_proposals(rng, im["width"], im["height"], 30)
                               for im in doc["images"]]}, f)
    over = dict(MASK, MODEL=dict(MASK["MODEL"], FASTER_RCNN=False),
                TEST=dict(MASK["TEST"], PROPOSAL_FILES=(pkl,), PROPOSAL_LIMIT=16))
    params = rcnn_params(j_create_model(j_merge(jcfg.Config(), MASK)), seed=21)
    logits = params["mask_head"]["mask_fcn_logits"]
    logits["kernel"] = logits["kernel"] * 20.0
    return _run_pair(tmp, over, params)


def test_fast_rcnn_detections_on_proposal_files_match_sad_tpu(fast_pair):
    """test_net with TEST.PROPOSAL_FILES: the proposals attached, the first
    16 of each image served, the same detections as sad_tpu's."""
    ref_dir, got_dir, _, _ = fast_pair
    ref, got = _read(ref_dir, "bbox_results.json"), _read(got_dir, "bbox_results.json")
    _matched(ref, got)
    assert len({d["image_id"] for d in got}) == 3


def test_fast_rcnn_stats_on_proposal_files_match_sad_tpu(fast_pair):
    ref_dir, got_dir, _, _ = fast_pair
    rr, rg = _read(ref_dir, "results.json"), _read(got_dir, "results.json")
    keys = BBOX_KEYS + tuple(f"segm_{k}" for k in BBOX_KEYS)
    assert sorted(rg) == sorted(rr) == sorted(keys)
    for k in keys:
        assert abs(rg[k] - rr[k]) <= 1e-6, (k, rg[k], rr[k])


def test_fast_rcnn_masks_on_proposal_files_match_sad_tpu(fast_pair):
    ref_dir, got_dir, (rec_ref, rec_got), _ = fast_pair
    ref, got = _read(ref_dir, "bbox_results.json"), _read(got_dir, "bbox_results.json")
    for i, j in _matched(ref, got):
        a = j_segms.rle_to_mask(ref[i]["segmentation"])
        b = j_segms.rle_to_mask(got[j]["segmentation"])
        diff = a != b
        if diff.any():
            prob = _resized_prob(*rec_ref.calls[i], *a.shape)
            assert (np.abs(prob[diff] - 0.5) <= 1e-3).all()
        np.testing.assert_allclose(rec_got.calls[j][0], rec_ref.calls[i][0], rtol=0, atol=1e-3)


def test_voc_with_force_json_takes_the_coco_evaluator(splits, tmp_path):
    _register("voc_2007_tn", *splits[RETINA_VAL])
    cfg = dict(RETINA, TEST=dict(RETINA["TEST"], DATASETS=("voc_2007_tn",),
                                 FORCE_JSON_DATASET_EVAL=True))
    results = test_net.main(["--cfg", _yaml(tmp_path / "cfg.yaml", cfg), "--device", "cpu",
                             "--batch-size", "2", "OUTPUT_DIR", str(tmp_path)])
    assert sorted(results) == sorted(BBOX_KEYS)
    assert all(np.isfinite(v) for v in results.values())
