"""Single-scale R-CNN serving as a whole on the CPU at f32, against sad_tpu's
jitted functions on the same converted weights: make_rcnn_inference_fn for
C4 Faster, C4 Mask (v0upshare and v0up, the cascaded mask branch), VGG16 and
R-FCN; Fast R-CNN on proposals with a C4 model; make_aux_on_boxes_fn for C4;
and test_net on a C4 Mask model through the port's CLI against sad_tpu's
test_net_on_dataset.

Tolerances as tests/test_torch_rcnn_inference.py's whole-slice ones: the
kept detections the same (class, score) multiset, scores within 1e-4, boxes
within 2e-3 px, mask probabilities within 1e-3 (every slot: both pool the
invalid slots' zero boxes too); test_net's stats within 1e-6 and its masks
pixel for pixel.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sad_tpu.config as jcfg
import sad_tpu_torch.config as tcfg
from sad_tpu.config.config import merge_cfg_from_dict as j_merge
from sad_tpu.eval import rcnn_inference as j_rcnn_inference
from sad_tpu.models import create_model as j_create_model
from sad_tpu.utils import segms as j_segms
from sad_tpu_torch.config.config import merge_cfg_from_dict as t_merge
from sad_tpu_torch.convert import load_params
from sad_tpu_torch.data.synthetic import random_proposals
from sad_tpu_torch.eval import rcnn_inference
from sad_tpu_torch.models import SingleScaleRCNN
from test_torch_inference import _kept, canvases
from test_torch_models import one_torch_thread, sad_tpu_native_loaded  # noqa: F401  (autouse)
from test_torch_rcnn import rcnn_params
from test_torch_single_scale import MODELS, V0UP, ss_over
from test_torch_test_net import MASK_VAL, _matched, _read, _run_pair, splits  # noqa: F401

CANVAS = (128, 192)
SERVE = {"TEST": {"SCALES": (128,), "MAX_SIZE": 192, "RPN_PRE_NMS_TOP_N": 80,
                  "RPN_POST_NMS_TOP_N": 20}}


def _pair(name, seed=21, **top):
    kw = dict(MODELS.get(name, {}))
    over = ss_over(**kw, **SERVE)
    for k, v in top.items():
        over[k] = dict(over.get(k, {}), **v)
    jc, tc = j_merge(jcfg.Config(), over), t_merge(tcfg.Config(), over)
    jmodel = j_create_model(jc)
    params = rcnn_params(jmodel, seed=seed, hw=(64, 64))
    return jc, tc, jmodel, params, load_params(SingleScaleRCNN(tc).eval(), params)


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


def _same_detections(ref, got):
    assert got["boxes"].shape == ref["boxes"].shape
    for j in range(got["boxes"].shape[0]):
        c1, s1, b1 = _kept(ref, j)
        c2, s2, b2 = _kept(got, j)
        assert len(c1) == len(c2) and len(c1) > 0
        np.testing.assert_array_equal(c2, c1)
        np.testing.assert_allclose(s2, s1, rtol=0, atol=1e-4)
        np.testing.assert_allclose(b2, b1, rtol=0, atol=2e-3)
    assert (got["boxes"][~got["valid"]] == 0).all()


@pytest.fixture(scope="module", params=["c4_faster", "c4_mask_v0upshare", "c4_mask_v0up",
                                         "vgg16", "rfcn"])
def served(request):
    """Both make_rcnn_inference_fn's outputs on two uint8 canvases."""
    jc, tc, jmodel, params, port = _pair(request.param)
    batch = canvases(0, n=2, canvas=CANVAS)
    ref = j_rcnn_inference.make_rcnn_inference_fn(jc, jmodel)(
        params, *(jnp.asarray(a) for a in batch))
    got = rcnn_inference.make_rcnn_inference_fn(tc, port)(*(torch.from_numpy(a) for a in batch))
    return request.param, tc, _np(ref), {k: v.numpy() for k, v in got.items()}


def test_detections_match_sad_tpu(served):
    name, _, ref, got = served
    assert sorted(got) == sorted(ref)
    _same_detections(ref, got)
    assert got["valid"].sum() >= 10


def test_cascaded_mask_probabilities_match_sad_tpu(served):
    """The cascade on the kept boxes: RoIAlign at 14, res5 (the box head's
    for v0upshare, mask_res5 for v0up), conv5_mask to 14x14 per class."""
    name, tc, ref, got = served
    if not tc.MODEL.MASK_ON:
        assert "mask_prob" not in got
        return
    assert got["mask_prob"].shape == (2, 100, 14, 14, 4) == ref["mask_prob"].shape
    np.testing.assert_array_equal(got["classes"], ref["classes"])
    np.testing.assert_allclose(got["mask_prob"], ref["mask_prob"], rtol=0, atol=1e-3)


@pytest.mark.parametrize("name", ["c4_mask_v0upshare", "c4_mask_v0up"])
def test_aux_on_boxes_matches_sad_tpu(name):
    """The C4 mask branch on fixed boxes in network-input coordinates (the
    passes MASK_AUG re-runs), invalid slots included."""
    jc, tc, jmodel, params, port = _pair(name, seed=22)
    data, _, _, content = canvases(1, n=2, canvas=CANVAS)
    rng = np.random.RandomState(2)
    boxes = np.stack([random_proposals(rng, w, h, 12) for h, w in content])
    valid = rng.rand(2, 12) > 0.25
    args = (data, boxes, valid, content)
    ref = j_rcnn_inference.make_aux_on_boxes_fn(jc, jmodel)(params, *map(jnp.asarray, args))
    got = rcnn_inference.make_aux_on_boxes_fn(tc, port)(*map(torch.from_numpy, args))
    assert sorted(got) == sorted(ref) == ["mask_prob"]
    np.testing.assert_allclose(got["mask_prob"].numpy(), np.asarray(ref["mask_prob"]), rtol=0,
                               atol=1e-3)


def test_fast_rcnn_on_proposals_with_a_c4_model():
    """MODEL.FASTER_RCNN False: the C4 box head and the cascaded mask on 30
    seeded proposals an image (a tenth invalid), no RPN."""
    jc, tc, jmodel, params, port = _pair("c4_mask_v0upshare", MODEL={"FASTER_RCNN": False})
    batch = canvases(3, n=2, canvas=CANVAS)
    rng = np.random.RandomState(7)
    props = np.stack([random_proposals(rng, w, h, 30) for h, w in batch[3]])
    batch = batch + (props, rng.rand(2, 30) > 0.1)
    ref = _np(j_rcnn_inference.make_rcnn_inference_fn(jc, jmodel)(
        params, *(jnp.asarray(a) for a in batch)))
    got = {k: v.numpy() for k, v in rcnn_inference.make_rcnn_inference_fn(tc, port)(
        *(torch.from_numpy(a) for a in batch)).items()}
    _same_detections(ref, got)
    np.testing.assert_allclose(got["mask_prob"], ref["mask_prob"], rtol=0, atol=1e-3)


@pytest.mark.parametrize("over,err,match", [
    ({"MODEL": {"KEYPOINTS_ON": True}}, NotImplementedError, "no keypoint head"),
    ({"MODEL": {"TYPE": "rfcn", "CLS_AGNOSTIC_BBOX_REG": False}}, ValueError, "class-agnostic"),
    ({"FAST_RCNN": {"ROI_XFORM_SAMPLING_RATIO": 0}}, NotImplementedError, "Queue 3"),
])
def test_serving_refusals(over, err, match):
    """make_rcnn_inference_fn and make_aux_on_boxes_fn refuse before any
    work, with no model to run."""
    merged = ss_over()
    for k, v in over.items():
        merged[k] = dict(merged[k], **v)
    tc = t_merge(tcfg.Config(), merged)
    with pytest.raises(err, match=match):
        rcnn_inference.make_rcnn_inference_fn(tc, None)
    with pytest.raises(err, match=match):
        rcnn_inference.make_aux_on_boxes_fn(tc, None)


def test_test_net_on_a_c4_mask_model_matches_sad_tpu(splits, tmp_path):  # noqa: F811
    """test_net.main --device cpu with a C4 Mask R-CNN (v0up) saved by
    sad_tpu against sad_tpu's test_net_on_dataset: detections, the 12 bbox
    and 12 segm stats within 1e-6, every mask pixel for pixel (the mask
    logits scaled 20x, as spread_rcnn_outputs does on the card, so that no
    probability sits at the threshold)."""
    over = ss_over(mask_head=V0UP, MODEL={"NUM_CLASSES": 9},
                   TEST={"SCALES": (64,), "MAX_SIZE": 96, "RPN_PRE_NMS_TOP_N": 80,
                         "RPN_POST_NMS_TOP_N": 20, "DATASETS": (MASK_VAL,)})
    params = rcnn_params(j_create_model(j_merge(jcfg.Config(), over)), seed=21, hw=(64, 64))
    logits = params["mask_out"]["mask_fcn_logits"]
    logits["kernel"] = logits["kernel"] * 20.0
    ref_dir, got_dir, _, _ = _run_pair(tmp_path, over, params)
    ref, got = _read(ref_dir, "bbox_results.json"), _read(got_dir, "bbox_results.json")
    pairs = _matched(ref, got)
    rr, rg = _read(ref_dir, "results.json"), _read(got_dir, "results.json")
    assert sorted(rg) == sorted(rr) and len(rg) == 24
    for k in rr:
        assert abs(rg[k] - rr[k]) <= 1e-6, (k, rg[k], rr[k])
    filled = 0
    for i, j in pairs:
        a = j_segms.rle_to_mask(ref[i]["segmentation"])
        b = j_segms.rle_to_mask(got[j]["segmentation"])
        np.testing.assert_array_equal(b, a)
        filled += bool(b.any())
    assert filled > len(got) // 2
    timing = _read(got_dir, "timing.json")
    assert timing["images"] == 3 and "eval_segm" in timing
    assert json.dumps(rg)  # finite stats serialise
    assert os.path.exists(os.path.join(got_dir, "results.json"))


def test_test_net_serves_rfcn_as_an_r_cnn(splits, tmp_path):  # noqa: F811
    """test_net.main --device cpu with an R-FCN model: the R-CNN serving
    path (sad_tpu's test_net sends 'rfcn' to its RetinaNet decode, where it
    fails: ROADMAP.md Queue 3): detections and 12 finite bbox stats.""" 
    from sad_tpu_torch.config.config import cfg_to_yaml
    from sad_tpu_torch.tools import test_net
    from sad_tpu_torch.train.checkpoint import save_checkpoint

    over = ss_over(**MODELS["rfcn"], MODEL={"NUM_CLASSES": 9},
                   TEST={"SCALES": (64,), "MAX_SIZE": 96, "RPN_PRE_NMS_TOP_N": 80,
                         "RPN_POST_NMS_TOP_N": 20, "DATASETS": (MASK_VAL,)})
    tc = t_merge(tcfg.Config(), over)
    params = rcnn_params(j_create_model(j_merge(jcfg.Config(), over)), seed=21, hw=(64, 64))
    port = load_params(SingleScaleRCNN(tc).eval(), params)
    pkl, yml = str(tmp_path / "rfcn.pkl"), str(tmp_path / "rfcn.yaml")
    save_checkpoint(pkl, port)
    with open(yml, "w") as f:
        f.write(cfg_to_yaml(tc))
    out = str(tmp_path / "out")
    test_net.main(["--cfg", yml, "--weights", pkl, "--device", "cpu", "--batch-size", "2",
                   "OUTPUT_DIR", out])
    got_dir = os.path.join(out, "test", MASK_VAL)
    res = _read(got_dir, "results.json")
    assert len(res) == 12 and all(np.isfinite(v) for v in res.values())
    dets = _read(got_dir, "bbox_results.json")
    assert len(dets) > 10 and {d["image_id"] for d in dets}
