"""Fast / Faster / Mask R-CNN serving as a whole: the port's decode and
make_rcnn_inference_fn against sad_tpu's on converted float32 tiny weights
(sad_tpu's NMS is its Pallas kernel interpreted on this CPU, its RoIAlign the
dense form it takes here).

The decode alone runs on identical head outputs: valid, classes and scores
exactly, boxes within 1e-3 px. For the whole slice the kept detections must
be the same (class, score) multiset with scores within 1e-4, boxes within
2e-3 px and mask probabilities within 1e-3: the chain is longer than
RetinaNet's (backbone, RPN, proposal decode, RoIAlign, two dense layers, a
softmax over 4x-scaled logits), and the two frameworks sum every float32
convolution and product in another order. Over the model seeds 20..31, both
models, the kept sets were identical (no IoU landed within float32 rounding
of an NMS threshold, so no seed had to be avoided) and the largest
differences were 2.8e-5 in a score and 6.2e-4 px in a box; seed 21 is used
here. Fast R-CNN (MODEL.FASTER_RCNN False) serves 40 seeded proposals an
image in place of the RPN's. The mask and keypoint heads on fixed boxes
(make_aux_on_boxes_fn) and a test-time-augmentation pass's batch are held
to sad_tpu's as well."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sad_tpu.config as jcfg
from sad_tpu.config import register_dataset
from sad_tpu.config.config import merge_cfg_from_dict as j_merge
from sad_tpu.data.dataset import CocoDataset as JCocoDataset
from sad_tpu.data.synth_coco import generate_synthetic_coco
from sad_tpu.eval import rcnn_inference as j_rcnn_inference
from sad_tpu.eval.rcnn_inference import decode_rcnn_detections as j_decode
from sad_tpu.eval.rcnn_inference import make_rcnn_inference_fn as j_make_rcnn_inference_fn
from sad_tpu.eval.test_engine import prepare_test_batch as j_prepare_test_batch
from sad_tpu.eval.test_engine import run_inference_on_roidb as j_run_inference_on_roidb
from sad_tpu.models import create_model as j_create_model
import sad_tpu_torch.config as tcfg
from sad_tpu_torch.config.config import merge_cfg_from_dict as t_merge
from sad_tpu_torch.convert import load_params
from sad_tpu_torch.data.dataset import CocoDataset
from sad_tpu_torch.data.synthetic import random_proposals
from sad_tpu_torch.eval import rcnn_inference, test_engine
from sad_tpu_torch.eval.rcnn_inference import decode_rcnn_detections, make_rcnn_inference_fn
from sad_tpu_torch.models import GeneralizedRCNN
from test_torch_inference import _kept, canvases
from test_torch_rcnn import TINY, cfg_pair, rcnn_params
from test_torch_models import one_torch_thread  # noqa: F401  (autouse)

KEYS = ("boxes", "scores", "classes", "valid")


def head_outputs(seed, b=2, r=40, c=5, agnostic=False):
    """Identical numpy head outputs for both decodes: rois inside a 96x144
    frame, peaked class probabilities, a tenth of the rois invalid."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, [100, 60], (b, r, 2))
    rois = np.concatenate([xy, xy + rng.uniform(8, 40, (b, r, 2))], axis=-1).astype(np.float32)
    logits = rng.randn(b, r, c) * 2.5
    prob = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    bbox = (rng.randn(b, r, 8 if agnostic else 4 * c) * 0.5).astype(np.float32)
    valid = rng.rand(b, r) > 0.1
    scale = rng.uniform(0.7, 1.4, b).astype(np.float32)
    im_hw = np.round(np.array([[96, 144]] * b) / scale[:, None]).astype(np.float32)
    return rois, valid, prob.astype(np.float32), bbox, im_hw, scale


@pytest.mark.parametrize("agnostic", [False, True], ids=["class_specific", "class_agnostic"])
@pytest.mark.parametrize("cand_topk", [0, 30])
@pytest.mark.parametrize("bbox_reg", [True, False])
def test_decode_alone_on_identical_head_outputs(agnostic, cand_topk, bbox_reg):
    over = {"MODEL": {"CLS_AGNOSTIC_BBOX_REG": agnostic},
            "TEST": {"NMS_CAND_TOPK": cand_topk, "BBOX_REG": bbox_reg}}
    jc, tc = cfg_pair()
    jc = j_merge(jc, {k: dict(TINY.get(k, {}), **v) for k, v in over.items()})
    tc = t_merge(tc, {k: dict(TINY.get(k, {}), **v) for k, v in over.items()})
    args = head_outputs(3 + agnostic, agnostic=agnostic)
    ref = j_decode(jc, *(jnp.asarray(a) for a in args))
    got = decode_rcnn_detections(tc, *(torch.from_numpy(a) for a in args))
    got = {k: v.numpy() for k, v in got.items()}
    assert got["boxes"].shape == (2, 100, 4) and got["valid"].dtype == bool
    np.testing.assert_array_equal(got["valid"], np.asarray(ref["valid"]))
    np.testing.assert_array_equal(got["classes"], np.asarray(ref["classes"]))
    np.testing.assert_array_equal(got["scores"], np.asarray(ref["scores"]))
    np.testing.assert_allclose(got["boxes"], np.asarray(ref["boxes"]), rtol=0, atol=1e-3)
    valid = got["valid"]
    assert 10 < valid.sum() < valid.size  # some slots stay empty, and those hold zeros
    assert (got["boxes"][~valid] == 0).all() and (got["classes"][~valid] == 0).all()
    assert got["classes"][valid].min() >= 1 and got["classes"][valid].max() <= 4


def test_cand_topk_cut_keeps_the_full_result_when_few_candidates_pass():
    """With no more valid candidates than NMS_CAND_TOPK the cut changes
    nothing (TEST.NMS_CAND_TOPK's contract)."""
    _, tc = cfg_pair()
    args = [torch.from_numpy(a) for a in head_outputs(5, r=12)]
    full = decode_rcnn_detections(tc, *args)
    n_valid = int((args[1][:, :, None] & (args[2][:, :, 1:] > tc.TEST.SCORE_THRESH)).sum(dim=(1, 2)).max())
    cut = decode_rcnn_detections(t_merge(tc, {"TEST": dict(TINY["TEST"], NMS_CAND_TOPK=n_valid)}), *args)
    for key in KEYS:
        assert torch.equal(cut[key], full[key]), key


@pytest.fixture(scope="module", params=["faster", "mask", "fast_mask"])
def slice_pair(request):
    """Faster R-CNN, Mask R-CNN, and Fast R-CNN with the mask head on 40
    seeded proposals an image (MODEL.FASTER_RCNN False; a tenth of the slots
    invalid)."""
    fast = request.param == "fast_mask"
    jc, tc = cfg_pair(MASK_ON=request.param != "faster", FASTER_RCNN=not fast)
    jmodel = j_create_model(jc)
    params = rcnn_params(jmodel, seed=21)
    port = load_params(GeneralizedRCNN(tc).eval(), params)
    batch = canvases(0, n=2, canvas=(128, 192))
    if fast:
        rng = np.random.RandomState(7)
        props = np.stack([random_proposals(rng, w, h, 40) for h, w in batch[3]])
        batch = batch + (props, rng.rand(2, 40) > 0.1)
    ref = j_make_rcnn_inference_fn(jc, jmodel)(params, *(jnp.asarray(a) for a in batch))
    got = make_rcnn_inference_fn(tc, port)(*(torch.from_numpy(a) for a in batch))
    return jc, tc, {k: np.asarray(v) for k, v in ref.items()}, {k: v.numpy() for k, v in got.items()}


def test_make_rcnn_inference_fn_matches_sad_tpu(slice_pair):
    _, _, ref, got = slice_pair
    assert got["boxes"].shape == (2, 100, 4) and got["valid"].dtype == bool
    for j in range(2):
        c1, s1, b1 = _kept(ref, j)
        c2, s2, b2 = _kept(got, j)
        assert len(c1) == len(c2) and len(c1) > 0
        np.testing.assert_array_equal(c2, c1)
        np.testing.assert_allclose(s2, s1, rtol=0, atol=1e-4)
        np.testing.assert_allclose(b2, b1, rtol=0, atol=2e-3)
    assert got["valid"].sum() >= 10 and len(np.unique(got["classes"][got["valid"]])) >= 2
    assert (got["boxes"][~got["valid"]] == 0).all()


def test_mask_probabilities_match_sad_tpu(slice_pair):
    jc, _, ref, got = slice_pair
    if not jc.MODEL.MASK_ON:
        assert "mask_prob" not in got and "mask_prob" not in ref
        return
    assert got["mask_prob"].shape == (2, 100, 28, 28, 5) == ref["mask_prob"].shape
    for j in range(2):
        # the same detections in the same slots: greedy NMS emits by score
        valid = got["valid"][j]
        np.testing.assert_array_equal(got["classes"][j], ref["classes"][j])
        np.testing.assert_allclose(got["mask_prob"][j][valid], ref["mask_prob"][j][valid],
                                   rtol=0, atol=1e-3)
    # an invalid slot pools nothing: the mask head sees zeros in every one
    empty = got["mask_prob"][~got["valid"]]
    assert len(empty) > 1 and np.abs(empty - empty[0]).max() < 1e-6


@pytest.fixture(scope="module")
def synth_dataset(tmp_path_factory):
    name = "torch_rcnn_synth_val"
    root = tmp_path_factory.mktemp("torch_rcnn")
    img_dir, ann = generate_synthetic_coco(str(root), split="val", n_images=3, seed=5,
                                           size_range=(80, 160), objects_per_image=(1, 2))
    register_dataset(name, img_dir, ann, allow_override=True)
    tcfg.register_dataset(name, img_dir, ann, allow_override=True)
    return name


def test_run_inference_on_roidb_box_results(synth_dataset):
    jc, tc = cfg_pair()
    jmodel = j_create_model(jc)
    params = rcnn_params(jmodel, seed=21)
    port = load_params(GeneralizedRCNN(tc).eval(), params)
    jds, tds = JCocoDataset(synth_dataset), CocoDataset(synth_dataset)
    ref = j_run_inference_on_roidb(jc, jmodel, params, jds.get_roidb(include_gt=False),
                                   jds.contiguous_to_json, batch_size=2)
    got = test_engine.run_inference_on_roidb(tc, port, tds.get_roidb(include_gt=False),
                                             tds.contiguous_to_json, batch_size=2)
    assert len(got) == len(ref) > 5
    key = lambda d: (d["image_id"], d["category_id"], -d["score"])  # noqa: E731
    for a, b in zip(sorted(ref, key=key), sorted(got, key=key)):
        assert (a["image_id"], a["category_id"]) == (b["image_id"], b["category_id"])
        assert abs(a["score"] - b["score"]) <= 1e-5
        np.testing.assert_allclose(b["bbox"], a["bbox"], rtol=0, atol=1e-3)
    assert len({d["image_id"] for d in got}) == 3


@pytest.mark.parametrize("over,match", [
    ({"MODEL": {"KEYPOINTS_ON": True}, "FPN": {"FPN_ON": False}}, "single-scale"),
    # single-scale serving is ported (tests/test_torch_single_scale_serving.py); a
    # v1up mask head on its body is refused: sad_tpu would build v0up
    ({"FPN": {"FPN_ON": False}, "MODEL": {"MASK_ON": True},
      "MRCNN": {"ROI_MASK_HEAD": "mask_rcnn_heads.mask_rcnn_fcn_head_v1up4convs"}}, "single-scale"),
])
def test_unported_inference_branches_raise(over, match):
    tc = t_merge(t_merge(tcfg.Config(), TINY),
                 {k: dict(TINY.get(k, {}), **v) for k, v in over.items()})
    with pytest.raises(NotImplementedError, match=match):
        make_rcnn_inference_fn(tc, None)


def test_aux_on_boxes_matches_sad_tpu():
    """The mask and keypoint heads on fixed boxes (the passes mask and
    keypoint TTA re-run), in network-input coordinates with invalid slots:
    mask probabilities within 1e-3 and heatmaps within 1e-3 * max of
    sad_tpu's make_aux_on_boxes_fn (the tolerances of the whole-slice tests)."""
    over = dict(TINY, MODEL=dict(TINY["MODEL"], MASK_ON=True, KEYPOINTS_ON=True),
                KRCNN={"CONV_HEAD_DIM": 16, "NUM_STACKED_CONVS": 2, "NUM_KEYPOINTS": 17,
                       "ROI_XFORM_RESOLUTION": 14})
    jc, tc = j_merge(jcfg.Config(), over), t_merge(tcfg.Config(), over)
    jmodel = j_create_model(jc)
    params = rcnn_params(jmodel, seed=21)
    port = load_params(GeneralizedRCNN(tc).eval(), params)
    data, _, _, content = canvases(1, n=2, canvas=(128, 192))
    rng = np.random.RandomState(2)
    boxes = np.stack([random_proposals(rng, w, h, 12) for h, w in content])
    valid = rng.rand(2, 12) > 0.25
    args = (data, boxes, valid, content)
    ref = j_rcnn_inference.make_aux_on_boxes_fn(jc, jmodel)(params, *map(jnp.asarray, args))
    got = rcnn_inference.make_aux_on_boxes_fn(tc, port)(*map(torch.from_numpy, args))
    assert sorted(got) == sorted(ref) == ["kps_heatmaps", "mask_prob"]
    np.testing.assert_allclose(got["mask_prob"].numpy()[valid],
                               np.asarray(ref["mask_prob"])[valid], rtol=0, atol=1e-3)
    hm_r, hm_g = np.asarray(ref["kps_heatmaps"])[valid], got["kps_heatmaps"].numpy()[valid]
    assert np.abs(hm_g - hm_r).max() <= 1e-3 * np.abs(hm_r).max()


@pytest.mark.parametrize("scale,max_size,hflip", [(0, 0, False), (0, 0, True), (48, 96, True),
                                                  (96, 128, False)])
def test_prepare_test_batch_at_a_tta_transform_matches_sad_tpu(synth_dataset, scale, max_size,
                                                               hflip):
    """A TTA pass's batch: the scale clamped to the static canvas (sad_tpu's
    rule, not Detectron's larger canvas) and the content mirrored, not the
    canvas: the arrays of sad_tpu's uint8 batch."""
    jc, tc = cfg_pair()
    roidb = CocoDataset(synth_dataset).get_roidb(include_gt=False)
    canvas = test_engine._test_canvas_shapes(tc)[0]
    ref = j_prepare_test_batch(jc, roidb, canvas, scale, max_size, hflip, as_uint8=True)
    got = test_engine.prepare_test_batch(tc, roidb, canvas, scale, max_size, hflip)
    for k in ("data", "im_hw", "im_scale", "content_hw"):
        np.testing.assert_array_equal(got[k], ref[k])
    if scale == 96:  # clamped to the canvas's 64 rows or 128 columns
        assert ((got["content_hw"] == canvas).any(axis=1)).all()


@pytest.mark.parametrize("over,match", [
    ({"TEST": {"SOFT_NMS": {"ENABLED": True}}}, "SOFT_NMS without TEST.BBOX_AUG"),
    ({"TEST": {"BBOX_VOTE": {"ENABLED": True}}}, "BBOX_VOTE without TEST.BBOX_AUG"),
    ({"TEST": {"PROPOSAL_FILES": ("props.pkl",)}}, "PROPOSAL_FILES with MODEL.FASTER_RCNN True"),
    ({"MODEL": {"TYPE": "rfcn", "MASK_ON": True}}, "R-FCN with MASK_ON"),
])
def test_engine_refuses_unported_rcnn_options(over, match):
    """Both entry points refuse before any work: test_net_on_dataset before
    it reads the dataset. MODEL.MASK_ON is ported (mask results as RLE), and
    so are TTA, soft-NMS and voting under TEST.BBOX_AUG, proposal files
    with MODEL.FASTER_RCNN False (tests/test_torch_tta.py,
    tests/test_torch_fast_rcnn.py) and R-FCN (tests/test_torch_single_scale_serving.py),
    which has no mask head."""
    tc = t_merge(t_merge(tcfg.Config(), TINY),
                 {k: dict(TINY.get(k, {}), **v) for k, v in over.items()})
    with pytest.raises(NotImplementedError, match=match):
        test_engine.run_inference_on_roidb(tc, None, [], {}, batch_size=2)
    with pytest.raises(NotImplementedError, match=match):
        test_engine.test_net_on_dataset(tc, None, "coco_2017_val", batch_size=2)
