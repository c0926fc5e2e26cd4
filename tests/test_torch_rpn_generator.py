"""RPN-only proposals (MODEL.TYPE 'rpn') and the proposal files of the port
against sad_tpu on the CPU, float32, at the tiny R-CNN size of
tests/test_torch_rcnn.py (CHANNEL_RATIO 0.0625, 20 proposals an image).

- create_model builds TYPE 'rpn' as the GeneralizedRCNN tree (its old
  spellings: tests/test_torch_rcnn.py); convert.py carries that tree and a
  FASTER_RCNN False one both ways bit for bit; RPN_ONLY with
  'generalized_rcnn' is refused.
- generate_rpn_on_dataset's proposal pickle against sad_tpu's on the same
  weights and PNG images: ids and counts equal, boxes within 1e-3 px and
  scores within 1e-5 (the proposal tolerances of tests/test_torch_rcnn.py).
- add_proposals_to_roidb bit-equal to sad_tpu's with crowd regions,
  flipped entries, top_k and min_size; evaluate_box_proposals within 1e-12
  over every area range and a limit.
- test_net.main with the rpn YAML shrunk writes rpn_proposals.pkl and
  returns the recall dict.
"""

import os
import pickle

import jax
import numpy as np
import pytest
import torch

import sad_tpu.config as jcfg
import sad_tpu_torch.config as tcfg
from sad_tpu.config.config import merge_cfg_from_dict as j_merge
from sad_tpu.data.dataset import CocoDataset as JCocoDataset
from sad_tpu.eval import rpn_generator as jrg
from sad_tpu.models import create_model as j_create_model
from sad_tpu.train import checkpoint as jck
from sad_tpu_torch.config.config import merge_cfg_from_dict as t_merge
from sad_tpu_torch.convert import load_params, state_dict_to_params
from sad_tpu_torch.data.dataset import CocoDataset
from sad_tpu_torch.data.synth_coco import generate_synthetic_coco
from sad_tpu_torch.eval import rpn_generator as trg
from sad_tpu_torch.models import GeneralizedRCNN, create_model
from sad_tpu_torch.tools import test_net
from test_torch_models import one_torch_thread  # noqa: F401  (autouse)
from test_torch_rcnn import TINY, rcnn_params

RPN_VAL = "torch_rpn_val"
RPN = dict(TINY, MODEL=dict(TINY["MODEL"], TYPE="rpn", NUM_CLASSES=9),
           TEST=dict(TINY["TEST"], DATASETS=(RPN_VAL,)))
CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "sad_tpu_torch", "configs")


def pair(over):
    return j_merge(jcfg.Config(), over), t_merge(tcfg.Config(), over)


@pytest.mark.parametrize("mtype,over", [
    ("rpn", {"RPN_ONLY": True}), ("generalized_rcnn", {"FASTER_RCNN": False}),
])
def test_rpn_and_fast_rcnn_models_convert_both_ways(mtype, over):
    """The same GeneralizedRCNN tree as sad_tpu builds for these types: its
    parameters through convert.py and back, bit for bit."""
    jc, tc = pair(dict(TINY, MODEL=dict(TINY["MODEL"], TYPE=mtype, **over)))
    params = rcnn_params(j_create_model(jc), seed=3)
    port = create_model(tc, "cpu", torch.Generator().manual_seed(0))
    assert isinstance(port, GeneralizedRCNN)
    load_params(port, params)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(state_dict_to_params(port.state_dict()))[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert np.array_equal(a, b), path


def test_rpn_only_flag_with_generalized_rcnn_refused():
    tc = t_merge(tcfg.Config(), dict(TINY, MODEL=dict(TINY["MODEL"], RPN_ONLY=True)))
    with pytest.raises(NotImplementedError, match="MODEL.TYPE 'rpn'.*Queue 3"):
        create_model(tc, "cpu")


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """A 3-image split with a crowd region, all landscape (one canvas, one
    compile of sad_tpu's function), in both catalogs."""
    root = str(tmp_path_factory.mktemp("rpn_data"))
    img_dir, js = generate_synthetic_coco(root, "rpn", 3, seed=23, size_range=(80, 160),
                                          objects_per_image=(1, 3), crowd_frac=0.3)
    jcfg.register_dataset(RPN_VAL, img_dir, js, allow_override=True)
    tcfg.register_dataset(RPN_VAL, img_dir, js, allow_override=True)
    return RPN_VAL


@pytest.fixture(scope="module")
def proposals(split, tmp_path_factory):
    """Both packages' generate_rpn_on_dataset on one weights pickle."""
    jc, tc = pair(RPN)
    jmodel = j_create_model(jc)
    params = rcnn_params(jmodel, seed=21)
    tmp = tmp_path_factory.mktemp("rpn_run")
    ref = jrg.generate_rpn_on_dataset(jc, jmodel, params, batch_size=2,
                                      output_file=str(tmp / "jax.pkl"))
    port = load_params(GeneralizedRCNN(tc).eval(), params)
    got = trg.generate_rpn_on_dataset(tc, port, batch_size=2, output_file=str(tmp / "t.pkl"))
    pkl = str(tmp / "model.pkl")
    jck.save_checkpoint(pkl, params)
    return ref, got, str(tmp / "t.pkl"), pkl


def test_proposal_file_matches_sad_tpu(proposals):
    ref, got, path, _ = proposals
    with open(path, "rb") as f:
        assert set(pickle.load(f)) == {"boxes", "scores", "ids"}
    assert got["ids"] == ref["ids"] and len(got["ids"]) == 3
    for a, b, sa, sb in zip(ref["boxes"], got["boxes"], ref["scores"], got["scores"]):
        assert a.shape == b.shape and len(a) > 10 and b.dtype == np.float32
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-3)
        np.testing.assert_allclose(sb, sa, rtol=0, atol=1e-5)


def _props_file(tmp_path, roidb, seed):
    """Each image's proposals: seeded boxes partly outside the image,
    duplicates, boxes under 2 px and boxes inside crowd regions."""
    rng = np.random.RandomState(seed)
    boxes = []
    for e in roidb:
        w, h = e["width"], e["height"]
        xy = rng.uniform(-10, [w, h], (40, 2))
        b = np.concatenate([xy, xy + rng.uniform(0.5, 60, (40, 2))], 1).astype(np.float32)
        b[3] = b[2]  # a duplicate
        b[4, 2:] = b[4, :2] + 0.4  # under min_size
        crowd = e["boxes"][np.asarray(e["is_crowd"], bool)]
        if len(crowd):
            b[5] = crowd[0] + np.float32([2, 2, -2, -2])  # inside a crowd region
        boxes.append(b)
    path = str(tmp_path / f"props{seed}.pkl")
    with open(path, "wb") as f:
        pickle.dump({"ids": [e["id"] for e in roidb][::-1], "boxes": boxes[::-1]}, f)
    return path


@pytest.mark.parametrize("flip,top_k,crowd,min_size", [
    (False, -1, 0.0, 2.0), (True, 12, 0.7, 2.0), (True, -1, 0.3, 5.0), (False, 8, 0.7, 0.0)])
def test_add_proposals_to_roidb_bit_equal(split, tmp_path, flip, top_k, crowd, min_size):
    jroidb = JCocoDataset(split).get_roidb(include_gt=True)
    troidb = CocoDataset(split).get_roidb(include_gt=True)
    assert any(np.asarray(e["is_crowd"]).any() for e in troidb)
    if flip:
        from sad_tpu.data.dataset import flip_entry as jflip
        from sad_tpu_torch.data.dataset import flip_entry as tflip

        jroidb, troidb = [jflip(e) for e in jroidb], [tflip(e) for e in troidb]
    path = _props_file(tmp_path, troidb, 1)
    jrg.add_proposals_to_roidb(jroidb, path, top_k, crowd, min_size)
    trg.add_proposals_to_roidb(troidb, path, top_k, crowd, min_size)
    n = 0
    for a, b in zip(jroidb, troidb):
        assert b["proposal_boxes"].dtype == np.float32
        np.testing.assert_array_equal(b["proposal_boxes"], a["proposal_boxes"])
        n += len(b["proposal_boxes"])
    assert n > 10


@pytest.mark.parametrize("area", list(trg.AREA_RANGES))
def test_evaluate_box_proposals_matches(split, tmp_path, area):
    roidb = CocoDataset(split).get_roidb(include_gt=True)
    path = _props_file(tmp_path, roidb, 2)
    with open(path, "rb") as f:
        props = pickle.load(f)
    props["boxes"] = [np.concatenate([e["boxes"] + 1.5, b]) for b, e in
                      zip(props["boxes"], roidb[::-1])]  # some gt covered well, first
    jroidb = JCocoDataset(split).get_roidb(include_gt=True)
    for limit in (None, 30):
        ref = jrg.evaluate_box_proposals(props, jroidb, area=area, limit=limit)
        got = trg.evaluate_box_proposals(props, roidb, area=area, limit=limit)
        assert got["num_pos"] == ref["num_pos"]
        assert abs(got["ar"] - ref["ar"]) <= 1e-12
        np.testing.assert_allclose(got["recalls"], ref["recalls"], rtol=0, atol=1e-12)
    if area == "all":
        assert 0 < got["ar"] < 1 and got["num_pos"] > 3


def test_test_net_writes_proposals_and_returns_recall(proposals, tmp_path):
    """The rpn YAML shrunk to the tiny size: test_net serves TEST.DATASETS[0]
    into OUTPUT_DIR/test/<dataset>/rpn_proposals.pkl and returns its recall,
    the port's proposals scored against the split's ground truth."""
    ref, _, _, pkl = proposals
    opts = ["RESNETS.CHANNEL_RATIO", "0.0625", "MODEL.NUM_CLASSES", "9", "COMPUTE_DTYPE",
            "float32", "TEST.SCALES", "(64,)", "TEST.MAX_SIZE", "96", "FPN.COARSEST_STRIDE",
            "64", "TEST.RPN_PRE_NMS_TOP_N", "50",
            "TEST.RPN_POST_NMS_TOP_N", "20", "FAST_RCNN.MLP_HEAD_DIM", "32",
            "FAST_RCNN.ROI_XFORM_RESOLUTION", "7",
            "TEST.DATASETS", f"('{RPN_VAL}',)", "OUTPUT_DIR", str(tmp_path)]
    rec = test_net.main(["--cfg", os.path.join(CONFIGS, "rpn_R-50-FPN.yaml"), "--weights", pkl,
                         "--device", "cpu", "--batch-size", "2", *opts])
    path = os.path.join(str(tmp_path), "test", RPN_VAL, "rpn_proposals.pkl")
    assert rec["proposal_file"] == path and os.path.exists(path)
    with open(path, "rb") as f:
        written = pickle.load(f)
    assert written["ids"] == ref["ids"]
    for a, b in zip(ref["boxes"], written["boxes"]):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-3)
    gt = JCocoDataset(RPN_VAL).get_roidb(include_gt=True)
    want = jrg.evaluate_box_proposals(ref, gt)
    assert rec["num_pos"] == want["num_pos"] > 3
    assert abs(rec["ar"] - want["ar"]) <= 1e-6 and 0 <= rec["ar"] <= 1
