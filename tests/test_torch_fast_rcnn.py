"""Fast R-CNN (MODEL.FASTER_RCNN False) on precomputed proposals in the port
against sad_tpu on the CPU, float32, at the tiny R-CNN sizes of
tests/test_torch_rcnn.py and tests/test_torch_rcnn_train.py (CHANNEL_RATIO
0.0625), converted weights and seeded numpy proposals.

- Serving: make_rcnn_inference_fn on (B = 2, P = 16) proposals, some slots
  invalid, against sad_tpu's: the kept detections at the whole-slice
  tolerances of tests/test_torch_rcnn_inference.py (scores 1e-4, boxes
  2e-3 px). Without proposals both raise.
- run_inference_on_roidb on TEST.PROPOSAL_FILES (attach_test_proposals
  bit-equal to sad_tpu's) with a BBOX_AUG h-flip pass that serves flipped
  proposals (the pass sad_tpu's tests/test_fast_rcnn_proposals.py guards)
  against sad_tpu's engine; the pairing ValueErrors of TEST and
  TRAIN.PROPOSAL_FILES. test_net.main --device cpu on a proposal file
  against sad_tpu's test_net_on_dataset is in tests/test_torch_test_net.py.
- Training: RCNNMinibatchBuilder's proposal batches equal to sad_tpu's (a
  rank's rows equal to the whole batch's); the step on 2 gloo ranks against
  one process, as tests/test_torch_distributed.py holds the Faster step;
  both loaders feeding the same proposal batches; train_net on
  TRAIN.PROPOSAL_FILES for 2 iterations. Two steps on
  proposals against sad_tpu's make_rcnn_train_step are in
  tests/test_torch_rcnn_train.py.
"""

import json
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sad_tpu.config as jcfg
import sad_tpu_torch.config as tcfg
from sad_tpu.config.config import merge_cfg_from_dict as j_merge
from sad_tpu.data import rpn_minibatch as jrm
from sad_tpu.data.dataset import CocoDataset as JCocoDataset
from sad_tpu.eval import rcnn_inference as j_rcnn_inference
from sad_tpu.eval import test_engine as j_engine
from sad_tpu.eval.rpn_generator import add_proposals_to_roidb as j_add_proposals
from sad_tpu.models import create_model as j_create_model
from sad_tpu_torch.config.config import cfg_to_yaml
from sad_tpu_torch.config.config import merge_cfg_from_dict as t_merge
from sad_tpu_torch.convert import load_params
from sad_tpu_torch.data import rpn_minibatch as trm
from sad_tpu_torch.data.dataset import CocoDataset
from sad_tpu_torch.data.synth_coco import generate_synthetic_coco
from sad_tpu_torch.data.synthetic import random_proposals
from sad_tpu_torch.eval import test_engine
from sad_tpu_torch.eval.rcnn_inference import make_rcnn_inference_fn
from sad_tpu_torch.eval.rpn_generator import add_proposals_to_roidb
from sad_tpu_torch.models import GeneralizedRCNN
from sad_tpu_torch.tools import profile_ddp, profile_train, train_net
from sad_tpu_torch.parallel.launch import spawn
from test_torch_distributed import CONFIGS, G, LR, RCNN_OPTS, STEPS, TIMEOUT_S, W, _check_against_one
from test_torch_inference import _kept, canvases
from test_torch_models import one_torch_thread  # noqa: F401  (autouse)
from test_torch_rcnn import TINY, rcnn_params
from test_torch_rcnn_train import TINY as TRAIN_TINY
from test_torch_rpn_minibatch import OVER as MB_OVER
from test_torch_rpn_minibatch import entries as mb_entries
from test_torch_rpn_minibatch import same

FAST_VAL, FAST_TRAIN = "torch_fast_val", "torch_fast_train"
FAST = dict(TINY, MODEL=dict(TINY["MODEL"], FASTER_RCNN=False))


def pair(over):
    return j_merge(jcfg.Config(), over), t_merge(tcfg.Config(), over)


def seeded_proposals(seed, content_hw, p=20):
    """(B, P, 4) proposals in network-input coordinates spread over each
    image's content, and their valid flags with a few slots off."""
    rng = np.random.RandomState(seed)
    props = np.stack([random_proposals(rng, w, h, p) for h, w in content_hw])
    valid = rng.rand(*props.shape[:2]) > 0.15
    valid[1, -4:] = False
    return props, valid


# ------------------------------------------------------------------ serving


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """A 3-image val split (both canvases) and a 4-image train split, in
    both catalogs, each with a proposal pickle of 24 seeded proposals an
    image (some near the gt boxes, a duplicate, one too small)."""
    root = tmp_path_factory.mktemp("fast_data")
    out = {}
    for name, sp, n, seed in ((FAST_VAL, "val", 3, 3), (FAST_TRAIN, "train", 4, 4)):
        img_dir, js = generate_synthetic_coco(str(root), sp, n, seed=seed, size_range=(80, 160),
                                              objects_per_image=(1, 3))
        jcfg.register_dataset(name, img_dir, js, allow_override=True)
        tcfg.register_dataset(name, img_dir, js, allow_override=True)
        rng = np.random.RandomState(seed)
        doc = json.load(open(js))
        gts = {}
        for a in doc["annotations"]:
            x, y, w, h = a["bbox"]
            gts.setdefault(a["image_id"], []).append([x, y, x + w - 1, y + h - 1])
        boxes, ids = [], []
        for im in doc["images"]:
            b = random_proposals(rng, im["width"], im["height"], 24,
                                 np.asarray(gts.get(im["id"], np.zeros((0, 4))), np.float32))
            b[5] = b[4]  # a duplicate
            b[6, 2:] = b[6, :2] + 0.5  # under min_size
            boxes.append(b)
            ids.append(im["id"])
        pkl = str(root / f"{name}_props.pkl")
        with open(pkl, "wb") as f:
            pickle.dump({"boxes": boxes, "scores": [np.ones(len(b), np.float32) for b in boxes],
                         "ids": ids}, f)
        out[name] = pkl
    return out


def _yaml(path, over):
    with open(path, "w") as f:
        f.write(cfg_to_yaml(t_merge(tcfg.Config(), over)))
    return str(path)


def _key(d):
    return d["image_id"], d["category_id"], -d["score"]


def _matched(ref, got):
    assert len(got) == len(ref) > 5
    for a, b in zip(sorted(ref, key=_key), sorted(got, key=_key)):
        assert (a["image_id"], a["category_id"]) == (b["image_id"], b["category_id"])
        assert abs(a["score"] - b["score"]) <= 1e-4
        np.testing.assert_allclose(b["bbox"], a["bbox"], rtol=0, atol=2e-3)


@pytest.fixture(scope="module")
def served(split, tmp_path_factory):
    """The config, weights and models of the module's serving runs, sad_tpu's
    box function jitted once for all of them (the same shapes)."""
    over = dict(FAST, TEST=dict(TINY["TEST"], DATASETS=(FAST_VAL,),
                                PROPOSAL_FILES=(split[FAST_VAL],), PROPOSAL_LIMIT=16))
    jc, tc = pair(over)
    jmodel = j_create_model(jc)
    params = rcnn_params(jmodel, seed=21)
    made = {}
    mp = pytest.MonkeyPatch()
    fn = j_rcnn_inference.make_rcnn_inference_fn
    mp.setattr(j_rcnn_inference, "make_rcnn_inference_fn",
               lambda cfg, model: made.setdefault(id(model), fn(cfg, model)))
    yield over, jc, tc, jmodel, params, load_params(GeneralizedRCNN(tc).eval(), params)
    mp.undo()


def test_serving_on_proposals_matches_sad_tpu(served):
    """make_rcnn_inference_fn on a batch of 16 seeded proposals an image;
    the mask head on its detections is held in
    tests/test_torch_rcnn_inference.py (slice 'fast_mask')."""
    _, jc, tc, jmodel, params, port = served
    batch = canvases(0, n=2, canvas=test_engine._test_canvas_shapes(tc)[0])
    props, valid = seeded_proposals(1, batch[3], p=16)
    ref = j_rcnn_inference.make_rcnn_inference_fn(jc, jmodel)(
        params, *(jnp.asarray(a) for a in batch + (props, valid)))
    infer = make_rcnn_inference_fn(tc, port)
    got = infer(*(torch.from_numpy(a) for a in batch + (props, valid)))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = {k: v.numpy() for k, v in got.items()}
    for j in range(2):
        c1, s1, b1 = _kept(ref, j)
        c2, s2, b2 = _kept(got, j)
        assert len(c1) == len(c2) > 3
        np.testing.assert_array_equal(c2, c1)
        np.testing.assert_allclose(s2, s1, rtol=0, atol=1e-4)
        np.testing.assert_allclose(b2, b1, rtol=0, atol=2e-3)
    assert (got["boxes"][~got["valid"]] == 0).all()
    with pytest.raises(ValueError, match="needs precomputed proposals"):
        infer(*(torch.from_numpy(a) for a in batch))


def test_flipped_proposals_in_a_tta_pass_match_sad_tpu(served):
    over, jc, tc, jmodel, params, port = served
    aug = {"TEST": {"BBOX_AUG": {"ENABLED": True, "H_FLIP": True}}}
    jc, tc = j_merge(jc, aug), t_merge(tc, aug)
    jds, tds = JCocoDataset(FAST_VAL), CocoDataset(FAST_VAL)
    jroidb, troidb = jds.get_roidb(include_gt=False), tds.get_roidb(include_gt=False)
    j_add_proposals(jroidb, over["TEST"]["PROPOSAL_FILES"][0], top_k=16)
    test_engine.attach_test_proposals(tc, troidb, FAST_VAL)
    for a, b in zip(jroidb, troidb):
        np.testing.assert_array_equal(b["proposal_boxes"], a["proposal_boxes"])
    ref = j_engine.run_inference_on_roidb(jc, jmodel, params, jroidb, jds.contiguous_to_json, 2)
    timing = {}
    got = test_engine.run_inference_on_roidb(tc, port, troidb, tds.contiguous_to_json, 2,
                                             timing=timing)
    _matched(ref, got)
    assert timing["aug_box_passes"] > 0


def test_proposal_file_pairing_raises(served, tmp_path):
    over, _, tc, _, _, _ = served
    with pytest.raises(ValueError, match="not in TEST.DATASETS"):
        test_engine.test_net_on_dataset(tc, None, dataset_name=FAST_TRAIN)
    two = t_merge(tc, {"TEST": {"DATASETS": (FAST_VAL, FAST_TRAIN)}})
    with pytest.raises(ValueError, match="pair 1:1"):
        test_engine.test_net_on_dataset(two, None, dataset_name=FAST_TRAIN)
    bad = dict(FAST, TRAIN=dict(TINY.get("TRAIN", {}), DATASETS=(FAST_VAL, FAST_TRAIN),
                                PROPOSAL_FILES=(over["TEST"]["PROPOSAL_FILES"][0],)))
    with pytest.raises(ValueError, match="pair 1:1 with TRAIN.DATASETS"):
        train_net.main(["--cfg", _yaml(tmp_path / "bad.yaml", bad), "--skip-test", "--device",
                        "cpu", "OUTPUT_DIR", str(tmp_path)])


# ----------------------------------------------------------------- training


def test_proposal_batches_match_sad_tpu(tmp_path):
    """RCNNMinibatchBuilder with FASTER_RCNN False: no RPN targets,
    'proposal_boxes' / 'proposal_valid' at max_proposals, flipped entries
    with their proposals flipped by add_proposals_to_roidb; a rank's rows
    built alone equal to the whole batch's."""
    over = dict(MB_OVER, MODEL=dict(MB_OVER["MODEL"], FASTER_RCNN=False))
    jc, tc = pair(over)
    ents = mb_entries(tmp_path, 5)
    rng = np.random.RandomState(0)
    pkl = str(tmp_path / "p.pkl")
    ids = list(range(len(ents)))
    with open(pkl, "wb") as f:
        pickle.dump({"ids": ids, "boxes": [random_proposals(rng, e["width"], e["height"], 30,
                                                            e["boxes"]) for e in ents]}, f)
    for i, e in enumerate(ents):
        e["id"] = i
    ents[1] = dict(ents[1], flipped=True)
    jents = [dict(e) for e in ents]
    j_add_proposals(jents, pkl, crowd_thresh=0.7)
    add_proposals_to_roidb(ents, pkl, crowd_thresh=0.7)
    for a, b in zip(jents, ents):
        np.testing.assert_array_equal(b["proposal_boxes"], a["proposal_boxes"])
    ref = jrm.RCNNMinibatchBuilder(jc, max_proposals=24).build(jents, seed=3)
    builder = trm.RCNNMinibatchBuilder(tc, max_proposals=24)
    got = builder.build(ents, seed=3)
    assert "rpn_labels" not in got and got["proposal_boxes"].shape == (3, 24, 4)
    same(ref, got, exact=False)
    assert got["proposal_valid"].sum() > 30
    part = builder.build(ents, seed=3, rows=(1, 3))
    for k in ("proposal_boxes", "proposal_valid", "gt_boxes", "gt_classes", "data"):
        np.testing.assert_array_equal(part[k], got[k][1:3])


def test_both_loaders_carry_the_proposals(split):
    """The thread loader and the process loader (whose workers send batches
    back through spool files) feed the same Fast R-CNN batches, with the
    roidb's proposals (flipped entries' flipped) at max_proposals."""
    from sad_tpu_torch.data.dataset import combined_roidb_for_training
    from sad_tpu_torch.data.loader import TrainingLoader
    from sad_tpu_torch.data.mp_loader import MultiprocessTrainingLoader

    cfg = t_merge(tcfg.Config(), dict(FAST, TRAIN=dict(TRAIN_TINY["TRAIN"], SCALES=(64,),
                                                       MAX_SIZE=96, IMS_PER_BATCH=2)))
    roidb = combined_roidb_for_training([FAST_TRAIN], True)
    add_proposals_to_roidb(roidb, split[FAST_TRAIN])
    got = {}
    for kind, cls, extra in (("threads", TrainingLoader, {"num_threads": 2}),
                             ("mp", MultiprocessTrainingLoader, {"num_workers": 2})):
        loader = cls(cfg, roidb, None, None, builder=trm.RCNNMinibatchBuilder(cfg), **extra)
        with loader:
            got[kind] = [loader.get_next_batch(timeout=60.0) for _ in range(3)]
    for a, b in zip(got["threads"], got["mp"]):
        assert "rpn_labels" not in a and a["proposal_boxes"].shape == (2, 2000, 4)
        assert 0 < int(a["proposal_valid"].sum()) <= 48
        for k in ("proposal_boxes", "proposal_valid", "gt_boxes", "data"):
            np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]), err_msg=k)


def test_fast_rcnn_step_over_two_ranks_matches_one_process():
    """The step on W = 2 gloo ranks, each taking its rows of the sampler's
    global draws at the proposals' P, against one process from the same
    seeded state and batch (profile_train.seeded_rcnn_train_step); the one
    process is this one (profile_ddp.run_compare spawns a world of 1)."""
    kw = dict(cfg_yaml=os.path.join(CONFIGS, "fast_rcnn_R-50-FPN.yaml"), seed=0, n_groups=G,
              device="cpu", opts=RCNN_OPTS)
    build = profile_train.seeded_rcnn_train_step
    one = profile_ddp.rank_steps(build, kw, STEPS, LR)
    ranks = spawn(profile_ddp.rank_steps, W, (build, kw, STEPS, LR, 0), device="cpu",
                  backend="gloo", local_ranks=[0] * W, timeout_s=TIMEOUT_S, threads=1)
    res = {"one": one, "ranks": ranks, **profile_ddp.compare(one, ranks)}
    assert [r["n_images"] for r in res["ranks"]] == [4, 4]
    _check_against_one(res, 1e-4)
    m = res["one"]["metrics"][0]
    assert not any(k.startswith("loss_rpn") for k in m) and m["accuracy_cls"] > 0
    assert not res["unequal_across_ranks"] and not res["generator_unequal"]
    assert len(res["one"]["generator"]) == STEPS


def test_train_net_on_proposal_files(split, tmp_path):
    over = dict(FAST, MODEL=dict(FAST["MODEL"], NUM_CLASSES=9),
                TRAIN=dict(TRAIN_TINY["TRAIN"], DATASETS=(FAST_TRAIN,),
                                 PROPOSAL_FILES=(split[FAST_TRAIN],), SCALES=(64,),
                                 MAX_SIZE=96, IMS_PER_BATCH=2, USE_FLIPPED=True),
                NUM_GPUS=1, SOLVER={"BASE_LR": 1e-3, "MAX_ITER": 2})
    out = str(tmp_path / "out")
    result = train_net.main(["--cfg", _yaml(tmp_path / "cfg.yaml", over), "--skip-test",
                             "--device", "cpu", "OUTPUT_DIR", out])
    assert result.max_iter == 2
    run_dir = os.path.join(out, "train", FAST_TRAIN)
    assert os.path.exists(os.path.join(run_dir, "model_final.pkl"))
    stats = [json.loads(line) for line in open(os.path.join(run_dir, "stats.jsonl"))]
    assert stats and all(np.isfinite(s["loss"]) for s in stats)
    assert not any(k.startswith("loss_rpn") for k in stats[-1])
