"""Keypoint R-CNN in the port against sad_tpu on the CPU, float32, at the tiny
R-CNN size of tests/test_torch_rcnn.py (CHANNEL_RATIO 0.0625) with a
keypoint head of 2 stacked convs at width 16 and 17 keypoints, converted
weights and seeded numpy inputs. sad_tpu's RoIAlign runs its dense form here
(the mode it picks on the CPU) and its NMS the interpreted Pallas kernel.

- KeypointHead within 1e-4 * max|ref| + 1e-5 (the head tolerance of
  tests/test_torch_rcnn.py), both CONV_INIT fillers, UP_SCALE 1 and 2; the
  ConvTranspose kps_score_lowres against Flax's 'SAME' transpose conv at
  1e-6; its leaves converted both ways, and the Caffe2 blob names.
- keypoint_targets_on_device exactly equal; keypoint_loss within 1e-6
  relative (both normalisations, the validity gate, total_groups).
- RCNNMinibatchBuilder keypoint batches equal to sad_tpu's (flipped and not,
  rank shards equal to the whole batch's rows), from both dataset layers.
- The inference function: detections at the whole-slice tolerances of
  tests/test_torch_rcnn_inference.py and kps_heatmaps within 1e-3 * max.
- One training step: metrics within 1e-5 relative, momentum and updates as
  tests/test_torch_rcnn_train.py holds them.
- test_net on a synthetic keypoint split: detections, keypoints within
  1e-3 px and the keypoint stats within 1e-12 where the detections match;
  sad_tpu's decode pinned to its numpy resize (``_cv2`` None).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sad_tpu.config as jcfg
import sad_tpu_torch.config as tcfg
from sad_tpu.config.config import merge_cfg_from_dict as j_merge
from sad_tpu.data import dataset as jdataset
from sad_tpu.data.rpn_minibatch import RCNNMinibatchBuilder as JBuilder
from sad_tpu.eval import test_engine as j_engine
from sad_tpu.eval.rcnn_inference import make_rcnn_inference_fn as j_make_rcnn_inference_fn
from sad_tpu.models import create_model as j_create_model
from sad_tpu.models import rcnn as jrcnn
from sad_tpu.train import checkpoint as jck
from sad_tpu.train import mask_keypoint as jmk
from sad_tpu.train.optimizer import init_momentum_state
from sad_tpu.train.rcnn_train import make_rcnn_train_step as j_make_rcnn_train_step
from sad_tpu.train.train_step import TrainState as JTrainState
from sad_tpu.utils import keypoints as jkp
from sad_tpu_torch.config.config import cfg_to_yaml
from sad_tpu_torch.config.config import merge_cfg_from_dict as t_merge
from sad_tpu_torch.convert import load_params, params_to_state_dict, state_dict_to_params
from sad_tpu_torch.data import dataset as tdataset
from sad_tpu_torch.data.rpn_minibatch import RCNNMinibatchBuilder
from sad_tpu_torch.data.synth_coco import generate_synthetic_coco
from sad_tpu_torch.eval import test_engine
from sad_tpu_torch.eval.rcnn_inference import make_rcnn_inference_fn
from sad_tpu_torch.models import GeneralizedRCNN, create_model
from sad_tpu_torch.models import rcnn as trcnn
from sad_tpu_torch.tools import test_net
from sad_tpu_torch.train import TrainState, batch_to_torch, make_rcnn_train_step
from sad_tpu_torch.train import checkpoint as tck
from sad_tpu_torch.train import mask_keypoint as tmk
from test_torch_inference import _kept, canvases
from test_torch_models import one_torch_thread  # noqa: F401  (autouse)
from test_torch_rcnn import TINY, _close, random_tree, rcnn_params
from test_torch_rcnn_train import HW, LR, _tree_items, jax_uniforms, make_batch
from test_torch_rcnn_train import TINY as TRAIN_TINY

KRCNN = {"CONV_HEAD_DIM": 16, "NUM_STACKED_CONVS": 2, "NUM_KEYPOINTS": 17,
         "USE_DECONV_OUTPUT": True, "UP_SCALE": 2, "ROI_XFORM_RESOLUTION": 14,
         "CONV_INIT": "MSRAFill"}
KPS = dict(TINY, MODEL=dict(TINY["MODEL"], NUM_CLASSES=2, KEYPOINTS_ON=True), KRCNN=KRCNN)
KPS_VAL = "torch_kps_val"


def kps_pair(over=KPS):
    return j_merge(jcfg.Config(), over), t_merge(tcfg.Config(), over)


# ---------------------------------------------------------------- the head


@pytest.mark.parametrize("up_scale", [1, 2])
@pytest.mark.parametrize("conv_init", ["GaussianFill", "MSRAFill"])
def test_keypoint_head_matches(conv_init, up_scale):
    x = np.random.RandomState(1).randn(3, 14, 14, 16).astype(np.float32)
    jhead = jrcnn.KeypointHead(16, 17, num_convs=2, up_scale=up_scale, use_deconv_output=True,
                               conv_init=conv_init, dtype=jnp.float32)
    shapes = jax.eval_shape(jhead.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = random_tree(shapes, 2)
    ref = jhead.apply({"params": params}, jnp.asarray(x))
    head = load_params(trcnn.KeypointHead(16, 16, 17, 2, up_scale, True), params)
    with torch.no_grad():
        got = head(torch.from_numpy(x))
    assert tuple(got.shape) == (3, 28 * up_scale, 28 * up_scale, 17) == ref.shape
    assert got.dtype == torch.float32 and got.is_contiguous()
    _close(ref, got.numpy())


@pytest.mark.parametrize("conv_init", ["GaussianFill", "MSRAFill"])
def test_create_model_keypoint_init(conv_init):
    """create_model's keypoint head: the Flax tree's keys and shapes, zero
    biases and each filler's spread (GaussianFill N(0, 0.01) convs and
    N(0, 0.001) output; MSRAFill std sqrt(2 / fan_out))."""
    over = dict(KPS, KRCNN=dict(KRCNN, CONV_INIT=conv_init, CONV_HEAD_DIM=32))
    jc, tc = kps_pair(over)
    want = {k: tuple(v.shape) for k, v in
            params_to_state_dict(rcnn_params(j_create_model(jc), seed=0)).items()}
    sd = create_model(tc, "cpu", torch.Generator().manual_seed(0)).state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    assert tuple(sd["kps_head.kps_score_lowres.weight"].shape) == (32, 17, 4, 4)
    std = {k: float(v.std()) for k, v in sd.items() if k.startswith("kps_head.")}
    assert all(float(sd[k].abs().max()) == 0 for k in sd if k.startswith("kps_head.")
               and k.endswith(".bias"))
    if conv_init == "GaussianFill":
        assert std["kps_head.conv_fcn2.weight"] == pytest.approx(0.01, rel=0.1)
        assert std["kps_head.kps_score_lowres.weight"] == pytest.approx(0.001, rel=0.1)
    else:
        assert std["kps_head.conv_fcn2.weight"] == pytest.approx((2 / (32 * 9)) ** 0.5, rel=0.1)
        assert std["kps_head.kps_score_lowres.weight"] == pytest.approx((2 / (17 * 16)) ** 0.5,
                                                                         rel=0.1)
    with pytest.raises(ValueError, match="CONV_INIT"):
        create_model(t_merge(tc, {"KRCNN": dict(KRCNN, CONV_INIT="XavierFill")}), "cpu")


def test_kps_score_lowres_conversion_both_ways():
    """kps_score_lowres alone: Flax's ConvTranspose (4x4, stride 2, 'SAME':
    lax pads the dilated input 2 and 2) against nn.ConvTranspose2d with
    padding 1 and the converted, flipped weight, at float32; back to the Flax
    leaf bit for bit; and the Caffe2 blobs of sad_tpu's exporter load into
    the port's head as they are (IOHW, the conv-adjoint)."""
    import flax.linen as nn

    rng = np.random.RandomState(6)
    x = rng.randn(2, 7, 5, 8).astype(np.float32)
    kernel = rng.randn(4, 4, 8, 17).astype(np.float32)
    bias = rng.randn(17).astype(np.float32)
    tree = {"kps_head": {"kps_score_lowres": {"kernel": kernel, "bias": bias}}}
    ref = nn.ConvTranspose(17, (4, 4), strides=(2, 2)).apply(
        {"params": tree["kps_head"]["kps_score_lowres"]}, jnp.asarray(x))
    sd = params_to_state_dict(tree)
    w = sd["kps_head.kps_score_lowres.weight"]
    assert tuple(w.shape) == (8, 17, 4, 4)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = torch.nn.functional.conv_transpose2d(xt, w, sd["kps_head.kps_score_lowres.bias"],
                                               stride=2, padding=1).permute(0, 2, 3, 1)
    assert tuple(got.shape) == (2, 14, 10, 17) == ref.shape
    _close(ref, got.numpy(), rel=1e-6, abs_=1e-6)
    back = state_dict_to_params(sd)["kps_head"]["kps_score_lowres"]
    assert np.array_equal(back["kernel"], kernel) and np.array_equal(back["bias"], bias)

    jc, tc = kps_pair()
    params = rcnn_params(j_create_model(jc), seed=3)
    back = state_dict_to_params(params_to_state_dict(params))  # the whole model's tree
    assert back["kps_head"].keys() == params["kps_head"].keys()
    for m, leaves in params["kps_head"].items():
        for k, v in leaves.items():
            assert np.array_equal(back["kps_head"][m][k], v), (m, k)
    blobs = jck.flax_to_reference_blobs(params, jck.fc_flatten_resolutions(jc))
    assert {"conv_fcn1_w", "conv_fcn2_b", "kps_score_lowres_w"} <= set(blobs)
    port = GeneralizedRCNN(tc)
    assert tck.blob_name("kps_head.kps_score_lowres.weight") == "kps_score_lowres_w"
    loaded, names, skipped = tck.reference_blobs_to_state_dict(
        blobs, port, strict=True, fc_resolutions=tck.fc_flatten_resolutions(tc))
    assert not skipped and len(names) == len(port.state_dict())
    want = params_to_state_dict(params)
    for k in want:
        assert torch.equal(loaded[k], want[k]), k


# ------------------------------------------------------- targets and loss


def _kp_case(seed, b=2, g=3, r=10, k=17, s=56):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 60, (b, g, 2))
    gt = np.concatenate([xy, xy + rng.uniform(4, 50, (b, g, 2))], -1)
    kp = np.zeros((b, g, k, 3), np.float32)
    u = rng.uniform(-0.2, 1.2, (b, g, k, 2))  # some keypoints outside their box
    kp[..., :2] = gt[:, :, None, :2] + u * (gt[:, :, None, 2:] - gt[:, :, None, :2])
    kp[..., 2] = rng.choice([0, 1, 2], (b, g, k), p=[0.2, 0.3, 0.5])
    kp[0, 0, :4, :2] = gt[0, 0, None, :2]  # on the corner: heatmap cell 0
    matched = rng.randint(0, g, (b, r))
    rois = np.take_along_axis(gt, matched[..., None], 1) + rng.uniform(-6, 6, (b, r, 4))
    rois[0, 0, 2] = rois[0, 0, 0] + 0.3  # narrower than a pixel: clamped to 1
    return kp, rois.astype(np.float32), matched.astype(np.int32), s


def test_keypoint_targets_exactly_equal():
    kp, rois, matched, s = _kp_case(0)
    labels, valid = tmk.keypoint_targets_on_device(
        torch.from_numpy(kp), torch.from_numpy(rois), torch.from_numpy(matched), s)
    ref = [jmk.keypoint_targets_on_device(jnp.asarray(kp[i]), jnp.asarray(rois[i]),
                                          jnp.asarray(matched[i]), s) for i in range(2)]
    np.testing.assert_array_equal(labels.numpy(), np.concatenate([np.asarray(a) for a, _ in ref]))
    np.testing.assert_array_equal(valid.numpy(), np.concatenate([np.asarray(v) for _, v in ref]))
    assert 0.2 < valid.float().mean() < 0.9 and labels.dtype == torch.int64
    assert int(labels.min()) == 0 and int(labels.max()) <= s * s - 1


@pytest.mark.parametrize("normalize,min_count,world", [
    (True, 0, 1), (False, 0, 1), (True, 40, 1), (False, 40, 2),
], ids=["by_visible", "fixed_denominator", "gate", "fixed_total_groups"])
def test_keypoint_loss_matches(normalize, min_count, world):
    """Two groups of 2 images; ``world`` 2: the port's loss over total_groups = 2 * n_groups is
    sad_tpu's over n_groups, halved (each rank's share). The groups see 35
    and 67 visible keypoints at fg rois; with min_count 40 the first falls
    under the gate."""
    kp, rois, matched, s = _kp_case(1, b=4, r=6)
    over = {"KRCNN": {"NORMALIZE_BY_VISIBLE_KEYPOINTS": normalize,
                      "MIN_KEYPOINT_COUNT_FOR_VALID_MINIBATCH": min_count},
            "TRAIN": {"BATCH_SIZE_PER_IM": 64}}
    jc, tc = j_merge(jcfg.Config(), over), t_merge(tcfg.Config(), over)
    labels, valid = tmk.keypoint_targets_on_device(
        torch.from_numpy(kp), torch.from_numpy(rois), torch.from_numpy(matched), s)
    rng = np.random.RandomState(2)
    logits = (3.0 * rng.randn(24, s, s, 17)).astype(np.float32)
    is_fg = rng.rand(24) > 0.2
    nvis = (valid.numpy() & is_fg[:, None]).reshape(2, -1).sum(1)
    assert (min_count == 0) or (nvis.min() <= min_count < nvis.max()), nvis
    ref = float(jmk.keypoint_loss(jc, jnp.asarray(logits), jnp.asarray(labels.numpy()),
                                  jnp.asarray(valid.numpy()), jnp.asarray(is_fg), 2,
                                  n_images=4)) / world
    got = float(tmk.keypoint_loss(tc, torch.from_numpy(logits), labels, valid,
                                  torch.from_numpy(is_fg), 2, n_images=4, total_groups=2 * world))
    assert ref > 0 and abs(got - ref) <= 1e-6 * abs(ref), (got, ref)
    if not normalize:
        with pytest.raises(ValueError, match="n_images"):
            tmk.keypoint_loss(tc, torch.from_numpy(logits), labels, valid,
                              torch.from_numpy(is_fg), 2)


# ----------------------------------------------------------------- batches


@pytest.fixture(scope="module")
def kps_split(tmp_path_factory):
    """A synthetic keypoint val split of 3 images, 1 category, 5 keypoints
    with a left/right flip map, registered in both catalogs."""
    root = str(tmp_path_factory.mktemp("kps_data"))
    img_dir, js = generate_synthetic_coco(root, "kps", 3, seed=11, n_categories=1,
                                          size_range=(80, 160), objects_per_image=(2, 4),
                                          with_keypoints=True, crowd_frac=0.0)
    jcfg.register_dataset(KPS_VAL, img_dir, js, allow_override=True)
    tcfg.register_dataset(KPS_VAL, img_dir, js, allow_override=True)
    return KPS_VAL


def test_keypoint_batches_match_sad_tpu(kps_split):
    """Both dataset layers (keypoints kept, flipped with the name-derived
    channel swap) and both builders on the same entries, flipped and not:
    every array equal; the rank shards (``rows``) are the whole batch's rows."""
    over = dict(KPS, TRAIN={"SCALES": (64, 80), "MAX_SIZE": 128, "IMS_PER_BATCH": 2})
    jc, tc = kps_pair(over)
    jroidb = jdataset.combined_roidb_for_training([kps_split], require_keypoints=True)
    troidb = tdataset.combined_roidb_for_training([kps_split], require_keypoints=True)
    assert len(troidb) == len(jroidb) == 6 and [e["flipped"] for e in troidb] == [False] * 3 + [True] * 3
    for a, b in zip(jroidb, troidb):
        np.testing.assert_array_equal(b["gt_keypoints"], a["gt_keypoints"])
        np.testing.assert_array_equal(b.get("kp_flip_idx"), a.get("kp_flip_idx"))
    assert tdataset.CocoDataset(kps_split).keypoints[1:3] == ["left_tip", "right_tip"]
    for entries in (troidb[:2], troidb[3:5]):
        ref = JBuilder(jc).build([dict(e) for e in entries], seed=4)
        got = RCNNMinibatchBuilder(tc).build(entries, seed=4)
        assert got["gt_keypoints"].shape == (2, 50, 17, 3)
        np.testing.assert_array_equal(got["gt_keypoints"], ref["gt_keypoints"])
        np.testing.assert_array_equal(got["gt_boxes"], ref["gt_boxes"])
        assert (got["gt_keypoints"][..., 2] > 0).sum() > 4
        assert not got["gt_keypoints"][:, :, 5:].any()  # 5 keypoints in 17 channels
        half = RCNNMinibatchBuilder(tc).build(entries, seed=4, rows=(1, 2))
        np.testing.assert_array_equal(half["gt_keypoints"], got["gt_keypoints"][1:2])


# --------------------------------------------------------------- inference


def test_inference_kps_heatmaps_match_sad_tpu():
    """Seed 22: with one foreground class, seed 21 (the other R-CNN files')
    scores every roi of these canvases under 3e-4, so nothing would be kept
    and the keypoint head would see only empty slots."""
    jc, tc = kps_pair()
    jmodel = j_create_model(jc)
    params = rcnn_params(jmodel, seed=22)
    port = load_params(GeneralizedRCNN(tc).eval(), params)
    batch = canvases(0, n=2, canvas=(128, 192))
    ref = j_make_rcnn_inference_fn(jc, jmodel)(params, *(jnp.asarray(a) for a in batch))
    got = make_rcnn_inference_fn(tc, port)(*(torch.from_numpy(a) for a in batch))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = {k: v.numpy() for k, v in got.items()}
    assert got["kps_heatmaps"].shape == (2, 100, 56, 56, 17) == ref["kps_heatmaps"].shape
    assert got["kps_heatmaps"].dtype == np.float32
    for j in range(2):
        c1, s1, b1 = _kept(ref, j)
        c2, s2, b2 = _kept(got, j)
        assert len(c1) == len(c2) > 5
        np.testing.assert_allclose(s2, s1, rtol=0, atol=1e-4)
        np.testing.assert_allclose(b2, b1, rtol=0, atol=2e-3)
        # the same detections in the same slots: greedy NMS emits by score
        valid = got["valid"][j]
        np.testing.assert_array_equal(valid, ref["valid"][j])
        hm_r, hm_g = ref["kps_heatmaps"][j][valid], got["kps_heatmaps"][j][valid]
        assert np.abs(hm_g - hm_r).max() <= 1e-3 * np.abs(hm_r).max()
    assert (got["classes"][got["valid"]] == 1).all()


# ----------------------------------------------------------------- training


def _train_cfgs():
    over = dict(TRAIN_TINY, MODEL=dict(TRAIN_TINY["MODEL"], NUM_CLASSES=2, KEYPOINTS_ON=True),
                KRCNN=dict(KRCNN, MIN_KEYPOINT_COUNT_FOR_VALID_MINIBATCH=4))
    return j_merge(jcfg.Config(), over), t_merge(tcfg.Config(), over)


def test_one_keypoint_step_matches_sad_tpu():
    jc, tc = _train_cfgs()
    jmodel = j_create_model(jc)
    params = rcnn_params(jmodel, seed=21, hw=HW)
    batch = make_batch(jc, mask=False)
    batch["gt_classes"] = np.minimum(batch["gt_classes"], 1)
    rng = np.random.RandomState(7)
    g = batch["gt_boxes"]
    u = rng.uniform(0, 1, g.shape[:2] + (17, 2))
    kp = np.zeros(g.shape[:2] + (17, 3), np.float32)
    kp[..., :2] = g[:, :, None, :2] + u * (g[:, :, None, 2:] - g[:, :, None, :2])
    kp[..., 2] = (rng.rand(*g.shape[:2], 17) < 0.8) * 2.0
    batch["gt_keypoints"] = kp
    key = jax.random.PRNGKey(3)
    jstate = JTrainState(params, init_momentum_state(params).velocity)
    jstep = jax.jit(j_make_rcnn_train_step(jc, jmodel, n_groups=2))
    new_state, ref = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batch), jnp.float32(LR), key)

    port = load_params(GeneralizedRCNN(tc), params)
    state = TrainState.create(port)
    step = make_rcnn_train_step(tc, port, n_groups=2)
    assert step.kps_cap() == 2  # BATCH_SIZE_PER_IM 8 x FG_FRACTION 0.25
    p = tc.TRAIN.RPN_POST_NMS_TOP_N + batch["gt_boxes"].shape[1]
    got = step(state, batch_to_torch(batch, "cpu"), LR, uniforms=jax_uniforms(key, 2, p))
    assert sorted(got) == sorted(ref) and "loss_kps" in got and "loss_mask" not in got
    for k in ref:
        r, v = float(ref[k]), float(got[k])
        assert abs(r - v) <= 1e-5 * abs(r) + 1e-7, (k, r, v)
    assert float(got["loss_kps"]) > 0

    old = dict(_tree_items(params))
    new_ref = dict(_tree_items(jax.tree_util.tree_map(np.asarray, new_state.params)))
    vel_ref = dict(_tree_items(jax.tree_util.tree_map(np.asarray, new_state.velocity)))
    new_got = dict(_tree_items(state_dict_to_params(port.state_dict())))
    vel_got = dict(_tree_items(state_dict_to_params(state.velocity)))
    assert sorted(new_got) == sorted(new_ref) and sorted(vel_got) == sorted(vel_ref)
    kps_moved = 0
    for name in old:
        v_r, v_g = vel_ref[name], vel_got[name]
        assert np.abs(v_r - v_g).max() <= 2e-3 * np.abs(v_r).max() + 1e-8, name
        d_r, d_g = new_ref[name] - old[name], new_got[name] - old[name]
        assert np.abs(d_r - d_g).max() <= 2e-3 * np.abs(d_r).max() + 1e-7, name
        kps_moved += name.startswith("kps_head") and bool(np.abs(d_g).max() > 0)
    assert kps_moved == 6  # 2 convs and the deconv, weight and bias


def test_mask_and_keypoint_share_one_prefix():
    """MASK_ON and KEYPOINTS_ON with caps 1 and 2: one fg prefix at the
    larger cap, each branch its slice (what sad_tpu's _branch_slice takes)."""
    _, tc = _train_cfgs()
    tc = t_merge(tc, {"MODEL": {"MASK_ON": True}, "MRCNN": {"ROI_SLOTS_PER_IM": 1,
                                                             "DIM_REDUCED": 8}})
    step = make_rcnn_train_step(tc, GeneralizedRCNN(tc))
    assert (step.mask_cap(), step.kps_cap()) == (1, 2)
    sampled = {k: torch.arange(3 * 8 * n).reshape(3, 8, n).squeeze(-1).float()
               for k, n in (("rois", 4), ("is_fg", 1), ("labels", 1), ("matched_gt", 1))}
    sampled["rois"] = torch.rand(3, 8, 4) * 30 + torch.tensor([0, 0, 20, 20])
    prefix = step.fg_prefix(sampled)
    assert {k: tuple(v.shape[:2]) for k, v in prefix.items()} == dict.fromkeys(prefix, (3, 2))
    assert torch.equal(prefix["rois"], sampled["rois"][:, :2])


# ----------------------------------------------------------------- test_net


def _read(path, name):
    with open(os.path.join(path, name)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def test_net_pair(kps_split, tmp_path_factory):
    """sad_tpu's test_net_on_dataset (its decode on the numpy resize) and the
    port's test_net.main on one native pickle; the heatmap layer scaled 4x
    so that each channel's peak stands out of the float32 noise."""
    tmp = tmp_path_factory.mktemp("kps_test_net")
    over = dict(KPS, TEST=dict(TINY["TEST"], DATASETS=(kps_split,)),
                KRCNN=dict(KRCNN, NMS_OKS=True, KEYPOINT_CONFIDENCE="logit"))
    jc = j_merge(jcfg.Config(), over)
    params = rcnn_params(j_create_model(jc), seed=21)
    lowres = params["kps_head"]["kps_score_lowres"]
    lowres["kernel"] = lowres["kernel"] * 4.0
    pkl = str(tmp / "model.pkl")
    jck.save_checkpoint(pkl, params)
    mp = pytest.MonkeyPatch()
    mp.setattr(jkp, "_cv2", None)
    try:
        ref_dir = str(tmp / "jax")
        j_engine.test_net_on_dataset(jc, j_create_model(jc), params, batch_size=2,
                                     output_dir=ref_dir)
    finally:
        mp.undo()
    cfg_path = str(tmp / "cfg.yaml")
    with open(cfg_path, "w") as f:
        f.write(cfg_to_yaml(t_merge(tcfg.Config(), over)))
    out = str(tmp / "torch")
    test_net.main(["--cfg", cfg_path, "--weights", pkl, "--device", "cpu", "--batch-size", "2",
                   "--vis", "VIS_TH", "0.0", "OUTPUT_DIR", out])
    return ref_dir, os.path.join(out, "test", kps_split)


def test_test_net_keypoints_match_sad_tpu(test_net_pair):
    ref_dir, got_dir = test_net_pair
    ref, got = _read(ref_dir, "bbox_results.json"), _read(got_dir, "bbox_results.json")
    key = lambda d: (d["image_id"], -d["score"])  # noqa: E731
    ref, got = sorted(ref, key=key), sorted(got, key=key)
    assert len(got) == len(ref) > 10 and len({d["image_id"] for d in got}) == 3
    for a, b in zip(ref, got):
        assert (a["image_id"], a["category_id"]) == (b["image_id"], b["category_id"])
        assert abs(a["score"] - b["score"]) <= 1e-4
        np.testing.assert_allclose(b["bbox"], a["bbox"], rtol=0, atol=2e-3)
        kr, kg = np.reshape(a["keypoints"], (17, 3)), np.reshape(b["keypoints"], (17, 3))
        np.testing.assert_allclose(kg[:, :2], kr[:, :2], rtol=0, atol=1e-3)
        assert (kg[:, 2] == 1).all() and abs(a["kps_score"] - b["kps_score"]) <= 1e-3
    rr, rg = _read(ref_dir, "results.json"), _read(got_dir, "results.json")
    kp_keys = [k for k in rr if k.startswith("keypoints_")]
    assert sorted(rg) == sorted(rr) and len(kp_keys) == 10
    for k in rr:
        assert abs(rg[k] - rr[k]) <= (1e-12 if k in kp_keys else 1e-6), (k, rg[k], rr[k])
    timing = _read(got_dir, "timing.json")
    assert timing["kps_decode"] > 0 and timing["eval_keypoints"] > 0
    assert len(os.listdir(os.path.join(got_dir, "vis"))) == 3


def test_kps_aug_transforms_match_sad_tpu():
    """KPS_AUG's transforms, each tagged downscaled / upscaled against
    TEST.SCALES[0] for SCALE_SIZE_DEP (tests/test_torch_tta.py serves them)."""
    from sad_tpu.eval import test_augmentation as jta
    from sad_tpu_torch.eval import test_augmentation as ta

    aug = {"ENABLED": True, "H_FLIP": True, "SCALES": (32, 64, 96), "MAX_SIZE": 160,
           "SCALE_H_FLIP": True, "SCALE_SIZE_DEP": True}
    jc, tc = kps_pair(dict(KPS, TEST=dict(TINY["TEST"], KPS_AUG=aug)))
    got = ta.aux_aug_transforms(tc.TEST.KPS_AUG, tc)
    assert got == jta.aux_aug_transforms(jc.TEST.KPS_AUG, jc) and len(got) == 7
    assert [(t["ds"], t["us"]) for t in got[1:]] == [(True, False)] * 2 + [(False, False)] * 2 + [
        (False, True)] * 2


def test_keypoint_confidence_refused(kps_split):
    _, tc = kps_pair(dict(KPS, TEST=dict(TINY["TEST"], DATASETS=(kps_split,))))
    with pytest.raises(ValueError, match="KEYPOINT_CONFIDENCE"):
        test_engine.run_inference_on_roidb(
            t_merge(tc, {"KRCNN": dict(KRCNN, KEYPOINT_CONFIDENCE="box")}), None, [], {})
