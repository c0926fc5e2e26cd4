"""The port's R-CNN modules against sad_tpu's Flax ones on converted float32
weights and the same numpy inputs, at CHANNEL_RATIO 0.0625 (the tiny config
of tests/test_rcnn.py): each head alone, the conversion of Dense and
ConvTranspose leaves, and the whole GeneralizedRCNN forward. Head outputs
agree within 1e-4 * max|ref| + 1e-5 (the two frameworks sum float32
products in other orders); proposals agree exactly in valid and level and
within 1e-3 px in the boxes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sad_tpu.config as jcfg
import sad_tpu_torch.config as tcfg
from sad_tpu.config.config import merge_cfg_from_dict as j_merge
from sad_tpu.models import create_model as j_create_model
from sad_tpu.models import rcnn as jrcnn
from sad_tpu_torch.config.config import merge_cfg_from_dict as t_merge
from sad_tpu_torch.convert import load_params, params_to_state_dict, state_dict_to_params
from sad_tpu_torch.models import GeneralizedRCNN, create_model
from sad_tpu_torch.models import rcnn as trcnn
from test_torch_models import one_torch_thread  # noqa: F401  (autouse)

TINY = {
    "MODEL": {"TYPE": "generalized_rcnn", "CONV_BODY": "FPN.add_fpn_ResNet50_conv5_body",
              "NUM_CLASSES": 5, "FASTER_RCNN": True},
    "RESNETS": {"CHANNEL_RATIO": 0.0625},
    "FPN": {"FPN_ON": True, "MULTILEVEL_RPN": True, "MULTILEVEL_ROIS": True,
            "COARSEST_STRIDE": 64},
    "FAST_RCNN": {"MLP_HEAD_DIM": 32, "ROI_XFORM_RESOLUTION": 7},
    "MRCNN": {"DIM_REDUCED": 16, "RESOLUTION": 28, "ROI_XFORM_RESOLUTION": 14},
    "TEST": {"RPN_PRE_NMS_TOP_N": 50, "RPN_POST_NMS_TOP_N": 20, "RPN_NMS_THRESH": 0.7,
             "SCALES": (64,), "MAX_SIZE": 96, "NMS": 0.5},
    "PIXEL_STD": (57.375, 57.12, 58.395),
    "COMPUTE_DTYPE": "float32",
}


def cfg_pair(**model):
    over = dict(TINY, MODEL=dict(TINY["MODEL"], **model))
    return j_merge(jcfg.Config(), over), t_merge(tcfg.Config(), over)


def random_tree(shapes, seed):
    """Float32 numpy leaves for a Flax shape tree: fan-in scaled kernels,
    AffineChannel scales away from 1, non-zero biases; the class scores are
    scaled so that they spread out. The objectness logits are not: scaled
    4x they saturate float32 sigmoid at exactly 1.0, and equal scores make
    top-k and the greedy NMS order depend on the framework."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name, mod = path[-1].key, path[-2].key
        if name == "kernel":
            out = rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
            if mod.startswith("cls_score"):
                out *= 4.0
        elif name == "s":
            out = rng.uniform(0.5, 1.5, s.shape)
        else:
            out = rng.normal(0.0, 0.1, s.shape)
        return out.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def rcnn_params(jmodel, seed, hw=(64, 96)):
    images = jnp.zeros((1, *hw, 3), jnp.float32)
    im_hw = jnp.asarray([hw], jnp.float32)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), images, im_hw, method="init_all"))["params"]
    return random_tree(shapes, seed)


def _close(ref, got, rel=1e-4, abs_=1e-5):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape
    tol = rel * np.abs(ref).max() + abs_
    err = np.abs(ref - got).max()
    assert err <= tol, (err, tol)


def test_rpn_head_matches():
    rng = np.random.RandomState(0)
    feats = {l: rng.randn(2, 32 >> (l - 2), 48 >> (l - 2), 16).astype(np.float32)
             for l in (2, 3, 4)}
    jhead = jrcnn.RPNHead(16, 3, dtype=jnp.float32)
    jfeats = {l: jnp.asarray(f) for l, f in feats.items()}
    params = random_tree(jax.eval_shape(jhead.init, jax.random.PRNGKey(0), jfeats)["params"], 1)
    ref = jhead.apply({"params": params}, jfeats)
    head = load_params(trcnn.RPNHead(16, 3, 2), params)
    with torch.no_grad():
        got = head({l: torch.from_numpy(f).permute(0, 3, 1, 2) for l, f in feats.items()})
    for l in feats:
        assert tuple(got[0][l].shape) == feats[l].shape[:3] + (3,)
        _close(ref[0][l], got[0][l].numpy())
        _close(ref[1][l], got[1][l].numpy())


@pytest.mark.parametrize("cls_agnostic", [False, True])
def test_box_head_matches_and_flattens_yxc(cls_agnostic):
    """fc6 sees the (R, res, res, C) roi features flattened (y, x, c), the
    order of the converted Dense kernel's rows."""
    x = np.random.RandomState(2).randn(6, 7, 7, 16).astype(np.float32)
    jhead = jrcnn.FastRCNNBoxHead(32, 5, cls_agnostic, dtype=jnp.float32)
    params = random_tree(jax.eval_shape(jhead.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"], 3)
    ref = jhead.apply({"params": params}, jnp.asarray(x))
    head = load_params(trcnn.FastRCNNBoxHead(7 * 7 * 16, 32, 5, cls_agnostic), params)
    assert tuple(head.fc6.weight.shape) == (32, 784)
    assert tuple(head.bbox_pred.weight.shape) == ((8 if cls_agnostic else 20), 32)
    with torch.no_grad():
        got = head(torch.from_numpy(x))
    _close(ref[0], got[0].numpy())
    _close(ref[1], got[1].numpy())


@pytest.mark.parametrize("kwargs", [
    dict(num_convs=4), dict(num_convs=2, cls_specific=False), dict(num_convs=0),
    dict(num_convs=4, use_fc_output=True),
], ids=["v1up4convs", "v1up2convs_agnostic", "v1up", "fc_output"])
def test_mask_head_matches(kwargs):
    x = np.random.RandomState(4).randn(3, 14, 14, 16).astype(np.float32)
    jhead = jrcnn.MaskHead(8, 5, resolution=28, dtype=jnp.float32, **kwargs)
    params = random_tree(jax.eval_shape(jhead.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"], 5)
    ref = jhead.apply({"params": params}, jnp.asarray(x))
    t_kwargs = dict(kwargs)
    head = load_params(trcnn.MaskHead(
        16, 8, 5, t_kwargs.pop("cls_specific", True), resolution=28, roi_resolution=14,
        **t_kwargs), params)
    with torch.no_grad():
        got = head(torch.from_numpy(x))
    assert tuple(got.shape) == (3, 28, 28, 5 if kwargs.get("cls_specific", True) else 1)
    assert got.dtype == torch.float32 and got.is_contiguous()
    _close(ref, got.numpy())


def test_conv_transpose_conversion_flips_the_kernel():
    """conv5_mask alone: Flax's ConvTranspose (2x2, stride 2, SAME) against
    nn.ConvTranspose2d with the converted weight; without the spatial flip
    the outputs differ."""
    import flax.linen as nn

    rng = np.random.RandomState(6)
    x = rng.randn(2, 5, 6, 3).astype(np.float32)
    kernel = rng.randn(2, 2, 3, 4).astype(np.float32)
    bias = rng.randn(4).astype(np.float32)
    ref = nn.ConvTranspose(4, (2, 2), strides=(2, 2)).apply(
        {"params": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}}, jnp.asarray(x))
    sd = params_to_state_dict({"conv5_mask": {"kernel": kernel, "bias": bias}})
    assert tuple(sd["conv5_mask.weight"].shape) == (3, 4, 2, 2)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = torch.nn.functional.conv_transpose2d(xt, sd["conv5_mask.weight"], sd["conv5_mask.bias"],
                                               stride=2).permute(0, 2, 3, 1)
    _close(ref, got.numpy(), rel=1e-6, abs_=1e-6)
    unflipped = torch.from_numpy(kernel.transpose(2, 3, 0, 1).copy())
    wrong = torch.nn.functional.conv_transpose2d(xt, unflipped, sd["conv5_mask.bias"], stride=2)
    assert float((wrong.permute(0, 2, 3, 1) - got).abs().max()) > 0.1
    back = state_dict_to_params(sd)["conv5_mask"]
    assert np.array_equal(back["kernel"], kernel) and np.array_equal(back["bias"], bias)


def test_dense_conversion_round_trip_and_bad_ranks():
    rng = np.random.RandomState(7)
    tree = {"box_head": {"fc6": {"kernel": rng.randn(12, 5).astype(np.float32),
                                 "bias": rng.randn(5).astype(np.float32)}}}
    sd = params_to_state_dict(tree)
    assert tuple(sd["box_head.fc6.weight"].shape) == (5, 12)
    np.testing.assert_array_equal(sd["box_head.fc6.weight"].numpy(), tree["box_head"]["fc6"]["kernel"].T)
    back = state_dict_to_params(sd)
    np.testing.assert_array_equal(back["box_head"]["fc6"]["kernel"], tree["box_head"]["fc6"]["kernel"])
    with pytest.raises(ValueError, match="2-D Dense or a 4-D conv"):
        params_to_state_dict({"m": {"kernel": np.zeros((2, 3, 4), np.float32)}})
    with pytest.raises(ValueError, match="2-D linear or a 4-D conv"):
        state_dict_to_params({"m.weight": torch.zeros(2, 3, 4)})


@pytest.fixture(scope="module", params=["faster", "mask"])
def forward_pair(request):
    jc, tc = cfg_pair(MASK_ON=request.param == "mask")
    jmodel = j_create_model(jc)
    params = rcnn_params(jmodel, seed=11)
    port = load_params(GeneralizedRCNN(tc).eval(), params)
    rng = np.random.RandomState(12)
    images = rng.randn(2, 128, 192, 3).astype(np.float32)
    im_hw = np.array([[128, 192], [100, 160]], np.float32)
    # jitted: one compile of the forward instead of one eager dispatch a primitive
    ref = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(images), jnp.asarray(im_hw))
    with torch.no_grad():
        got = port(torch.from_numpy(images), torch.from_numpy(im_hw))
    return jc, tc, jmodel, params, port, ref, got


def test_state_dict_round_trips_through_the_flax_tree(forward_pair):
    _, _, _, params, port, _, _ = forward_pair
    back = state_dict_to_params(port.state_dict())
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and np.array_equal(a, b), path


def test_forward_proposals_match(forward_pair):
    *_, ref, got = forward_pair
    valid = got["roi_valid"].numpy()
    np.testing.assert_array_equal(valid, np.asarray(ref["roi_valid"]))
    assert valid.sum() > 20 and tuple(got["rois"].shape) == (2, 20, 4)
    np.testing.assert_allclose(got["roi_scores"].numpy(), np.asarray(ref["roi_scores"]),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["rois"].numpy()[valid], np.asarray(ref["rois"])[valid],
                               rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got["roi_levels"].numpy()[valid],
                                  np.asarray(ref["roi_levels"])[valid])
    assert len(np.unique(got["roi_levels"].numpy()[valid])) >= 2


@pytest.mark.parametrize("key", ["cls_score", "cls_prob", "bbox_pred"])
def test_forward_box_head_outputs_match(forward_pair, key):
    *_, ref, got = forward_pair
    valid = got["roi_valid"].numpy()
    assert got[key].dtype == torch.float32
    _close(np.asarray(ref[key])[valid], got[key].numpy()[valid])
    if key == "cls_prob":
        np.testing.assert_allclose(got[key].numpy().sum(-1), 1.0, rtol=1e-5)


def test_forward_features_are_nhwc_views(forward_pair):
    *_, port, ref, got = forward_pair
    assert sorted(got["features"]) == [2, 3, 4, 5, 6]
    for l, f in got["features"].items():
        assert tuple(f.shape) == tuple(ref["features"][l].shape)
        _close(ref["features"][l], f.numpy())
    assert sorted(port.roi_features(got["features"])) == [2, 3, 4, 5]


def test_mask_heads_method_matches(forward_pair):
    jc, _, jmodel, params, port, _, _ = forward_pair
    if not jc.MODEL.MASK_ON:
        assert not hasattr(port, "mask_head")
        return
    x = np.random.RandomState(13).randn(4, 14, 14, 16).astype(np.float32)
    ref = jmodel.apply({"params": params}, jnp.asarray(x), method="mask_heads")
    with torch.no_grad():
        got = port.mask_heads(torch.from_numpy(x))
    assert tuple(got.shape) == (4, 28, 28, 5)
    _close(ref, got.numpy())


@pytest.mark.parametrize("mask", [False, True], ids=["faster", "mask"])
def test_create_model_keys_shapes_and_init(mask):
    """create_model on the CPU: the state_dict has the Flax tree's keys and
    shapes, and the R-CNN initialisers have their distributions' spread."""
    jc, tc = cfg_pair(MASK_ON=mask)
    tc = t_merge(tc, {"MRCNN": {"CONV_INIT": "MSRAFill"}})
    params = rcnn_params(j_create_model(jc), seed=0)
    want = {k: tuple(v.shape) for k, v in params_to_state_dict(params).items()}
    model = create_model(tc, "cpu", torch.Generator().manual_seed(0))
    assert isinstance(model, GeneralizedRCNN) and not model.training
    sd = model.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    assert all(float(v.abs().max()) == 0 for k, v in sd.items()
               if k.endswith(".bias") and not k.startswith("fpn.body"))
    std = {k: float(v.std()) for k, v in sd.items() if k.endswith(".weight")}
    assert std["box_head.cls_score.weight"] == pytest.approx(0.01, rel=0.3)
    assert std["box_head.bbox_pred.weight"] == pytest.approx(0.001, rel=0.3)
    assert std["box_head.fc6.weight"] == pytest.approx(784 ** -0.5, rel=0.1)  # lecun normal
    assert std["rpn.conv_rpn_fpn2.weight"] == pytest.approx(0.01, rel=0.1)
    if mask:
        # MSRAFill: std sqrt(2 / fan_out), fan_out = out channels x kernel area
        assert std["mask_head._[mask]_fcn1.weight"] == pytest.approx((2 / (16 * 9)) ** 0.5, rel=0.1)
        assert std["mask_head.conv5_mask.weight"] == pytest.approx((2 / (16 * 4)) ** 0.5, rel=0.1)


def test_full_width_state_dict_matches_flax_tree():
    """The two shipped R-CNN configs at full width: keys and shapes of the
    port's state_dict are those of sad_tpu's parameter tree."""
    from pathlib import Path

    cfg_dir = Path(__file__).resolve().parent.parent / "sad_tpu_torch" / "configs"
    for name in ("e2e_faster_rcnn_R-50-FPN.yaml", "e2e_mask_rcnn_R-50-FPN.yaml"):
        jc, tc = jcfg.load_cfg(str(cfg_dir / name)), tcfg.load_cfg(str(cfg_dir / name))
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        params = rcnn_params(j_create_model(jc), seed=0, hw=(64, 64))
        want = {k: tuple(v.shape) for k, v in params_to_state_dict(params).items()}
        with torch.device("meta"):
            port = GeneralizedRCNN(tc)
        got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
        assert got == want
        assert got["box_head.fc6.weight"] == (1024, 12544)
        assert ("mask_head.conv5_mask.weight" in got) == ("mask" in name)


@pytest.mark.parametrize("over,match", [
    ({"MODEL": {"KEYPOINTS_ON": True},
      "KRCNN": {"ROI_KEYPOINTS_HEAD": "keypoint_rcnn_heads.add_roi_pose_head_v0"}}, "keypoint"),
    # a single-scale model builds (tests/test_torch_single_scale.py); with
    # keypoints it is refused: SingleScaleRCNN has no keypoint head
    ({"FPN": {"FPN_ON": False}, "MODEL": {"KEYPOINTS_ON": True}}, "single-scale"),
    ({"FAST_RCNN": {"ROI_BOX_HEAD": "fast_rcnn_heads.add_roi_Xconv1fc_gn_head"}}, "box head"),
    ({"FAST_RCNN": {"ROI_XFORM_METHOD": "RoIPoolF"}}, "RoIAlign"),
    ({"MODEL": {"MASK_ON": True}, "MRCNN": {"ROI_MASK_HEAD": "mask_rcnn_heads.mask_rcnn_fcn_head_v0upshare"}},
     "mask head"),
])
def test_unported_models_raise(over, match):
    merged = {k: dict(TINY.get(k, {}), **v) if isinstance(v, dict) else v for k, v in over.items()}
    tc = t_merge(t_merge(tcfg.Config(), TINY), merged)
    with pytest.raises(NotImplementedError, match=match):
        create_model(tc, "cpu")


@pytest.mark.parametrize("mtype", ["rpn", "fpn_rpn"])
def test_rpn_only_model_is_sad_tpus_tree(mtype):
    """MODEL.TYPE 'rpn' (and sad_tpu's old spelling 'fpn_rpn') builds the
    GeneralizedRCNN tree sad_tpu builds for it, leaf for leaf."""
    jc, tc = cfg_pair(TYPE=mtype, RPN_ONLY=True)
    params = rcnn_params(j_create_model(jc), seed=0)
    want = {k: tuple(v.shape) for k, v in params_to_state_dict(params).items()}
    port = create_model(tc, "cpu", torch.Generator().manual_seed(0))
    assert isinstance(port, GeneralizedRCNN)
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == want


def test_keypoint_head_raises():
    """The keypoint head builds at full width (the v1convX tower of
    e2e_keypoint_rcnn_R-50-FPN.yaml: 8 convs at 512, the deconv, heatmaps of
    56) and without the upsample; what stays unported raises."""
    from sad_tpu_torch.models.rcnn import KeypointHead

    with torch.device("meta"):
        head = KeypointHead(256, 512, 17)
    assert head.convs == [f"conv_fcn{i}" for i in range(1, 9)] and head.upsamples == 1
    assert tuple(head.conv_fcn1.weight.shape) == (512, 256, 3, 3)
    assert tuple(head.kps_score_lowres.weight.shape) == (512, 17, 4, 4)
    with torch.no_grad():  # the same structure narrow: 14x14 rois give 56x56 heatmaps
        out = KeypointHead(4, 4, 17, num_convs=1)(torch.zeros(2, 14, 14, 4))
    assert tuple(out.shape) == (2, 56, 56, 17)
    assert KeypointHead(16, 8, 17, 2, up_scale=2, use_deconv_output=False).upsamples == 0
    over = {"MODEL": dict(TINY["MODEL"], KEYPOINTS_ON=True),
            "KRCNN": {"ROI_XFORM_METHOD": "RoIPoolF"}}
    with pytest.raises(NotImplementedError, match="RoIAlign"):
        create_model(t_merge(t_merge(tcfg.Config(), TINY), over), "cpu")
