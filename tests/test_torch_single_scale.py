"""The port's single-scale R-CNN family against sad_tpu's on the CPU at f32:
the VGG bodies, the C4 / VGG / R-FCN models (tests/test_single_scale.py's
tiny settings: CHANNEL_RATIO 0.0625, 64x64 inputs, NUM_CLASSES 4), the
one-level RoIAlign, PSRoIPool, the OHEM trio, the RPN anchor grid and labels,
weight conversion, the training masks, the initialisers and the refusals.

sad_tpu's functions run jitted, as its serving and training paths run them:
XLA then compiles PSRoIPool's bin size roi / k as roi * float32(1 / k) and a
bin edge p * bin + start as one fused multiply-add, and the port does the
same (op by op, un-jitted, sad_tpu divides and rounds twice and lands on
other cells where an edge falls on an integer).

Tolerances: every forward output within 1e-5 * max|ref| (the two frameworks
sum float32 products in other orders); roi_valid, RPN anchors and labels,
PSRoIPool and the OHEM keep masks exactly equal; PSRoIPool's map gradient
within 1e-6 * max.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sad_tpu.config as jcfg
import sad_tpu_torch.config as tcfg
from sad_tpu.config.config import merge_cfg_from_dict as j_merge
from sad_tpu.data import rpn_minibatch as jrm
from sad_tpu.models import bias_mask as j_bias_mask
from sad_tpu.models import create_model as j_create_model
from sad_tpu.models import trainable_mask as j_trainable_mask
from sad_tpu.models.vgg import VGG16Body as JVGG16, VGGCNNM1024Body as JVGGM
from sad_tpu.ops import detectron_ops as jops
from sad_tpu_torch.config.config import merge_cfg_from_dict as t_merge
from sad_tpu_torch.convert import load_params, params_to_state_dict, state_dict_to_params
from sad_tpu_torch.data import rpn_minibatch as trm
from sad_tpu_torch.models import SingleScaleRCNN, bias_mask, create_model, trainable_mask
from sad_tpu_torch.models.vgg import VGG16Body, VGGCNNM1024Body
from sad_tpu_torch.ops import detectron_ops as tops
from test_torch_models import one_torch_thread, random_params, sad_tpu_native_loaded  # noqa: F401
from test_torch_rcnn import rcnn_params

C4_BODY = "ResNet.add_ResNet50_conv4_body"
VGGM_BODY = "VGG_CNN_M_1024.add_VGG_CNN_M_1024_conv5_body"
VGG16_BODY = "VGG16.add_VGG16_conv5_body"
RES5 = "ResNet.add_ResNet_roi_conv5_head"
V0UPSHARE = "mask_rcnn_heads.mask_rcnn_fcn_head_v0upshare"
V0UP = "mask_rcnn_heads.mask_rcnn_fcn_head_v0up"


def ss_over(mtype="generalized_rcnn", body=C4_BODY, head=RES5, mask_head=None, **top):
    """tests/test_single_scale.py's settings: anchors 32 / 64 x 3 ratios at
    stride 16, 30 -> 8 test proposals; the res5 head at res 14, the fc head
    at 3."""
    over = {
        "MODEL": {"TYPE": mtype, "CONV_BODY": body, "NUM_CLASSES": 4, "FASTER_RCNN": True,
                  "MASK_ON": mask_head is not None, "CLS_AGNOSTIC_BBOX_REG": mtype == "rfcn"},
        "RESNETS": {"CHANNEL_RATIO": 0.0625},
        "RPN": {"SIZES": (32, 64), "STRIDE": 16, "ASPECT_RATIOS": (0.5, 1.0, 2.0)},
        "FAST_RCNN": {"ROI_BOX_HEAD": head, "ROI_XFORM_RESOLUTION": 14 if "ResNet" in head else 3},
        "MRCNN": {"ROI_MASK_HEAD": mask_head or "", "ROI_XFORM_RESOLUTION": 14,
                  "RESOLUTION": 14, "DIM_REDUCED": 16},
        "TRAIN": {"SCALES": (64,), "MAX_SIZE": 64, "RPN_PRE_NMS_TOP_N": 30,
                  "RPN_POST_NMS_TOP_N": 16, "BATCH_SIZE_PER_IM": 8, "IMS_PER_BATCH": 1},
        "TEST": {"RPN_PRE_NMS_TOP_N": 30, "RPN_POST_NMS_TOP_N": 8, "SCALES": (64,),
                 "MAX_SIZE": 64},
        "FPN": {"COARSEST_STRIDE": 64},
        "PIXEL_STD": (57.375, 57.12, 58.395),
        "COMPUTE_DTYPE": "float32",
    }
    for k, v in top.items():
        over[k] = dict(over.get(k, {}), **v) if isinstance(v, dict) else v
    return over


def cfg_pair(**kw):
    over = ss_over(**kw)
    return j_merge(jcfg.Config(), over), t_merge(tcfg.Config(), over)


MODELS = {
    "c4_mask_v0upshare": dict(mask_head=V0UPSHARE),
    "c4_mask_v0up": dict(mask_head=V0UP),
    "vgg16": dict(body=VGG16_BODY, head="VGG16.add_VGG16_roi_fc_head"),
    "vgg_cnn_m": dict(body=VGGM_BODY, head="fast_rcnn_heads.add_roi_2mlp_head"),
    "rfcn": dict(mtype="rfcn", head="fast_rcnn_heads.add_roi_2mlp_head"),
}


@pytest.fixture(scope="module", params=sorted(MODELS))
def family(request):
    """(name, jc, tc, sad_tpu model, params, the port's model with them)."""
    jc, tc = cfg_pair(**MODELS[request.param])
    jmodel = j_create_model(jc)
    params = rcnn_params(jmodel, seed=3, hw=(64, 64))
    port = load_params(SingleScaleRCNN(tc).eval(), params)
    return request.param, jc, tc, jmodel, params, port


def _close(ref, got, rel=1e-5):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    assert ref.shape == got.shape
    err = np.abs(ref - got).max() if ref.size else 0.0
    assert err <= rel * max(np.abs(ref).max(), 1e-30), (err, np.abs(ref).max())


@pytest.mark.parametrize("body", ["vgg16", "vgg_cnn_m"])
def test_vgg_bodies_match_sad_tpu(body):
    """conv5 of both VGG bodies (full widths; stride 16) on 64x80 inputs."""
    x = np.random.RandomState(0).randn(2, 64, 80, 3).astype(np.float32)
    jbody, tbody = (JVGG16(), VGG16Body()) if body == "vgg16" else (JVGGM(), VGGCNNM1024Body())
    params = random_params(jbody, x, seed=1)
    ref = np.asarray(jbody.apply({"params": params}, jnp.asarray(x)))
    sd = params_to_state_dict(params)
    tbody.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tbody(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (2, 4, 5, tbody.dim_out)
    _close(ref, got)


def test_forward_matches_sad_tpu(family):
    """The serving forward: proposals, their validity, class probabilities
    and box deltas; the RPN's NMS through the plain twin."""
    _, _, _, jmodel, params, port = family
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    hw = np.float32([[64, 64], [60, 50]])
    ref = jax.jit(lambda p, a, b: jmodel.apply({"params": p}, a, b))(
        params, jnp.asarray(x), jnp.asarray(hw))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(hw))
    np.testing.assert_array_equal(got["roi_valid"].numpy(), np.asarray(ref["roi_valid"]))
    for k in ("rois", "roi_scores", "cls_prob", "bbox_pred"):
        _close(ref[k], got[k].numpy())
    _close(ref["features"], got["features"][4].numpy())


def test_state_dict_is_sad_tpus_tree_and_round_trips(family):
    """Every parameter name of the Flax tree (body, rpn, res5_head,
    mask_res5, mask_out, rfcn, fc6 / fc7, cls_score, bbox_pred) maps onto the
    port's state_dict with its shape, and back bit for bit."""
    name, _, tc, _, params, port = family
    want = {k: tuple(v.shape) for k, v in params_to_state_dict(params).items()}
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == want
    tops_ = {k.split(".")[0] for k in got}
    expect = {"body", "rpn"} | {
        "c4_mask_v0upshare": {"res5_head", "cls_score", "bbox_pred", "mask_out"},
        "c4_mask_v0up": {"res5_head", "mask_res5", "cls_score", "bbox_pred", "mask_out"},
        "vgg16": {"fc6", "fc7", "cls_score", "bbox_pred"},
        "vgg_cnn_m": {"fc6", "fc7", "cls_score", "bbox_pred"},
        "rfcn": {"rfcn"}}[name]
    assert tops_ == expect
    back = state_dict_to_params(port.state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], np.asarray(leaf))


def _tree_items(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _tree_items(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def test_trainable_and_bias_masks_match_sad_tpu(family):
    """Name by name through convert.py's map; the 'conv1' prefix freezes
    VGG16's conv1_1 / conv1_2 and VGG_CNN_M's conv1, not conv2_*."""
    name, _, _, _, params, port = family
    for freeze_at, freeze_body in ((2, False), (0, False), (4, False), (2, True)):
        ref = dict(_tree_items(j_trainable_mask(params, freeze_at, freeze_body)))
        got = trainable_mask(port, freeze_at, freeze_body)
        back = {k.replace(".", "/").replace("/weight", "/kernel"): v for k, v in got.items()}
        assert back == {k: bool(v) for k, v in ref.items()}
    ref = dict(_tree_items(j_bias_mask(params)))
    back = {k.replace(".", "/").replace("/weight", "/kernel"): v
            for k, v in bias_mask(port).items()}
    assert back == {k: bool(v) for k, v in ref.items()}
    mask = trainable_mask(port, 2)
    if name == "vgg16":
        assert not mask["body.conv1_1.weight"] and not mask["body.conv1_2.bias"]
        assert mask["body.conv2_1.weight"]
    if name == "vgg_cnn_m":
        assert not mask["body.conv1.weight"] and mask["body.conv2.weight"]


@pytest.mark.parametrize("conv_init", ["GaussianFill", "MSRAFill"])
def test_initialisers_follow_sad_tpus_distributions(conv_init):
    """create_model's seeded init by role: he-normal body and res5 convs
    (branch2c at 0.01 of it), N(0, 0.01) RPN convs and cls_score, N(0,
    0.001) bbox_pred, MRCNN.CONV_INIT on conv5_mask and the class-specific
    logits, zero biases, AffineChannel s = 1, b = 0; R-FCN's convs N(0, 0.01),
    VGG's fc6 lecun-normal."""
    _, tc = cfg_pair(mask_head=V0UP, MRCNN={"CONV_INIT": conv_init})
    torch.manual_seed(0)
    m = create_model(tc, "cpu", torch.Generator().manual_seed(0))
    sd = m.state_dict()

    def std(k):
        return float(sd[k].std())

    w = sd["res5_head.Bottleneck_0.res5_0_branch2a.weight"]
    he = np.sqrt(2.0 / w[0].numel())
    assert 0.7 * he < float(w.std()) < 1.1 * he  # truncated normal: 0.88 of the scale
    c = sd["res5_head.Bottleneck_0.res5_0_branch2c.weight"]
    assert float(c.std()) < 0.2 * np.sqrt(2.0 / c[0].numel())
    assert 0.008 < std("rpn.conv_rpn.weight") < 0.012
    assert 0.006 < std("cls_score.weight") < 0.014
    assert 0.0006 < std("bbox_pred.weight") < 0.0014
    dm = sd["mask_out.conv5_mask.weight"]  # (in, out, 2, 2)
    want = 0.001 if conv_init == "GaussianFill" else np.sqrt(2.0 / (dm.shape[1] * 4))
    assert 0.8 * want < float(dm.std()) < 1.2 * want
    assert all(float(v.abs().max()) == 0 for k, v in sd.items() if k.endswith(".bias"))
    assert all(bool((v == 1).all()) for k, v in sd.items() if k.endswith("_bn.s"))
    _, tc = cfg_pair(**MODELS["rfcn"])
    sd = create_model(tc, "cpu", torch.Generator().manual_seed(1)).state_dict()
    assert 0.008 < float(sd["rfcn.rfcn_cls.weight"].std()) < 0.012
    _, tc = cfg_pair(**MODELS["vgg16"])
    sd = create_model(tc, "cpu", torch.Generator().manual_seed(2)).state_dict()
    fc6 = sd["fc6.weight"]
    assert 0.75 / np.sqrt(fc6.shape[1]) < float(fc6.std()) < 1.1 / np.sqrt(fc6.shape[1])


def _edge_rois(rng, b, h, w, n):
    """Rois of a (b, h, w) map at stride 16: random ones and the edges (out
    of the map, zero area, the last row and column, inverted, huge)."""
    ch, cw = 16 * h, 16 * w
    xy = rng.uniform(-20, [cw, ch], (n, 2))
    wh = rng.uniform(0, [cw, ch], (n, 2))
    boxes = np.concatenate([xy, xy + wh], axis=1)
    special = [[-300, -200, -250, -150], [2 * cw, 2 * ch, 2.5 * cw, 2.2 * ch], [10, 10, 10, 10],
               [cw - 16, ch - 16, cw - 1, ch - 1], [cw - 1, ch - 1, cw - 1, ch - 1],
               [0, 0, cw - 1, ch - 1], [30, 40, 20, 10], [-50, -50, cw + 50, ch + 50],
               [cw / 2, 0, cw / 2 + 0.5, ch - 1], [0.5, 15.5, 31.5, 47.5]]
    boxes[:len(special)] = special
    bi = rng.randint(0, b, (n, 1)).astype(np.float32)
    return np.concatenate([bi, boxes], axis=1).astype(np.float32)


@pytest.mark.parametrize("res,sr", [(7, 2), (14, 2), (3, 1)])
def test_one_level_roi_align_matches_detectron_ops(res, sr):
    """ops/detectron_ops.roi_align (the multilevel op at one level, plain
    twin here) against sad_tpu's single-map tent-matmul roi_align on edge
    rois, and its map gradient against jax.grad."""
    rng = np.random.RandomState(res)
    f = rng.randn(2, 5, 7, 6).astype(np.float32)
    rois = _edge_rois(rng, 2, 5, 7, 40)
    align = jax.jit(lambda x, r: jops.roi_align(x, r, 1 / 16, res, sr))
    ref = np.asarray(align(jnp.asarray(f), jnp.asarray(rois)))
    ft = torch.from_numpy(f).requires_grad_(True)
    got = tops.roi_align(ft, torch.from_numpy(rois), 1 / 16, res, sr)
    _close(ref, got.detach().numpy())
    g = rng.randn(*ref.shape).astype(np.float32)
    jg = jax.jit(jax.grad(lambda x: jnp.sum(align(x, jnp.asarray(rois)) * g)))(jnp.asarray(f))
    (tg,) = torch.autograd.grad((got * torch.from_numpy(g)).sum(), ft)
    _close(jg, tg.numpy())


def _rounding_edge_rois(rng, b, h, w, n):
    """Corners on .5 (round half to even), extents that make k-bin edges
    land on integers, zero and negative extents, out of the map."""
    rois = _edge_rois(rng, b, h, w, n)
    half = rng.randint(-2, 16 * max(h, w), (n // 2, 4)) + 0.5
    rois[: n // 2, 1:] = np.sort(half.reshape(-1, 2, 2), axis=1).reshape(-1, 4)[:, [0, 2, 1, 3]]
    k7 = rng.randint(0, 4, (n // 4, 2)) * 16.0
    rois[n // 2: n // 2 + n // 4, 1:3] = k7
    rois[n // 2: n // 2 + n // 4, 3:5] = k7 + 16.0 * 7 * rng.randint(1, 3, (n // 4, 1)) - 1.0
    return rois


@pytest.mark.parametrize("k,c_out,seed", [(7, 4, 0), (7, 8, 1), (3, 5, 2)])
def test_ps_roi_pool_matches_sad_tpu(k, c_out, seed):
    """PSRoIPool's channel layout (ph * k + pw) * C_out + c and rounding on
    .5 corners and integer bin edges: on integer-valued maps (sums exact in
    any order) exactly sad_tpu's, so every bin pools the same cells; on
    random maps within 1e-6 * max, and so is the map gradient."""
    rng = np.random.RandomState(seed)
    rois = _rounding_edge_rois(rng, 2, 6, 9, 120)
    pool = jax.jit(lambda x, r: jops.ps_roi_pool(x, r, 1 / 16, k, c_out))
    ints = rng.randint(-64, 64, (2, 6, 9, k * k * c_out)).astype(np.float32)
    np.testing.assert_array_equal(
        tops.ps_roi_pool(torch.from_numpy(ints), torch.from_numpy(rois), 1 / 16, k,
                         c_out).numpy(),
        np.asarray(pool(jnp.asarray(ints), jnp.asarray(rois))))
    f = rng.randn(2, 6, 9, k * k * c_out).astype(np.float32)
    ref = np.asarray(pool(jnp.asarray(f), jnp.asarray(rois)))
    ft = torch.from_numpy(f).requires_grad_(True)
    got = tops.ps_roi_pool(ft, torch.from_numpy(rois), 1 / 16, k, c_out)
    _close(ref, got.detach().numpy(), 1e-6)
    g = rng.randn(*ref.shape).astype(np.float32)
    jg = jax.jit(jax.grad(lambda x: jnp.sum(pool(x, jnp.asarray(rois)) * g)))(jnp.asarray(f))
    (tg,) = torch.autograd.grad((got * torch.from_numpy(g)).sum(), ft)
    _close(jg, tg.numpy(), 1e-6)


def test_ps_roi_pool_chunks_agree(monkeypatch):
    """A chunk of one roi at a time gives what one chunk of all gives."""
    rng = np.random.RandomState(4)
    f = torch.from_numpy(rng.randn(1, 5, 6, 49 * 3).astype(np.float32))
    rois = torch.from_numpy(_rounding_edge_rois(rng, 1, 5, 6, 20))
    whole = tops.ps_roi_pool(f, rois, 1 / 16, 7, 3)
    monkeypatch.setattr(tops, "_PS_CHUNK_ELEMS", 1)
    assert torch.equal(tops.ps_roi_pool(f, rois, 1 / 16, 7, 3), whole)


def test_ohem_trio_matches_sad_tpu():
    """softmax_with_loss_ohem and smooth_l1_loss_per_roi within 1e-6
    relative, and box_annotator_ohem's keep mask exactly equal, ties and
    ignored labels included."""
    rng = np.random.RandomState(5)
    logits = rng.randn(40, 6).astype(np.float32) * 3
    labels = rng.randint(-1, 6, 40).astype(np.int32)
    l_ref, p_ref = jops.softmax_with_loss_ohem(jnp.asarray(logits), jnp.asarray(labels))
    l_got, p_got = tops.softmax_with_loss_ohem(torch.from_numpy(logits), torch.from_numpy(labels))
    _close(l_ref, l_got.numpy(), 1e-6)
    _close(p_ref, p_got.numpy(), 1e-6)
    args = [rng.randn(40, 8).astype(np.float32) for _ in range(2)] + [
        (rng.rand(40, 8) > 0.5).astype(np.float32), rng.rand(40, 8).astype(np.float32)]
    s_ref = jops.smooth_l1_loss_per_roi(*map(jnp.asarray, args), beta=0.5)
    s_got = tops.smooth_l1_loss_per_roi(*map(torch.from_numpy, args), beta=0.5)
    _close(s_ref, s_got.numpy(), 1e-6)
    cls = np.round(rng.rand(40) * 4).astype(np.float32) / 4  # many ties
    box = np.zeros(40, np.float32)
    for k in (1, 7, 13, 40, 64):
        ref = np.asarray(jops.box_annotator_ohem(jnp.asarray(cls), jnp.asarray(box),
                                                 jnp.asarray(labels), k))
        got = tops.box_annotator_ohem(torch.from_numpy(cls), torch.from_numpy(box),
                                      torch.from_numpy(labels), k).numpy()
        np.testing.assert_array_equal(got, ref)
        assert got.sum() == min(k, 40)


def test_single_scale_rpn_grid_and_labels_match_sad_tpu():
    """rpn_anchor_grid at one level, log2(RPN.STRIDE) = 4: RPN.SIZES x
    RPN.ASPECT_RATIOS size-major, and the RPN labels and targets of a batch,
    bit-equal to sad_tpu's."""
    over = ss_over(RPN={"SIZES": (32, 64, 128, 256, 512)})
    jc, tc = j_merge(jcfg.Config(), over), t_merge(tcfg.Config(), over)
    ref, got = jrm.rpn_anchor_grid(jc, 800, 1344), trm.rpn_anchor_grid(tc, 800, 1344)
    assert got.levels == ref.levels == (4,) and got.field_hw == ref.field_hw == ((50, 84),)
    assert got.num_anchors == ref.num_anchors == 15
    np.testing.assert_array_equal(got.anchors[0], ref.anchors[0])
    rng = np.random.RandomState(0)
    batch_j = {"im_hw": np.float32([[64, 64], [64, 48]])}
    batch_t = dict(batch_j)
    entries = [{"boxes": np.float32([[8, 8, 40, 40], [20, 20, 60, 56]])
                + rng.uniform(-3, 3, (2, 4)).astype(np.float32),
                "gt_classes": np.int32([1, 3]), "is_crowd": np.zeros(2, bool)} for _ in range(2)]
    jrm.add_rpn_blobs_to_batch(jc, batch_j, entries, (64, 64), np.ones(2), seed=4)
    trm.add_rpn_blobs_to_batch(tc, batch_t, entries, (64, 64), np.ones(2), seed=4)
    for key in ("rpn_labels", "rpn_bbox_targets", "rpn_bbox_inside_weights",
                "rpn_bbox_outside_weights"):
        assert sorted(batch_t[key]) == sorted(batch_j[key]) == [4]
        np.testing.assert_array_equal(batch_t[key][4], batch_j[key][4])
    assert (batch_t["rpn_labels"][4] == 1).sum() > 0


@pytest.mark.parametrize("over,match", [
    (dict(mask_head=V0UP, MODEL={"KEYPOINTS_ON": True}), "no keypoint head"),
    (dict(FAST_RCNN={"ROI_XFORM_METHOD": "RoIPoolF"}), "always aligns"),
    (dict(mask_head=V0UP, MRCNN={"ROI_XFORM_METHOD": "RoIPoolF"}), "always aligns"),
    (dict(mtype="rfcn", head="fast_rcnn_heads.add_roi_2mlp_head", mask_head=V0UP),
     "R-FCN with MASK_ON"),
    (dict(mask_head="mask_rcnn_heads.mask_rcnn_fcn_head_v1up4convs"), "builds v0up"),
    (dict(FAST_RCNN={"ROI_XFORM_SAMPLING_RATIO": 0}), "adaptive grid"),
    (dict(mask_head=V0UP, MRCNN={"ROI_XFORM_SAMPLING_RATIO": 0}), "adaptive grid"),
    (dict(body=VGG16_BODY, head="VGG16.add_VGG16_roi_fc_head", mask_head=V0UP), "res5"),
    (dict(head="fast_rcnn_heads.add_roi_Xconv1fc_gn_head"), "C4 box head"),
    (dict(mask_head="mask_rcnn_heads.mask_rcnn_fcn_head_v0"), "C4 mask head"),
])
def test_refusals_name_their_roadmap_note(over, match):
    """Where sad_tpu builds another head than the config names, or ignores
    the option, create_model refuses (ROADMAP.md Queue 3)."""
    _, tc = cfg_pair(**over)
    with pytest.raises(NotImplementedError, match=match) as e:
        create_model(tc, "cpu")
    assert "Queue 3" in str(e.value) or "head" in match


def test_roi_align_refuses_adaptive_sampling_and_other_scales():
    f, rois = torch.zeros(1, 4, 4, 2), torch.zeros(3, 5)
    with pytest.raises(NotImplementedError, match="Queue 3"):
        tops.roi_align(f, rois, 1 / 16, 7, 0)
    with pytest.raises(ValueError, match="not 1 / 2"):
        tops.roi_align(f, rois, 1 / 12, 7, 2)


def test_single_scale_models_are_built_for_every_body():
    """create_model dispatches to SingleScaleRCNN without FPN and for 'rfcn'
    (checked on the cheap C4 and R-FCN trees), with the body, RPN width and
    heads sad_tpu builds (every family, on the meta device)."""
    for name, kw in MODELS.items():
        _, tc = cfg_pair(**kw)
        if name in ("c4_mask_v0up", "rfcn"):
            m = create_model(tc, "cpu", torch.Generator().manual_seed(0))
        else:
            with torch.device("meta"):
                m = SingleScaleRCNN(tc)
        assert isinstance(m, SingleScaleRCNN) and m.level == 4
        assert m.rpn.conv_rpn.out_channels == 512 and m.rpn.rpn_cls_logits.out_channels == 6
        assert m.is_rfcn == (name == "rfcn")
        assert m.mask_share_res5 == (name == "c4_mask_v0upshare")
        assert m.body.dim_out if "vgg" in name else m.arch.block_counts == (3, 4, 6)
    assert dataclasses.is_dataclass(tc)
