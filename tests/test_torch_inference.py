"""The serving slice as a whole: uint8 canvases with content extents through
sad_tpu's make_inference_fn (its Pallas NMS interpreted on this CPU) and
the port's, on the same converted float32 tiny weights.

Kept detections must be the same (class, score) multiset, scores within
1e-5 and boxes within 1e-3 px. No mismatch is allowed: the inputs are
continuous, and these seeds put no IoU near the threshold. The pieces are
checked element-wise too: image normalisation, content mask, box decode,
the device copies of the cell anchors, and the decode alone on identical
per-level outputs. Each package reads the same settings with its own config module."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import sad_tpu.config as jcfg
from sad_tpu.config.config import merge_cfg_from_dict as j_merge
from sad_tpu.data.anchors import retinanet_cell_anchors as j_cell_anchors
from sad_tpu.eval.inference import decode_detections as j_decode
from sad_tpu.eval.inference import make_inference_fn as j_make_inference_fn
from sad_tpu.models import RetinaNet as JaxRetinaNet
from sad_tpu.ops.box_transforms import bbox_transform as j_bbox_transform
from sad_tpu.ops.image_norm import content_mask as j_content_mask
from sad_tpu.ops.image_norm import normalize_u8_on_device as j_normalize
import sad_tpu_torch.config as tcfg
from sad_tpu_torch.config.config import merge_cfg_from_dict as t_merge
from sad_tpu_torch.convert import load_params
from test_torch_models import random_params
from sad_tpu_torch.eval.inference import cell_anchors_on, decode_detections, make_inference_fn
from sad_tpu_torch.models import RetinaNet
from sad_tpu_torch.models.arch import ModelArch
from sad_tpu_torch.ops.box_transforms import bbox_transform
from sad_tpu_torch.ops.image_norm import content_mask, normalize_u8_on_device

# decode settings of the flagship configs on a 128x256 canvas
CFG = {
    "MODEL": {"TYPE": "retinanet", "NUM_CLASSES": 81},
    "FPN": {"FPN_ON": True, "RPN_MIN_LEVEL": 3, "RPN_MAX_LEVEL": 7,
            "EXTRA_CONV_LEVELS": True, "COARSEST_STRIDE": 128},
    "RETINANET": {"RETINANET_ON": True, "ASPECT_RATIOS": (1.0, 2.0, 0.5),
                  "SCALES_PER_OCTAVE": 3},
    "TEST": {"SCALES": (128,), "MAX_SIZE": 256, "NMS": 0.5},
    "PIXEL_STD": (57.375, 57.12, 58.395),
    "COMPUTE_DTYPE": "float32",
}


def canvases(seed, n=2, canvas=(128, 256)):
    rng = np.random.RandomState(seed)
    ch, cw = canvas
    data = np.zeros((n, ch, cw, 3), np.uint8)
    content = np.zeros((n, 2), np.float32)
    for i in range(n):
        h, w = rng.randint(ch // 2, ch + 1), rng.randint(cw // 2, cw + 1)
        data[i, :h, :w] = rng.randint(0, 256, (h, w, 3))
        content[i] = (h, w)
    scale = rng.uniform(0.6, 1.6, n).astype(np.float32)
    im_hw = np.round(content / scale[:, None]).astype(np.float32)
    return data, im_hw, scale, content


@pytest.fixture(scope="module")
def slice_pair():
    jc, tc = j_merge(jcfg.Config(), CFG), t_merge(tcfg.Config(), CFG)
    arch = graft._tiny_arch()
    jmodel = JaxRetinaNet(arch)
    data, im_hw, scale, content = canvases(0)
    params = random_params(jmodel, data.astype(np.float32), seed=3)
    port = load_params(RetinaNet(ModelArch(**dataclasses.asdict(arch))).eval(), params)
    return jc, tc, jmodel, params, port, (data, im_hw, scale, content)


def _kept(dets, j):
    """Image j's kept detections sorted by (class, score)."""
    d = {k: np.asarray(v)[j] for k, v in dets.items() if k in ("boxes", "scores", "classes", "valid")}
    m = d["valid"].astype(bool)
    order = np.lexsort((d["scores"][m], d["classes"][m]))
    return d["classes"][m][order], d["scores"][m][order], d["boxes"][m][order]


def _assert_same_detections(ref, got, n):
    for j in range(n):
        c1, s1, b1 = _kept(ref, j)
        c2, s2, b2 = _kept(got, j)
        assert len(c1) == len(c2) and len(c1) > 0
        np.testing.assert_array_equal(c2, c1)
        np.testing.assert_allclose(s2, s1, rtol=0, atol=1e-5)
        np.testing.assert_allclose(b2, b1, rtol=0, atol=1e-3)


def test_make_inference_fn_matches_sad_tpu(slice_pair):
    jc, tc, jmodel, params, port, (data, im_hw, scale, content) = slice_pair
    ref = j_make_inference_fn(jc, jmodel)(params, jnp.asarray(data), jnp.asarray(im_hw),
                                          jnp.asarray(scale), jnp.asarray(content))
    got = make_inference_fn(tc, port)(*(torch.from_numpy(a) for a in (data, im_hw, scale, content)))
    assert got["boxes"].shape == (2, 100, 4) and got["valid"].dtype == torch.bool
    got = {k: v.numpy() for k, v in got.items()}
    _assert_same_detections(ref, got, 2)
    # a busy image: all 100 slots are used, over many classes
    assert got["valid"].all() and len(np.unique(got["classes"])) > 10


def test_save_res_returns_raw_maps(slice_pair):
    _, tc, _, _, port, (data, im_hw, scale, content) = slice_pair
    tc = t_merge(tc, {"TEST": {"SAVE_RES": True}})
    out = make_inference_fn(tc, port)(*(torch.from_numpy(a) for a in (data, im_hw, scale, content)))
    assert sorted(out["raw_cls_prob"]) == [3, 4, 5, 6, 7]
    assert out["raw_bbox_pred"][3].shape == (2, 16, 32, 36)


@pytest.mark.parametrize("use_bbox_reg", [True, False])
def test_decode_alone_on_identical_outputs(slice_pair, use_bbox_reg):
    """Decode (threshold, per-level top-k, box decode, clip, class-wise NMS)
    on the very same per-level maps: the class-offset NMS sees identical
    candidates, so the kept sets agree exactly."""
    jc, tc, jmodel, params, _, (data, im_hw, scale, content) = slice_pair
    x = j_normalize(jnp.asarray(data), jc.PIXEL_MEANS, jc.PIXEL_DIV, jc.PIXEL_STD,
                    jnp.asarray(content))
    out = jmodel.apply({"params": params}, x)
    ref = j_decode(jc, out, jnp.asarray(im_hw), jnp.asarray(scale), use_bbox_reg)
    t_out = {k: {l: torch.from_numpy(np.array(v)) for l, v in d.items()} for k, d in out.items()}
    got = decode_detections(tc, t_out, torch.from_numpy(im_hw), torch.from_numpy(scale),
                            use_bbox_reg)
    got = {k: v.numpy() for k, v in got.items()}
    np.testing.assert_array_equal(got["valid"], np.asarray(ref["valid"]))
    np.testing.assert_array_equal(got["classes"], np.asarray(ref["classes"]))
    np.testing.assert_array_equal(got["scores"], np.asarray(ref["scores"]))
    np.testing.assert_allclose(got["boxes"], np.asarray(ref["boxes"]), rtol=0, atol=1e-3)


def test_image_norm_and_content_mask_elementwise():
    data, _, _, content = canvases(5, n=3, canvas=(64, 96))
    means, std = (102.9801, 115.9465, 122.7717), (57.375, 57.12, 58.395)
    for div in (1.0, 255.0):
        ref = np.asarray(j_normalize(jnp.asarray(data), means, div, std, jnp.asarray(content)))
        got = normalize_u8_on_device(torch.from_numpy(data), means, div, std,
                                     torch.from_numpy(content)).numpy()
        np.testing.assert_array_equal(got, ref)  # the same two f32 ops
    mask = content_mask(data.shape, torch.from_numpy(content)).numpy()
    np.testing.assert_array_equal(mask, np.asarray(j_content_mask(data.shape, jnp.asarray(content))))
    h, w = content[0].astype(int)
    assert (mask[0, h:] == 0).all() and (mask[0, :h, :w] == 1).all()


def test_bbox_transform_elementwise():
    rng = np.random.RandomState(6)
    xy = rng.uniform(0, 500, (400, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(1, 200, (400, 2))], axis=1).astype(np.float32)
    deltas = rng.normal(0, 1.0, (400, 4)).astype(np.float32)
    deltas[:10, 2:] = 9.0  # beyond BBOX_XFORM_CLIP
    for weights in ((1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)):
        ref = np.asarray(j_bbox_transform(jnp.asarray(boxes), jnp.asarray(deltas), weights))
        got = bbox_transform(torch.from_numpy(boxes), torch.from_numpy(deltas), weights).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-4)  # exp may differ by an ulp


@pytest.mark.parametrize("level", [3, 4, 5, 6, 7])
def test_cell_anchors_equal_sad_tpu(level):
    """The decode's device copy of each level's cell anchors equals sad_tpu's
    numpy anchors, and is made once: later decodes reuse the same tensor."""
    dev = torch.device("cpu")
    for ars, spo in (((1.0, 2.0, 0.5), 3), ((0.5, 1.0, 2.0), 2)):
        got = cell_anchors_on(dev, level, 4.0, ars, spo)
        assert got.dtype == torch.float32 and not got.is_inference()
        want = j_cell_anchors(level, 4.0, ars, spo).astype(np.float32)
        np.testing.assert_array_equal(got.numpy(), want)
        assert cell_anchors_on(dev, level, 4.0, ars, spo) is got


@pytest.mark.parametrize("section", ["BBOX_AUG", "SOFT_NMS", "BBOX_VOTE"])
def test_rcnn_only_test_options_leave_retinanet_detections_alone(slice_pair, section):
    """TTA, soft-NMS and box voting belong to sad_tpu's R-CNN branch
    (sad_tpu/eval/test_engine.py:160); its RetinaNet path gives the same
    detections with them on, and so does the port's."""
    _, tc, _, _, port, (data, im_hw, scale, content) = slice_pair
    args = [torch.from_numpy(a) for a in (data, im_hw, scale, content)]
    base = make_inference_fn(tc, port)(*args)
    on = make_inference_fn(t_merge(tc, {"TEST": {section: {"ENABLED": True}}}), port)(*args)
    for key in ("boxes", "scores", "classes", "valid"):
        assert torch.equal(on[key], base[key]), key

