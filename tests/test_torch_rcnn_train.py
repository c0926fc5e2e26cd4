"""One whole Faster / Mask R-CNN training step of the port against
sad_tpu's ``make_rcnn_train_step`` on the tiny architecture of
__graft_entry__.dryrun_multichip (CHANNEL_RATIO 0.0625, 64x64 canvases, 5
classes): the same converted float32 weights, the same batch, and the
sampler's uniforms drawn by JAX and handed to the port.

Tolerances (float32 on the CPU; the two frameworks sum convolutions and
reductions in other orders): every metric within 1e-4 relative + 1e-6; every
tensor of the momentum (LR x effective gradient after one step) within 2e-3
of that tensor's largest entry + 1e-8; every updated parameter within the
same bound on its update. No seed is avoided. Fast R-CNN (MODEL.FASTER_RCNN
False): two steps on a batch of seeded proposals, no RPN targets, held the
same way after each.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sad_tpu.config as jcfg
import sad_tpu_torch.config as tcfg
from sad_tpu.config.config import merge_cfg_from_dict as j_merge
from sad_tpu.data.rpn_minibatch import add_rpn_blobs_to_batch as j_add_rpn_blobs
from sad_tpu.models import bias_mask as j_bias_mask
from sad_tpu.models import create_model as j_create_model
from sad_tpu.models import trainable_mask as j_trainable_mask
from sad_tpu.train.optimizer import init_momentum_state
from sad_tpu.train.rcnn_train import make_rcnn_train_step as j_make_rcnn_train_step
from sad_tpu.train.train_step import TrainState as JTrainState
from sad_tpu_torch.config.config import merge_cfg_from_dict as t_merge
from sad_tpu_torch.convert import load_params, state_dict_to_params
from sad_tpu_torch.models import GeneralizedRCNN, bias_mask, trainable_mask
from sad_tpu_torch.train import TrainState, batch_to_torch, make_rcnn_train_step
from sad_tpu_torch.train import rcnn_train
from sad_tpu_torch.data.synthetic import random_proposals
from test_torch_rcnn import rcnn_params
from test_torch_models import one_torch_thread  # noqa: F401  (autouse)

HW = (64, 64)
LR = 1e-2
TINY = {
    "MODEL": {"TYPE": "generalized_rcnn", "FASTER_RCNN": True, "NUM_CLASSES": 5,
              "CONV_BODY": "FPN.add_fpn_ResNet50_conv5_body"},
    "RESNETS": {"CHANNEL_RATIO": 0.0625},
    "FPN": {"FPN_ON": True, "MULTILEVEL_RPN": True, "MULTILEVEL_ROIS": True,
            "RPN_MIN_LEVEL": 2, "RPN_MAX_LEVEL": 6, "ROI_MIN_LEVEL": 2, "ROI_MAX_LEVEL": 5,
            "COARSEST_STRIDE": 64},
    "TRAIN": {"SCALES": (64,), "MAX_SIZE": 64, "RPN_PRE_NMS_TOP_N": 32,
              "RPN_POST_NMS_TOP_N": 16, "BATCH_SIZE_PER_IM": 8, "IMS_PER_BATCH": 1},
    "FAST_RCNN": {"ROI_XFORM_RESOLUTION": 7, "MLP_HEAD_DIM": 32},
    "MRCNN": {"DIM_REDUCED": 8, "RESOLUTION": 14, "ROI_XFORM_RESOLUTION": 7},
    "COMPUTE_DTYPE": "float32",
}


def cfg_pair(mask_on, **top):
    over = dict(TINY, MODEL=dict(TINY["MODEL"], MASK_ON=mask_on), **top)
    return j_merge(jcfg.Config(), over), t_merge(tcfg.Config(), over)


def make_batch(jc, b=2, seed=0, mask=True):
    """The batch of the dryrun: random float images, two gt boxes an image,
    RPN targets from sad_tpu's add_rpn_blobs_to_batch, random binary rasters at
    stride 8."""
    rng = np.random.RandomState(seed)
    hh, ww = HW
    batch = {"data": rng.randn(b, hh, ww, 3).astype(np.float32),
             "im_hw": np.tile(np.float32([hh, ww]), (b, 1))}
    entries = [{"boxes": np.asarray([[8, 8, 40, 40], [20, 20, 60, 56]], np.float32)
                + rng.uniform(-3, 3, (2, 4)).astype(np.float32),
                "gt_classes": np.asarray([1, 3], np.int32), "is_crowd": np.zeros(2, bool)}
               for _ in range(b)]
    j_add_rpn_blobs(jc, batch, entries, (hh, ww), np.ones(b), seed=seed)
    if mask:
        batch["gt_mask_rasters"] = (rng.rand(b, 2, hh // 8, ww // 8) > 0.5).astype(np.float32)
        batch["gt_mask_stride"] = 8.0
    return batch


def jax_uniforms(key, b, p):
    """The uniforms sad_tpu's step draws: one key an image
    (rcnn_train.py:261), split in two inside sample_proposal_labels."""
    u_fg, u_bg = [], []
    for k in jax.random.split(key, b):
        r1, r2 = jax.random.split(k)
        u_fg.append(np.asarray(jax.random.uniform(r1, (p,))))
        u_bg.append(np.asarray(jax.random.uniform(r2, (p,))))
    return torch.from_numpy(np.stack(u_fg)), torch.from_numpy(np.stack(u_bg))


@pytest.fixture(scope="module", params=["faster", "mask"])
def family(request):
    mask_on = request.param == "mask"
    jc, tc = cfg_pair(mask_on)
    jmodel = j_create_model(jc)
    params = rcnn_params(jmodel, seed=21, hw=HW)
    return mask_on, jc, tc, jmodel, params


def _tree_items(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _tree_items(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


@pytest.mark.parametrize("n_groups", [1, 2])
def test_one_step_matches_sad_tpu(family, n_groups):
    mask_on, jc, tc, jmodel, params = family
    batch = make_batch(jc, mask=mask_on)
    key = jax.random.PRNGKey(3)
    jstate = JTrainState(params, init_momentum_state(params).velocity)
    jstep = jax.jit(j_make_rcnn_train_step(jc, jmodel, n_groups=n_groups))
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    new_state, ref = jstep(jstate, jbatch, jnp.float32(LR), key)

    port = load_params(GeneralizedRCNN(tc), params)
    state = TrainState.create(port)
    step = make_rcnn_train_step(tc, port, n_groups=n_groups)
    p = tc.TRAIN.RPN_POST_NMS_TOP_N + batch["gt_boxes"].shape[1]
    got = step(state, batch_to_torch(batch, "cpu"), LR, uniforms=jax_uniforms(key, 2, p))

    assert sorted(got) == sorted(ref)
    assert ("loss_mask" in got) == mask_on
    for k in ref:
        r, g = float(ref[k]), float(got[k])
        assert abs(r - g) <= 1e-4 * abs(r) + 1e-6, (k, r, g)
    assert float(got["loss_cls"]) > 0 and float(got["loss_rpn_cls_fpn2"]) > 0

    old = dict(_tree_items(params))
    new_ref = dict(_tree_items(jax.tree_util.tree_map(np.asarray, new_state.params)))
    vel_ref = dict(_tree_items(jax.tree_util.tree_map(np.asarray, new_state.velocity)))
    new_got = dict(_tree_items(state_dict_to_params(port.state_dict())))
    vel_got = dict(_tree_items(state_dict_to_params(state.velocity)))
    assert sorted(new_got) == sorted(new_ref) and sorted(vel_got) == sorted(vel_ref)
    moved, frozen = set(), {k.replace(".", "/").replace("/weight", "/kernel")
                            for k, v in trainable_mask(port, tc.TRAIN.FREEZE_AT).items() if not v}
    for name in old:
        v_r, v_g = vel_ref[name], vel_got[name]
        tol = 2e-3 * np.abs(v_r).max() + 1e-8
        assert np.abs(v_r - v_g).max() <= tol, (name, np.abs(v_r - v_g).max(), tol)
        d_r, d_g = new_ref[name] - old[name], new_got[name] - old[name]
        assert np.abs(d_r - d_g).max() <= 2e-3 * np.abs(d_r).max() + 1e-7, name
        assert bool(np.abs(d_g).max() > 0) == bool(np.abs(d_r).max() > 0), name
        if np.abs(d_g).max() > 0:
            moved.add(name)
    assert not (moved & frozen) and len(moved) >= 0.9 * (len(old) - len(frozen))


def test_masks_match_sad_tpu(family):
    """trainable_mask and bias_mask over the R-CNN modules against sad_tpu's
    over the Flax tree, through convert.py's name map."""
    _, jc, tc, _, params = family
    port = GeneralizedRCNN(tc)
    for freeze_at, freeze_body in ((2, False), (0, False), (3, False), (2, True)):
        ref = dict(_tree_items(j_trainable_mask(params, freeze_at, freeze_body)))
        got = trainable_mask(port, freeze_at, freeze_body)
        back = {k.replace(".", "/").replace("/weight", "/kernel"): v for k, v in got.items()}
        assert back == {k: bool(v) for k, v in ref.items()}
    ref = dict(_tree_items(j_bias_mask(params)))
    back = {k.replace(".", "/").replace("/weight", "/kernel"): v
            for k, v in bias_mask(port).items()}
    assert back == {k: bool(v) for k, v in ref.items()}


def test_roi_slots_per_im_slices_a_prefix():
    _, tc = cfg_pair(True, MRCNN=dict(TINY["MRCNN"], ROI_SLOTS_PER_IM=1))
    port = GeneralizedRCNN(tc)
    assert make_rcnn_train_step(tc, port).mask_cap() == 1
    _, tc = cfg_pair(True)
    assert make_rcnn_train_step(tc, port).mask_cap() == 2  # round(0.25 * 8)


@pytest.mark.parametrize("over,what", [
    (dict(FPN=dict(TINY["FPN"], MULTILEVEL_RPN=False)), "MULTILEVEL_RPN"),
    (dict(FPN=dict(TINY["FPN"], MULTILEVEL_ROIS=False)), "MULTILEVEL_ROIS"),
])
def test_branches_left_for_later_raise(over, what):
    """An FPN model's step without MULTILEVEL_RPN / MULTILEVEL_ROIS is
    refused (sad_tpu ignores MULTILEVEL_ROIS, and fails on an FPN model
    without MULTILEVEL_RPN); TRAIN.OHEM and the single-scale step are ported
    (tests/test_torch_single_scale_train.py)."""
    tc = t_merge(tcfg.Config(), dict(TINY, **over))
    port = GeneralizedRCNN(t_merge(tcfg.Config(), TINY))
    with pytest.raises(NotImplementedError, match="Queue 3") as e:
        make_rcnn_train_step(tc, port)
    assert what in str(e.value)
    ohem = t_merge(tcfg.Config(), dict(TINY, TRAIN=dict(TINY["TRAIN"], OHEM=True)))
    assert make_rcnn_train_step(ohem, port).cfg.TRAIN.OHEM
    # keypoints are ported: the same config with KEYPOINTS_ON builds its step
    kps = t_merge(tcfg.Config(), dict(TINY, MODEL=dict(TINY["MODEL"], KEYPOINTS_ON=True)))
    assert make_rcnn_train_step(kps, GeneralizedRCNN(kps)).kps_cap() == 2
    assert rcnn_train.make_rcnn_train_step is make_rcnn_train_step


def test_two_fast_rcnn_steps_on_proposals_match_sad_tpu():
    """Fast R-CNN: no RPN head or losses, the sampler on 24 seeded proposals
    an image and the gt boxes, the box branch; after each of two steps the
    metrics, after both the parameters and momenta (the mask branch after
    it is the Faster step's, held above)."""
    over = dict(TINY, MODEL=dict(TINY["MODEL"], FASTER_RCNN=False))
    jc, tc = j_merge(jcfg.Config(), over), t_merge(tcfg.Config(), over)
    jmodel = j_create_model(jc)
    params = rcnn_params(jmodel, seed=21, hw=HW)
    batch = {k: v for k, v in make_batch(jc, mask=False).items() if not k.startswith("rpn_")}
    rng = np.random.RandomState(5)
    batch["proposal_boxes"] = np.stack([
        random_proposals(rng, HW[1], HW[0], 24, batch["gt_boxes"][i]) for i in range(2)])
    batch["proposal_valid"] = rng.rand(2, 24) > 0.1
    jstate = JTrainState(params, init_momentum_state(params).velocity)
    jstep = jax.jit(j_make_rcnn_train_step(jc, jmodel))
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    port = load_params(GeneralizedRCNN(tc), params)
    state = TrainState.create(port)
    step = make_rcnn_train_step(tc, port)
    tbatch = batch_to_torch(batch, "cpu")
    p = 24 + batch["gt_boxes"].shape[1]
    for i in range(2):
        key = jax.random.PRNGKey(10 + i)
        jstate, ref = jstep(jstate, jbatch, jnp.float32(LR), key)
        got = step(state, tbatch, LR, uniforms=jax_uniforms(key, 2, p))
        assert sorted(got) == sorted(ref)
        assert not any(k.startswith("loss_rpn") for k in got)
        for k in ref:
            r, g = float(ref[k]), float(got[k])
            assert abs(r - g) <= 1e-4 * abs(r) + 1e-6, (i, k, r, g)
        assert float(got["loss_cls"]) > 0 and float(got["accuracy_cls"]) > 0
    old = dict(_tree_items(params))
    new_ref = dict(_tree_items(jax.tree_util.tree_map(np.asarray, jstate.params)))
    vel_ref = dict(_tree_items(jax.tree_util.tree_map(np.asarray, jstate.velocity)))
    new_got = dict(_tree_items(state_dict_to_params(port.state_dict())))
    vel_got = dict(_tree_items(state_dict_to_params(state.velocity)))
    assert sorted(new_got) == sorted(new_ref) and sorted(vel_got) == sorted(vel_ref)
    for name in old:
        v_r, v_g = vel_ref[name], vel_got[name]
        assert np.abs(v_r - v_g).max() <= 2e-3 * np.abs(v_r).max() + 1e-8, name
        d_r, d_g = new_ref[name] - old[name], new_got[name] - old[name]
        assert np.abs(d_r - d_g).max() <= 2e-3 * np.abs(d_r).max() + 1e-7, name
    # the RPN head gets no gradient: only its weight decay moves it
    assert np.abs(vel_got["rpn/conv_rpn_fpn2/kernel"]).max() > 0
