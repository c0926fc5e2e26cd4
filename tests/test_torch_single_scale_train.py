"""One training step of the port's single-scale R-CNN family and of TRAIN.OHEM
against sad_tpu's jitted ``make_rcnn_train_step`` on the CPU at f32: C4
Faster, C4 Mask with v0upshare and with v0up, VGG_CNN_M_1024, R-FCN, R-FCN
with OHEM, and the FPN step with OHEM (tests/test_single_scale.py's tiny
settings; sad_tpu's sampler draws handed over). Two loss groups of one image
each, as the reference's GPUs of IMS_PER_BATCH 1.

Tolerances: every metric within 1e-5 relative (+1e-7); every updated
parameter within 1e-5 of its tensor's largest magnitude, its update within
1e-3 of the largest update (R-FCN's PSRoIPool sums its windows in another
order: 1.8e-4 here), every momentum within 2e-3 of its largest entry (the
bound of tests/test_torch_rcnn_train.py). OHEM's keep masks: exactly
sad_tpu's selection, ties included.
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sad_tpu.config as jcfg
import sad_tpu_torch.config as tcfg
from sad_tpu.config.config import merge_cfg_from_dict as j_merge
from sad_tpu.models import create_model as j_create_model
from sad_tpu.ops.detectron_ops import smooth_l1_loss_per_roi
from sad_tpu.train.optimizer import init_momentum_state
from sad_tpu.train.rcnn_train import fast_rcnn_losses as j_fast_rcnn_losses
from sad_tpu.train.rcnn_train import make_rcnn_train_step as j_make_rcnn_train_step
from sad_tpu.train.train_step import TrainState as JTrainState
from sad_tpu_torch.config.config import merge_cfg_from_dict as t_merge
from sad_tpu_torch.convert import load_params, state_dict_to_params
from sad_tpu_torch.models import GeneralizedRCNN, SingleScaleRCNN
from sad_tpu_torch.ops.detectron_ops import ohem_keep
from sad_tpu_torch.train import TrainState, batch_to_torch, make_rcnn_train_step
from sad_tpu_torch.tools import train_net
from sad_tpu_torch.train import rcnn_train as trt
from test_torch_models import one_torch_thread, sad_tpu_native_loaded  # noqa: F401  (autouse)
from test_torch_rcnn import rcnn_params
from test_torch_rcnn_train import TINY, jax_uniforms, make_batch, _tree_items
from test_torch_single_scale import MODELS, V0UP, ss_over
from test_torch_test_net import MASK_VAL, _yaml, splits  # noqa: F401

LR = 1e-2
OHEM = {"OHEM": True, "OHEM_ROI_PER_IMG": 5}
STEPS = {
    "c4_faster": ss_over(),
    "c4_mask_v0upshare": ss_over(**MODELS["c4_mask_v0upshare"]),
    "c4_mask_v0up": ss_over(**MODELS["c4_mask_v0up"]),
    "vgg_cnn_m": ss_over(**MODELS["vgg_cnn_m"]),
    "rfcn": ss_over(**MODELS["rfcn"]),
    "rfcn_ohem": ss_over(**MODELS["rfcn"], TRAIN=OHEM),
    "fpn_ohem": dict(TINY, TRAIN=dict(TINY["TRAIN"], **OHEM)),
}


def _step_pair(over, n_groups=2, seed=21):
    """sad_tpu's jitted step and the port's step on the same weights, batch
    and sampler uniforms: (reference metrics, new state; port metrics,
    model, state; the initial params)."""
    jc, tc = j_merge(jcfg.Config(), over), t_merge(tcfg.Config(), over)
    jmodel = j_create_model(jc)
    params = rcnn_params(jmodel, seed=seed, hw=(64, 64))
    mask = tc.MODEL.MASK_ON
    batch = make_batch(jc, mask=mask)
    key = jax.random.PRNGKey(3)
    jstate = JTrainState(params, init_momentum_state(params).velocity)
    single = not tc.FPN.FPN_ON
    port = load_params((SingleScaleRCNN if single else GeneralizedRCNN)(tc), params)
    state = TrainState.create(port)
    p = tc.TRAIN.RPN_POST_NMS_TOP_N + batch["gt_boxes"].shape[1]
    uniforms = jax_uniforms(key, 2, p)
    # sad_tpu's step (traced and compiled) beside the port's
    with ThreadPoolExecutor(1) as pool:
        jstep = jax.jit(j_make_rcnn_train_step(jc, jmodel, n_groups=n_groups))
        ref = pool.submit(jstep, jstate, jax.tree_util.tree_map(jnp.asarray, batch),
                          jnp.float32(LR), key)
        step = make_rcnn_train_step(tc, port, n_groups=n_groups)
        got = step(state, batch_to_torch(batch, "cpu"), LR, uniforms=uniforms)
        new_state, ref = ref.result()
    return ref, new_state, got, port, state, params


@pytest.mark.parametrize("name", sorted(STEPS))
def test_one_step_matches_sad_tpu(name):
    ref, new_state, got, port, state, params = _step_pair(STEPS[name])
    assert sorted(got) == sorted(ref)
    assert ("loss_mask" in got) == ("mask" in name)
    assert ("loss_rpn_cls_fpn2" in got) == (name == "fpn_ohem")  # one level, 4, single-scale
    for k in ref:
        r, g = float(ref[k]), float(got[k])
        assert abs(r - g) <= 1e-5 * abs(r) + 1e-7, (k, r, g)
    assert float(got["loss_cls"]) > 0
    old = dict(_tree_items(params))
    new_ref = dict(_tree_items(jax.tree_util.tree_map(np.asarray, new_state.params)))
    vel_ref = dict(_tree_items(jax.tree_util.tree_map(np.asarray, new_state.velocity)))
    new_got = dict(_tree_items(state_dict_to_params(port.state_dict())))
    vel_got = dict(_tree_items(state_dict_to_params(state.velocity)))
    assert sorted(new_got) == sorted(new_ref) == sorted(old)
    moved = 0
    for k in old:
        d_r, d_g = new_ref[k] - old[k], new_got[k] - old[k]
        assert np.abs(new_ref[k] - new_got[k]).max() <= 1e-5 * np.abs(new_ref[k]).max(), k
        assert np.abs(d_r - d_g).max() <= 1e-3 * np.abs(d_r).max() + 1e-9, k
        assert np.abs(vel_ref[k] - vel_got[k]).max() <= 2e-3 * np.abs(vel_ref[k]).max() + 1e-8
        assert bool(np.abs(d_g).max() > 0) == bool(np.abs(d_r).max() > 0), k
        moved += bool(np.abs(d_g).max() > 0)
    assert moved >= 20  # the frozen stem, res2 and AffineChannels stay


def test_v0upshare_and_v0up_take_their_res5():
    """v0upshare's mask head reads the box branch's res5 maps (no
    mask_res5, one RoIAlign); v0up pools the fg rois again into its own
    mask_res5."""
    tc = t_merge(tcfg.Config(), STEPS["c4_mask_v0upshare"])
    share = SingleScaleRCNN(tc)
    assert share.mask_share_res5 and not hasattr(share, "mask_res5")
    tc = t_merge(tcfg.Config(), STEPS["c4_mask_v0up"])
    own = SingleScaleRCNN(tc)
    assert not own.mask_share_res5 and hasattr(own, "mask_res5")
    assert tc.MRCNN.ROI_MASK_HEAD == V0UP


def _j_keep(per_total, n_images, k):
    """sad_tpu's OHEM selection (sad_tpu/train/rcnn_train.py:137-145)."""
    def keep_one(row):
        thresh = jax.lax.top_k(row, k)[0][-1]
        rank = jnp.argsort(jnp.argsort(-row))
        return ((row >= thresh) & (rank < k)).astype(jnp.float32)
    return np.asarray(jax.vmap(keep_one)(jnp.asarray(per_total).reshape(n_images, -1)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ohem_keep_masks_and_losses_match_sad_tpu(seed):
    """TRAIN.OHEM on crafted rows with many exact ties, ignored labels and
    padding: the port's keep mask equals sad_tpu's selection exactly, and
    fast_rcnn_losses' metrics equal sad_tpu's within 1e-6 relative, over
    two groups of two images."""
    rng = np.random.RandomState(seed)
    n_img, per, c = 4, 12, 5
    r = n_img * per
    # quantised logits and deltas: many rois share a loss exactly
    cls_score = (np.round(rng.randn(r, c) * 2) / 2).astype(np.float32)
    labels = rng.randint(-1, c, r).astype(np.int32)
    bbox_pred = (np.round(rng.randn(r, 4 * c) * 2) / 2).astype(np.float32)
    targets = (np.round(rng.randn(r, 4 * c) * 2) / 2).astype(np.float32)
    in_w = (rng.rand(r, 4 * c) > 0.7).astype(np.float32)
    out_w = in_w.copy()
    valid = rng.rand(r) > 0.15
    over = {"TRAIN": {"OHEM": True, "OHEM_ROI_PER_IMG": 5}}
    jc, tc = j_merge(jcfg.Config(), over), t_merge(tcfg.Config(), over)
    args = (cls_score, labels, bbox_pred, targets, in_w, out_w, valid)
    _, ref = j_fast_rcnn_losses(jc, *map(jnp.asarray, args), 2, n_images=n_img)
    t_args = [torch.from_numpy(a) for a in args]
    _, got = trt.fast_rcnn_losses(tc, *t_args, 2, n_images=n_img)
    for k in ref:
        assert abs(float(ref[k]) - float(got[k])) <= 1e-6 * abs(float(ref[k])) + 1e-8, k
    nll, live = trt.box_nll(t_args[0], t_args[1], t_args[6])
    keep = trt.ohem_select(tc, nll, live, *t_args[2:6], n_img).numpy()
    logp = jax.nn.log_softmax(jnp.asarray(cls_score), axis=-1)
    j_nll = -jnp.take_along_axis(logp, jnp.maximum(jnp.asarray(labels), 0)[:, None], -1)[:, 0]
    j_live = jnp.asarray(valid) & (jnp.asarray(labels) >= 0)
    j_nll = jnp.where(j_live, j_nll, 0.0)
    total = jnp.where(j_live, j_nll + smooth_l1_loss_per_roi(*map(jnp.asarray, args[2:6])),
                      -1.0)
    want = _j_keep(total, n_img, 5).reshape(-1) * np.asarray(j_live, np.float32)
    np.testing.assert_array_equal(keep, want)
    ties = np.asarray(total).reshape(n_img, -1)
    assert any(len(set(row.tolist())) < len(row) for row in ties)  # ties were there


def test_ohem_kept_rois_per_image():
    """Each image keeps min(OHEM_ROI_PER_IMG, its live rois)."""
    rng = np.random.RandomState(7)
    total = torch.from_numpy(np.round(rng.rand(3, 20) * 3).astype(np.float32))
    total[1, 15:] = -1.0  # five padding slots rank last
    k = ohem_keep(total, 8)
    assert k.sum(dim=1).tolist() == [8.0, 8.0, 8.0]
    assert not bool(k[1, 15:].any())


@pytest.mark.parametrize("name", ["c4_mask_v0upshare", "rfcn_ohem"])
def test_train_net_runs_the_single_scale_models(name, splits, tmp_path):  # noqa: F811
    """tools/train_net on a 3-image synthetic split, 2 iterations of 2
    images: the loader's single-scale RPN targets (one level, 4), the step,
    stats with the RPN's level-4 losses (and loss_mask for C4), the final
    snapshot; R-FCN is an R-CNN type of the loop (train_loop.RCNN_TYPES)."""
    over = dict(STEPS[name], MODEL=dict(STEPS[name]["MODEL"], NUM_CLASSES=9),
                TRAIN=dict(STEPS[name]["TRAIN"], DATASETS=(MASK_VAL,), IMS_PER_BATCH=2,
                           SCALES=(64,), MAX_SIZE=96),
                NUM_GPUS=1, SOLVER={"BASE_LR": 1e-3, "MAX_ITER": 2})
    out = str(tmp_path / "out")
    result = train_net.main(["--cfg", _yaml(tmp_path / "cfg.yaml", over), "--skip-test",
                             "--device", "cpu", "OUTPUT_DIR", out])
    assert result.max_iter == 2
    run_dir = os.path.join(out, "train", MASK_VAL)
    assert os.path.exists(os.path.join(run_dir, "model_final.pkl"))
    stats = [json.loads(line) for line in open(os.path.join(run_dir, "stats.jsonl"))]
    assert stats and all(np.isfinite(s["loss"]) for s in stats)
    assert "loss_rpn_cls_fpn4" in stats[-1] and ("loss_mask" in stats[-1]) == ("mask" in name)
