"""The port's checkpoints against sad_tpu's: the native pickle round trip
(atomic), the AUTO_RESUME scan, snapshots that cross between the two
packages in both directions (params and velocity trees equal), and the
reference's Caffe2 blob pickles, whose conversion must give the state_dict
that sad_tpu's converter followed by convert.params_to_state_dict gives.
Everything here is exact: the same float32 numbers in other layouts."""

import os
import pickle

import jax
import numpy as np
import pytest
import torch

import sad_tpu.config as jcfg
import sad_tpu_torch.config as tcfg
from sad_tpu.config.config import merge_cfg_from_dict as j_merge
from sad_tpu.train import checkpoint as jck
from sad_tpu_torch.config.config import merge_cfg_from_dict as t_merge
from sad_tpu_torch.convert import params_to_state_dict, state_dict_to_params
from sad_tpu_torch.models import create_model
from sad_tpu_torch.train import checkpoint as tck
from sad_tpu_torch.train import TrainState
from test_torch_models import one_torch_thread, sad_tpu_native_loaded  # noqa: F401  (autouse)

TINY_MASK = {
    "MODEL": {"TYPE": "generalized_rcnn", "FASTER_RCNN": True, "MASK_ON": True,
              "NUM_CLASSES": 5, "CONV_BODY": "FPN.add_fpn_ResNet50_conv5_body"},
    "RESNETS": {"CHANNEL_RATIO": 0.0625},
    "FPN": {"FPN_ON": True, "MULTILEVEL_RPN": True, "MULTILEVEL_ROIS": True,
            "COARSEST_STRIDE": 64},
    "FAST_RCNN": {"ROI_XFORM_RESOLUTION": 7, "MLP_HEAD_DIM": 32},
    "MRCNN": {"DIM_REDUCED": 8, "RESOLUTION": 14, "ROI_XFORM_RESOLUTION": 7},
    "COMPUTE_DTYPE": "float32",
}


@pytest.fixture(scope="module")
def model_and_velocity():
    """A tiny Mask R-CNN (convs, AffineChannel, FCs with the flattening
    fc6, the ConvTranspose conv5_mask) with every tensor random, and a
    random momentum for every parameter."""
    cfg = t_merge(tcfg.Config(), TINY_MASK)
    model = create_model(cfg, "cpu")
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    state = TrainState.create(model)
    for v in state.velocity.values():
        v.copy_(torch.randn(v.shape, generator=g))
    return cfg, model, state


def _assert_trees_equal(a, b):
    fa = jax.tree_util.tree_flatten_with_path(a)[0]
    fb = jax.tree_util.tree_flatten_with_path(b)[0]
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        assert np.asarray(x).shape == np.asarray(y).shape, path
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=str(path))


def test_save_load_round_trip(tmp_path, model_and_velocity):
    cfg, model, state = model_and_velocity
    path = str(tmp_path / "sub" / "model_iter4.pkl")
    tck.save_checkpoint(path, model, state.velocity, 5, cfg_yaml="X: 1\n")
    assert sorted(os.listdir(tmp_path / "sub")) == ["model_iter4.pkl"]  # no .tmp left
    ck = tck.load_checkpoint(path)
    assert ck["iter"] == 5 and ck["cfg_yaml"] == "X: 1\n"
    _assert_trees_equal(ck["params"], state_dict_to_params(model.state_dict()))

    other = create_model(cfg, "cpu")
    vel = TrainState.create(other).velocity
    tck.restore_checkpoint(ck, other, vel)
    for k, v in model.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k
    assert set(vel) == {n for n, _ in model.named_parameters()}
    for k, v in state.velocity.items():
        assert torch.equal(vel[k], v), k


def test_save_is_atomic(tmp_path, model_and_velocity, monkeypatch):
    """A crash while pickling leaves the earlier checkpoint whole and only
    a .tmp file beside it."""
    _, model, state = model_and_velocity
    path = str(tmp_path / "model_final.pkl")
    tck.save_checkpoint(path, model, state.velocity, 3)
    before = open(path, "rb").read()

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(tck.pickle, "dump", boom)
    with pytest.raises(OSError, match="disk full"):
        tck.save_checkpoint(path, model, state.velocity, 7)
    assert open(path, "rb").read() == before
    assert tck.load_checkpoint(path)["iter"] == 3


def test_restore_refuses_a_velocity_of_other_keys(model_and_velocity):
    cfg, model, state = model_and_velocity
    ck = {"params": state_dict_to_params(model.state_dict()),
          "velocity": state_dict_to_params(
              {k: v for k, v in list(state.velocity.items())[1:]})}
    with pytest.raises(KeyError, match="velocity"):
        tck.restore_checkpoint(ck, create_model(cfg, "cpu"),
                               TrainState.create(model).velocity)


LAYOUTS = {
    "final_only": ["model_final.pkl"],
    "iters_only": ["model_iter3.pkl", "model_iter11.pkl", "model_iter7.pkl"],
    "both": ["model_iter3.pkl", "model_final.pkl", "model_iter9.pkl"],
    "none": [],
    "stray": ["model_iter.pkl", "model_iter5.pkl.tmp", "model_iter2.pkl", "xmodel_iter8.pkl",
              "model_iter04.pkl", "stats.jsonl", "model_nan_abort.pkl"],
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_find_latest_checkpoint_matches_sad_tpu(tmp_path, layout):
    for name in LAYOUTS[layout]:
        (tmp_path / name).write_bytes(b"")
    got = tck.find_latest_checkpoint(str(tmp_path))
    assert got == jck.find_latest_checkpoint(str(tmp_path))
    assert jck.find_latest_checkpoint(str(tmp_path / "missing")) == \
        tck.find_latest_checkpoint(str(tmp_path / "missing")) == (None, 0)


def test_sad_tpu_snapshot_loads_in_the_port(tmp_path, model_and_velocity):
    cfg, model, state = model_and_velocity
    params = state_dict_to_params(model.state_dict())
    velocity = state_dict_to_params(state.velocity)
    path = str(tmp_path / "model_iter9.pkl")
    jck.save_checkpoint(path, params, velocity, 10, cfg_yaml="y")
    ck = tck.load_checkpoint(path)
    other = create_model(cfg, "cpu")
    vel = TrainState.create(other).velocity
    tck.restore_checkpoint(ck, other, vel)
    _assert_trees_equal(state_dict_to_params(other.state_dict()), params)
    _assert_trees_equal(state_dict_to_params(vel), velocity)
    # the student's weights through TRAIN.WEIGHTS take the same path
    third = create_model(cfg, "cpu")
    tck.load_reference_or_native(path, third, cfg)
    _assert_trees_equal(state_dict_to_params(third.state_dict()), params)


def test_port_snapshot_loads_in_sad_tpu(tmp_path, model_and_velocity):
    _, model, state = model_and_velocity
    path = str(tmp_path / "model_final.pkl")
    tck.save_checkpoint(path, model, state.velocity, 12, cfg_yaml="z")
    ck = jck.load_checkpoint(path)
    assert ck["iter"] == 12 and ck["cfg_yaml"] == "z"
    _assert_trees_equal(ck["params"], state_dict_to_params(model.state_dict()))
    _assert_trees_equal(ck["velocity"], state_dict_to_params(state.velocity))
    # sad_tpu's structure: a velocity tree with the params' paths and shapes
    assert (jax.tree_util.tree_structure(ck["velocity"])
            == jax.tree_util.tree_structure(ck["params"]))


def test_caffe2_blobs_match_sad_tpu_converter(tmp_path, model_and_velocity):
    cfg, model, _ = model_and_velocity
    jc = j_merge(jcfg.Config(), TINY_MASK)
    tree = state_dict_to_params(model.state_dict())
    blobs = jck.flax_to_reference_blobs(tree, fc_resolutions=jck.fc_flatten_resolutions(jc))
    assert blobs["fc6_w"].shape[0] == 32 and "conv5_mask_w" in blobs
    want = params_to_state_dict(jck.reference_blobs_to_flax(
        blobs, tree, strict=True, fc_resolutions=jck.fc_flatten_resolutions(jc))[0])
    got, loaded, skipped = tck.reference_blobs_to_state_dict(
        blobs, model, strict=True, fc_resolutions=tck.fc_flatten_resolutions(cfg))
    assert not skipped and len(loaded) == len(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(got[k], model.state_dict()[k]), k

    # a reference pickle ({'blobs': ...}, latin1) through load_reference_or_native,
    # with one blob missing and one of the wrong shape: both keep the model's value
    blobs2 = dict(blobs)
    del blobs2["res2_0_branch2a_w"]
    blobs2["fc7_w"] = np.zeros((3, 3), np.float32)
    path = str(tmp_path / "ref.pkl")
    with open(path, "wb") as f:
        pickle.dump({"blobs": blobs2, "cfg": "..."}, f, protocol=2)
    fresh = create_model(cfg, "cpu", torch.Generator().manual_seed(1))
    kept = {k: v.clone() for k, v in fresh.state_dict().items()}
    tck.load_reference_or_native(path, fresh, cfg)
    for k, v in fresh.state_dict().items():
        if k.endswith("res2_0_branch2a.weight") or k == "box_head.fc7.weight":
            assert torch.equal(v, kept[k]), k
        else:
            assert torch.equal(v, want[k]), k


def test_orbax_is_refused_by_name(tmp_path, model_and_velocity):
    """A directory holding no step of the port's 'orbax' backend (here an
    empty one; sad_tpu's own orbax run in test_torch_async_checkpoint.py) is
    refused by name; an unknown backend raises. The 'orbax' backend itself
    trains (test_torch_async_checkpoint.py)."""
    from sad_tpu_torch.train.train_loop import train_model

    cfg, model, _ = model_and_velocity
    with pytest.raises(NotImplementedError, match="orbax"):
        tck.load_reference_or_native(str(tmp_path), model, cfg)
    other = t_merge(cfg, {"TRAIN": {"CHECKPOINT_BACKEND": "s3"},
                          "OUTPUT_DIR": str(tmp_path / "s")})
    with pytest.raises(ValueError, match="CHECKPOINT_BACKEND"):
        train_model(other, device="cpu")
