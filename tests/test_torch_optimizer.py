"""Caffe2 momentum SGD, the parameter-role masks and the LR schedule of the
port against sad_tpu's momentum_sgd_update / rescale_momentum,
trainable_mask / bias_mask and lr_policy, on the same numpy values.

Tolerances: updated parameters and velocities within 1e-6 * max|ref| (the
same float32 multiply-adds, possibly contracted differently); masks and LR
values exactly equal."""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import sad_tpu.config as jcfg
import sad_tpu.train.lr_policy as jlr
from sad_tpu.models import RetinaNet as JaxRetinaNet
from sad_tpu.models.model_builder import bias_mask as j_bias_mask
from sad_tpu.models.model_builder import trainable_mask as j_trainable_mask
from sad_tpu.train.optimizer import MomentumSGDState
from sad_tpu.train.optimizer import momentum_sgd_update as j_update
from sad_tpu.train.optimizer import rescale_momentum as j_rescale
import sad_tpu_torch.config as tcfg
import sad_tpu_torch.train.lr_policy as tlr
from sad_tpu_torch.convert import load_params, params_to_state_dict, state_dict_to_params
from sad_tpu_torch.models import RetinaNet, bias_mask, trainable_mask
from sad_tpu_torch.models.arch import ModelArch
from sad_tpu_torch.train.optimizer import momentum_sgd_update, rescale_momentum
from test_torch_models import one_torch_thread, random_params, sad_tpu_native_loaded  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
FLAGSHIP = sorted(str(p) for p in (REPO / "sad_tpu_torch" / "configs").glob("*.yaml"))


@pytest.fixture(scope="module")
def tiny():
    arch = graft._tiny_arch()
    x = np.zeros((1, 128, 128, 3), np.float32)
    params = random_params(JaxRetinaNet(arch), x, seed=4)
    model = load_params(RetinaNet(ModelArch(**dataclasses.asdict(arch))), params)
    return params, model


def _leaf_map(tree):
    """{dotted state_dict key: leaf} of a Flax-named tree of bools."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        *mods, name = [p.key for p in path]
        out[".".join(mods + ["weight" if name == "kernel" else name])] = bool(leaf)
    return out


@pytest.mark.parametrize("freeze_at,conv_body", [(2, False), (0, False), (4, False), (2, True)])
def test_masks_equal(tiny, freeze_at, conv_body):
    params, model = tiny
    assert trainable_mask(model, freeze_at, conv_body) == _leaf_map(
        j_trainable_mask(params, freeze_at, conv_body))
    assert bias_mask(model) == _leaf_map(j_bias_mask(params))


def test_frozen_stages_get_no_gradient(tiny):
    """FREEZE_AT = 2 detaches the res2 output: conv1 and res2 get no
    gradient, res3 does, as sad_tpu's stop_gradient."""
    _, model = tiny
    out = model(torch.randn(1, 128, 128, 3))
    loss = sum(v.sum() for v in out["cls_logits"].values())
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, [p for p in named.values() if p.requires_grad],
                                allow_unused=True)
    by_name = dict(zip([n for n, p in named.items() if p.requires_grad], grads))
    assert by_name["fpn.body.conv1.weight"] is None
    assert by_name["fpn.body.Bottleneck_0.res2_0_branch2a.weight"] is None
    assert by_name["fpn.body.Bottleneck_1.res3_0_branch2a.weight"] is not None


@pytest.mark.parametrize("lr,wd", [(0.01, 5e-4), (1e-6, 1e-4)])
def test_momentum_sgd_equals_sad_tpu(tiny, lr, wd):
    params, model = tiny
    rng = np.random.RandomState(5)
    grads = jax.tree_util.tree_map(lambda a: rng.randn(*a.shape).astype(np.float32), params)
    vel = jax.tree_util.tree_map(lambda a: rng.randn(*a.shape).astype(np.float32) * 1e-3, params)
    t_tree, b_tree = j_trainable_mask(params, 2, False), j_bias_mask(params)
    update = jax.jit(lambda p, g, v, lr_: j_update(  # one compile, not eager a leaf
        p, g, MomentumSGDState(v), lr_, momentum=0.9, weight_decay=wd, trainable=t_tree,
        is_bias=b_tree))
    jp, js = update(params, grads, vel, jnp.float32(lr))

    p_sd = {k: v.clone() for k, v in params_to_state_dict(params).items()}
    g_sd, v_sd = params_to_state_dict(grads), params_to_state_dict(vel)
    t_mask, b_mask = trainable_mask(model, 2, False), bias_mask(model)
    names = [n for n in p_sd if t_mask[n]]
    momentum_sgd_update([p_sd[n] for n in names], [g_sd[n] for n in names],
                        [v_sd[n] for n in names], [b_mask[n] for n in names], lr,
                        momentum=0.9, weight_decay=wd)
    for got_tree, ref_tree in ((state_dict_to_params(p_sd), jp),
                               (state_dict_to_params(v_sd), js.velocity)):
        ref = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
        got = jax.tree_util.tree_leaves(got_tree)
        for (path, r), g in zip(ref, got):
            r = np.asarray(r)
            assert np.abs(g - r).max() <= 1e-6 * np.abs(r).max(), path
    frozen = [n for n in p_sd if not t_mask[n]]
    assert frozen and all(torch.equal(p_sd[n], params_to_state_dict(params)[n]) for n in frozen)

    r_tree = j_rescale(js, 0.5, t_tree).velocity
    v_named = dict(v_sd)
    rescale_momentum(v_named, 0.5, t_mask)
    for (path, r), g in zip(jax.tree_util.tree_flatten_with_path(r_tree)[0],
                            jax.tree_util.tree_leaves(state_dict_to_params(v_named))):
        r = np.asarray(r)
        assert np.abs(g - r).max() <= 1e-6 * np.abs(r).max(), path


def test_momentum_sgd_refuses_mismatched_lists():
    with pytest.raises(ValueError, match="differ in length"):
        momentum_sgd_update([torch.zeros(2)], [], [torch.zeros(2)], [False], 0.1,
                            momentum=0.9, weight_decay=0.0)


SOLVERS = {
    "flagship_step": {},
    "steps_with_decay": {"LR_POLICY": "steps_with_decay", "STEPS": (0, 300, 700), "GAMMA": 0.1,
                         "MAX_ITER": 900, "WARM_UP_ITERS": 50},
    "steps_with_lrs": {"LR_POLICY": "steps_with_lrs", "STEPS": (0, 400, 800),
                       "LRS": (0.02, 0.002, 0.0002), "MAX_ITER": 1000,
                       "WARM_UP_METHOD": "constant", "WARM_UP_FACTOR": 0.1},
}


@pytest.mark.parametrize("path", FLAGSHIP, ids=lambda p: Path(p).stem)
@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_lr_policy_equal(path, solver):
    j = jcfg.load_cfg(path)
    t = tcfg.load_cfg(path)
    j = dataclasses.replace(j.SOLVER, **SOLVERS[solver])
    t = dataclasses.replace(t.SOLVER, **SOLVERS[solver])
    its = list(range(0, 60)) + [299, 300, 301, 399, 400, 699, 700, 799, 800, 899, 900, 1000,
                                30000, 30001, 40000]
    lrs = [tlr.get_lr_at_iter(t, i) for i in its]
    assert lrs == [jlr.get_lr_at_iter(j, i) for i in its]
    for a, b in zip(lrs, lrs[1:]):
        assert tlr.lr_change_correction(t, a, b) == jlr.lr_change_correction(j, a, b)
