"""FOLD_AFFINE in the port (models/resnet.py conv_affine) against sad_tpu's
(sad_tpu/models/resnet.py:222-260, the stem :307-315), modeled on
tests/test_affine_fold.py: the same float32 weights with AffineChannel scales
and offsets away from 1 / 0, FOLD_AFFINE on in both packages, groups 1 and 2,
stem included. The trunk's stage outputs at float32 agree within
1e-4 * max|ref| + 1e-5 (the two frameworks sum float32 convolutions in other
orders), the whole RetinaNet's outputs likewise, and every conv kernel's
gradient within 1e-10 of the largest at float64. In
the port alone: the fold equals the unfolded form at float32, leaves the
AffineChannel's s and b without gradient, and at bfloat16 stays within
0.05 * max|unfolded| of the unfolded form (W*s is rounded to bfloat16 once
more, and the rounding of conv(x, W) * s goes)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from sad_tpu.models import RetinaNet as JaxRetinaNet
from sad_tpu.models.resnet import ResNetBody as JaxResNetBody
from sad_tpu_torch.convert import load_params, params_to_state_dict
from sad_tpu_torch.models import RetinaNet
from sad_tpu_torch.models.resnet import ResNetBody
from test_torch_models import (  # noqa: F401
    _close, _port_arch, one_torch_thread, random_params, sad_tpu_native_loaded,
)

BF16_TOL = 0.05  # of max|unfolded output|, bf16 fold vs unfold (see the docstring)


def body_arch(groups, fold=True):
    return graft._tiny_arch(num_groups=groups, width_per_group=8 // groups,
                            stride_1x1=groups == 1, block_counts=(1, 2, 1, 1), freeze_at=0,
                            fold_affine=fold)


def _body_case(groups, seed):
    arch = body_arch(groups)
    x = np.random.RandomState(seed).randn(2, 64, 96, 3).astype(np.float32)
    body = JaxResNetBody(arch)
    params = random_params(body, x, seed=seed + 1)
    return arch, x, body, params


@pytest.mark.parametrize("groups", [1, 2])
def test_folded_body_matches_sad_tpu(groups):
    arch, x, body, params = _body_case(groups, seed=groups)
    ref = jax.jit(body.apply)({"params": params}, jnp.asarray(x))  # one compile, not eager
    port = load_params(ResNetBody(_port_arch(arch)).eval(), params)
    assert port.arch.fold_affine
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert sorted(got) == sorted(ref)
    for k in ref:
        _close(ref[k], got[k].permute(0, 2, 3, 1).numpy())


@pytest.mark.parametrize("groups", [1, 2])
def test_folded_kernel_grads_match_sad_tpu(groups):
    """Every conv kernel's gradient, stem included, from both packages in
    float64 (within 1e-10 of the largest): at float32 a ReLU input within
    ~1e-6 of zero rounds to either side on these seeds, in JAX's folded run
    and in the port's unfolded one, and moves a kernel's gradient by up to
    2 %, which hides what the fold does."""
    arch, x, _, params = _body_case(groups, seed=groups)
    arch = dataclasses.replace(arch, compute_dtype="float64")
    with jax.enable_x64(True):
        body = JaxResNetBody(arch)
        p64 = jax.tree_util.tree_map(lambda v: jnp.asarray(np.asarray(v, np.float64)), params)
        x64 = jnp.asarray(x, jnp.float64)
        shapes = jax.eval_shape(body.apply, {"params": p64}, x64)
        rng = np.random.RandomState(9)
        cts = {k: rng.randn(*v.shape) for k, v in sorted(shapes.items())}

        def objective(p):
            out = body.apply({"params": p}, x64)
            return sum(jnp.sum(out[k] * cts[k]) for k in out)

        grads = jax.jit(jax.grad(objective))(p64)  # one compile, not eager a primitive
        ref = params_to_state_dict(jax.tree_util.tree_map(np.asarray, grads))

    port = load_params(ResNetBody(_port_arch(arch)), params).double()
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    sum((got[k] * torch.from_numpy(cts[k]).permute(0, 3, 1, 2)).sum() for k in got).backward()
    named = dict(port.named_parameters())
    kernels = [n for n in named if n.endswith(".weight")]
    assert "conv1.weight" in kernels and len(kernels) >= 20
    for n in kernels:
        want, have = ref[n].double(), named[n].grad
        assert have is not None and have.dtype == torch.float64, n
        assert float((have - want).abs().max()) <= 1e-10 * float(want.abs().max()), n
    # the frozen AffineChannels get no gradient through the fold
    assert all(named[n].grad is None for n in named if n.endswith((".s", ".b")))


@pytest.mark.parametrize("groups", [1, 2])
def test_fold_equals_unfolded_at_f32(groups):
    arch, x, body, params = _body_case(groups, seed=5)
    folded = load_params(ResNetBody(_port_arch(arch)).eval(), params)
    plain = load_params(ResNetBody(_port_arch(body_arch(groups, fold=False))).eval(), params)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        a, b = folded(xt), plain(xt)
    for k in a:
        _close(b[k].numpy(), a[k].numpy())


def test_fold_within_tolerance_of_unfolded_at_bf16():
    arch, x, body, params = _body_case(2, seed=6)
    bf = dict(compute_dtype="bfloat16")
    folded = load_params(ResNetBody(_port_arch(dataclasses.replace(arch, **bf))).eval(), params)
    plain = load_params(ResNetBody(_port_arch(dataclasses.replace(
        body_arch(2, fold=False), **bf))).eval(), params)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        a, b = folded(xt), plain(xt)
    for k in a:
        assert a[k].dtype == torch.bfloat16
        ref = b[k].float()
        err = float((a[k].float() - ref).abs().max())
        assert err <= BF16_TOL * float(ref.abs().max()), (k, err)
        assert not torch.equal(a[k], b[k])  # the fold really ran


def test_folded_retinanet_outputs_match_sad_tpu():
    arch = graft._tiny_arch(fold_affine=True)
    x = np.random.RandomState(3).randn(1, 128, 128, 3).astype(np.float32)
    model = JaxRetinaNet(arch)
    params = random_params(model, x, seed=4)
    ref = jax.jit(model.apply)({"params": params}, jnp.asarray(x))
    port = load_params(RetinaNet(_port_arch(arch)).eval(), params)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for key in ("cls_logits", "bbox_pred"):
        for lvl in arch.levels:
            _close(ref[key][lvl], got[key][lvl].numpy())
