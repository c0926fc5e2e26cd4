"""The port's greedy NMS against sad_tpu's Pallas kernels on the same numpy
inputs. On this CPU host the Pallas kernels run in interpret mode
(pallas_nms._interpret()), as in tests/test_pallas_nms.py, and the port
takes its plain version. idx and valid must be exactly equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sad_tpu.ops import nms as jnms
from sad_tpu.ops import pallas_nms
from sad_tpu_torch.ops import nms as tnms

NEG = np.float32(-1e30)


def _case(seed, n, k, clusters=20, tie_step=None):
    """Clustered boxes so real suppression happens; continuous scores."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(0, 400, (n, clusters, 2))
    which = rng.randint(0, clusters, (n, k))
    xy = np.take_along_axis(centers, which[..., None], axis=1) + rng.uniform(-8, 8, (n, k, 2))
    wh = rng.uniform(8, 60, (n, k, 2))
    boxes = np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)
    scores = rng.uniform(0.01, 1.0, (n, k)).astype(np.float32)
    if tie_step:
        scores = (np.round(scores / tie_step) * tie_step).astype(np.float32)
    return boxes, scores


def _assert_equal(port, ref):
    i1, v1 = (np.asarray(x) for x in ref)
    i2, v2 = (x.numpy() for x in port)
    np.testing.assert_array_equal(v2, v1)
    np.testing.assert_array_equal(i2, i1)


def test_pallas_runs_interpreted_here():
    assert pallas_nms._interpret()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("thr", [0.3, 0.5, 0.7])
def test_nms_fixed_matches_pallas(seed, thr):
    boxes, scores = _case(seed, 1, 300)
    ref = pallas_nms.nms_fixed_pallas(jnp.asarray(boxes[0]), jnp.asarray(scores[0]), thr, 50)
    port = tnms.nms_fixed(torch.from_numpy(boxes[0]), torch.from_numpy(scores[0]), thr, 50)
    assert bool(port[1].all())  # 50 picks are available: every step is valid
    _assert_equal(port, ref)


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("thr", [0.3, 0.5, 0.7])
def test_batched_nms_multi_matches_sad_tpu(seed, thr):
    """Class offsets with a per-problem span, invalid candidates, and N not a
    multiple of the TPU kernel's 8 problems per program."""
    n, k = 3, 333
    boxes, scores = _case(seed, n, k)
    rng = np.random.RandomState(seed + 100)
    classes = rng.randint(0, 5, (n, k)).astype(np.int32)
    valid = rng.uniform(size=(n, k)) < 0.8
    ref = jnms.batched_nms_multi(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes),
                                 jnp.asarray(valid), thr, 40)
    port = tnms.batched_nms_multi(torch.from_numpy(boxes), torch.from_numpy(scores),
                                  torch.from_numpy(classes), torch.from_numpy(valid), thr, 40)
    _assert_equal(port, ref)
    single = tnms.batched_nms(*(torch.from_numpy(a[1]) for a in (boxes, scores, classes, valid)),
                              thr, 40)
    np.testing.assert_array_equal(single[0].numpy(), port[0][1].numpy())
    np.testing.assert_array_equal(single[1].numpy(), port[1][1].numpy())


def test_invalid_tails_and_all_invalid_problem():
    boxes, scores = _case(5, 4, 200)
    scores[0, 30:] = NEG  # fewer valid candidates than max_out
    scores[1, 150:] = NEG
    scores[2] = NEG  # nothing valid at all
    ref = pallas_nms.nms_batched_pallas(jnp.asarray(boxes), jnp.asarray(scores), 0.5, 60)
    port = tnms.nms_multi(torch.from_numpy(boxes), torch.from_numpy(scores), 0.5, 60)
    _assert_equal(port, ref)
    assert not port[1][2].any() and not port[0][2].any()
    assert not port[1][0, 30:].any()


@pytest.mark.parametrize("k", [77, 129])
def test_k_not_multiple_of_128(k):
    boxes, scores = _case(6, 1, k)
    scores[0, 40:] = NEG
    ref = pallas_nms.nms_fixed_pallas(jnp.asarray(boxes[0]), jnp.asarray(scores[0]), 0.5, 60)
    port = tnms.nms_fixed(torch.from_numpy(boxes[0]), torch.from_numpy(scores[0]), 0.5, 60)
    _assert_equal(port, ref)


def test_exact_score_ties_pick_the_first_index():
    boxes, scores = _case(7, 2, 260, tie_step=0.1)
    ref = pallas_nms.nms_batched_pallas(jnp.asarray(boxes), jnp.asarray(scores), 0.5, 50)
    port = tnms.nms_multi(torch.from_numpy(boxes), torch.from_numpy(scores), 0.5, 50)
    _assert_equal(port, ref)



@pytest.mark.parametrize("n,k,max_out", [(0, 50, 10), (2, 50, 0), (2, 0, 10)])
def test_empty_problems(n, k, max_out):
    """No problems, no output slots or no candidates: (N, max_out) outputs,
    nothing valid, idx 0."""
    boxes, scores = _case(8, n, k)
    idx, valid = tnms.nms_multi(torch.from_numpy(boxes), torch.from_numpy(scores), 0.5, max_out)
    assert idx.shape == valid.shape == (n, max_out)
    assert idx.dtype == torch.int32 and valid.dtype == torch.bool
    assert not valid.any() and not idx.any()
