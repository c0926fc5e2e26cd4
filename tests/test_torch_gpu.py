"""Tests of the port that need the card: the CUDA kernels have no CPU mode.
They skip with a reason where torch.cuda.is_available() is False, and run
on the card with `python -m pytest -q -m gpu tests/test_torch_gpu.py`. This
file imports no jax, so it also runs where only PyTorch is installed."""

import numpy as np
import pytest
import torch

from sad_tpu.config.config import Config, merge_cfg_from_dict
from sad_tpu_torch.eval.inference import (
    decode_candidates, device_normalize, gather_detections, make_inference_fn,
)
from sad_tpu_torch.models import create_model
from sad_tpu_torch.ops import nms, nms_kernel

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the NMS kernel has no CPU mode")
    return torch.device("cuda")


def _boxes(seed, n, k, clusters=60):
    rng = np.random.RandomState(seed)
    centers = rng.uniform(0, [1024, 640], (n, clusters, 2))
    which = rng.randint(0, clusters, (n, k))
    xy = np.take_along_axis(centers, which[..., None], axis=1) + rng.uniform(-12, 12, (n, k, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(8, 120, (n, k, 2))], axis=-1)
    return boxes.astype(np.float32), rng.uniform(0, 1, (n, k)).astype(np.float32)


@pytest.mark.parametrize("n,k,thr", [(8, 5000, 0.5), (1, 1037, 0.3), (2, 20000, 0.7)])
def test_nms_kernel_equals_plain(cuda, n, k, thr):
    boxes, scores = _boxes(n * 7 + k, n, k)
    scores[0, k // 2:] = np.float32(-1e30)
    b, s = torch.from_numpy(boxes).to(cuda), torch.from_numpy(scores).to(cuda)
    before = nms_kernel.launches
    idx, valid = nms.nms_multi(b, s, thr, 100)
    assert nms_kernel.launches == before + 1
    ref = nms.nms_multi_plain(b, s, thr, 100)
    assert torch.equal(idx, ref[0]) and torch.equal(valid, ref[1])


def test_nms_kernel_counts_no_launch_for_empty_problems(cuda):
    before = nms_kernel.launches
    for n, max_out in ((0, 100), (2, 0)):
        idx, valid = nms_kernel.nms_cuda(torch.zeros((n, 16, 4), device=cuda),
                                         torch.zeros((n, 16), device=cuda), 0.5, max_out)
        assert idx.shape == valid.shape == (n, max_out)
    assert nms_kernel.launches == before


def test_nms_kernel_refuses_float64(cuda):
    b = torch.zeros((1, 8, 4), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        nms_kernel.nms_cuda(b, torch.zeros((1, 8), dtype=torch.float64, device=cuda), 0.5, 4)


def test_small_model_on_the_card_equals_plain_nms_decode(cuda):
    cfg = merge_cfg_from_dict(Config(), {
        "MODEL": {"TYPE": "retinanet", "NUM_CLASSES": 81,
                  "CONV_BODY": "FPN.add_fpn_ResNet50_conv5_body"},
        "RESNETS": {"CHANNEL_RATIO": 0.25},
        "FPN": {"FPN_ON": True, "RPN_MIN_LEVEL": 3, "RPN_MAX_LEVEL": 7,
                "EXTRA_CONV_LEVELS": True, "COARSEST_STRIDE": 128},
        "RETINANET": {"RETINANET_ON": True, "ASPECT_RATIOS": (1.0, 2.0, 0.5)},
        "TEST": {"SCALES": (256,), "MAX_SIZE": 384, "NMS": 0.5},
    })
    gen = torch.Generator(device=cuda).manual_seed(0)
    model = create_model(cfg, cuda, gen).to(torch.bfloat16)
    rng = np.random.RandomState(1)
    data = torch.from_numpy(rng.randint(0, 256, (2, 256, 384, 3), dtype=np.uint8)).to(cuda)
    content = torch.tensor([[256, 300], [200, 384]], dtype=torch.float32, device=cuda)
    scale = torch.tensor([1.0, 0.5], device=cuda)
    im_hw = content / scale[:, None]
    dets = make_inference_fn(cfg, model)(data, im_hw, scale, content)
    with torch.inference_mode():
        out = model(device_normalize(cfg, data, content))
        cands = decode_candidates(cfg, out, im_hw, scale)
        ref = gather_detections(cands, *nms.nms_multi_plain(*nms.offset_by_class(*cands), 0.5, 100))
    for key in ("boxes", "scores", "classes", "valid"):
        assert torch.equal(dets[key], ref[key]), key
    assert bool(dets["valid"].any())
