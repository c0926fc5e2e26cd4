"""Tests of the port that need the card: the CUDA kernels have no CPU mode.
They skip with a reason where torch.cuda.is_available() is False, and run
on the card with `python -m pytest -q -m gpu tests/test_torch_gpu.py`. This
file imports no jax, so it also runs where only PyTorch is installed."""

import numpy as np
import pytest
import torch

from sad_tpu_torch.config.config import Config, merge_cfg_from_dict
from sad_tpu_torch.eval.inference import (
    decode_candidates, device_normalize, gather_detections, make_inference_fn,
)
from sad_tpu_torch.models import create_model
from sad_tpu_torch.ops import cls_loss_kernel, nms, nms_kernel
from sad_tpu_torch.ops.cls_loss_kernel import ClsLossParams
from sad_tpu_torch.ops.fused_losses import (
    cls_losses_bwd_plain, cls_losses_fwd_plain, fused_cls_losses_raw,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
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


FLAGSHIP = ClsLossParams(2.0, 0.25, 2.0, 0.5, 0.0, -1, 1.8, True)


def _cls_inputs(dev, rows, groups, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((rows, 80), generator=gen, device=dev) * 3
    x[: rows // 20] *= 40  # |x| > 90: the FLT_MIN clamp of log p
    pt = torch.rand((rows, 80), generator=gen, device=dev) * 0.998 + 0.001
    labels = torch.randint(-1, 81, (rows,), generator=gen, device=dev, dtype=torch.int32)
    g = torch.rand((2, groups), generator=gen, device=dev) + 0.5
    return x, pt, labels, g[0].contiguous(), g[1].contiguous()


@pytest.mark.parametrize("rows,groups,params", [
    (8 * 40 * 64 * 9, 4, FLAGSHIP),  # P4 at bs 8
    (3 * 1013, 3, FLAGSHIP._replace(want_powsum=False)),
    (4099, 1, FLAGSHIP._replace(gamma_f=1.5, gamma_d=2.5, beta_d=0.5, ignored_label=5)),
])
def test_cls_loss_kernels_equal_plain_twin(cuda, rows, groups, params):
    """Sums within 1e-5 relative (the kernel sums in double, the twin in
    float); dx within 1e-5 * max|dx|."""
    x, pt, labels, gf, gd = _cls_inputs(cuda, rows, groups, rows)
    before = (cls_loss_kernel.fwd_launches, cls_loss_kernel.bwd_launches)
    sums = cls_loss_kernel.cls_losses_fwd(x, pt, labels, groups, params)
    dx = cls_loss_kernel.cls_losses_bwd(x, pt, labels, gf, gd, params)
    assert (cls_loss_kernel.fwd_launches, cls_loss_kernel.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    ref = cls_losses_fwd_plain(x, pt, labels, groups, params)
    dref = cls_losses_bwd_plain(x, pt, labels, gf, gd, params)
    assert torch.all((sums - ref).abs() <= 1e-5 * ref.abs())
    assert float((dx - dref).abs().max()) <= 1e-5 * float(dref.abs().max())


def test_fused_losses_on_cuda_launch_both_kernels(cuda):
    x, pt, labels, _, _ = _cls_inputs(cuda, 2 * 720, 2, 1)
    x.requires_grad_(True)
    before = (cls_loss_kernel.fwd_launches, cls_loss_kernel.bwd_launches)
    focal, distill, powsum = fused_cls_losses_raw(x, pt, labels, 2, FLAGSHIP)
    (focal.sum() + distill.sum()).backward()
    torch.cuda.synchronize()
    assert (cls_loss_kernel.fwd_launches, cls_loss_kernel.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())


def test_cls_loss_kernels_refuse_cpu_tensors(cuda):
    x, pt, labels, gf, gd = _cls_inputs(cuda, 64, 2, 2)
    with pytest.raises(ValueError, match="CUDA"):
        cls_loss_kernel.cls_losses_fwd(x.cpu(), pt, labels, 2, FLAGSHIP)
    with pytest.raises(ValueError, match="CUDA"):
        cls_loss_kernel.cls_losses_bwd(x, pt.cpu(), labels, gf, gd, FLAGSHIP)
    with pytest.raises(TypeError, match="float32"):
        cls_loss_kernel.cls_losses_fwd(x.double(), pt, labels, 2, FLAGSHIP)
