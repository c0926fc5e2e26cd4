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
from sad_tpu_torch.eval.rcnn_inference import make_rcnn_inference_fn
from sad_tpu_torch.ops import cls_loss_kernel, nms, nms_kernel, roi_align_kernel
from sad_tpu_torch.ops.cls_loss_kernel import ClsLossParams
from sad_tpu_torch.ops.fused_losses import (
    cls_losses_bwd_plain, cls_losses_fwd_plain, fused_cls_losses_raw,
)
from sad_tpu_torch.ops.proposals import map_rois_to_fpn_levels
from sad_tpu_torch.ops.roi_align import (
    multilevel_roi_align, multilevel_roi_align_bwd_plain, multilevel_roi_align_plain,
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


def _cls_inputs(dev, rows, groups, seed, c=80, offset=0, pt_near_zero=False):
    """offset > 0: x and pt are views `offset` floats into their buffers;
    pt_near_zero: pt log-uniform in [1e-6, 1e-3], else uniform in
    [0.001, 0.999]."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((rows * c + offset,), generator=gen, device=dev)[offset:].view(rows, c)
    x.mul_(3)
    x[: rows // 20] *= 40  # |x| > 90: the FLT_MIN clamp of log p
    pt = torch.rand((rows * c + offset,), generator=gen, device=dev)[offset:].view(rows, c)
    if pt_near_zero:
        pt.mul_(3.0 * np.log(10.0)).exp_().mul_(1e-6)
    else:
        pt.mul_(0.998).add_(0.001)
    labels = torch.randint(-1, c + 1, (rows,), generator=gen, device=dev, dtype=torch.int32)
    g = torch.rand((2, groups), generator=gen, device=dev) + 0.5
    return x, pt, labels, g[0].contiguous(), g[1].contiguous()


@pytest.mark.parametrize("rows,groups,params,c,offset,vec", [
    (8 * 40 * 64 * 9, 4, FLAGSHIP, 80, 0, 4),  # P4 at bs 8
    (3 * 1013, 3, FLAGSHIP._replace(want_powsum=False), 80, 0, 4),
    (4099, 1, FLAGSHIP._replace(gamma_f=1.5, gamma_d=2.5, beta_d=0.5, ignored_label=5), 80, 0,
     4),
    (2 * 4001, 2, FLAGSHIP, 20, 0, 4),  # another width of 16-byte chunks
    (3 * 1001, 3, FLAGSHIP, 9, 0, 1),  # C % 4 != 0: the scalar instance
    (2 * 3001, 2, FLAGSHIP, 80, 1, 1),  # x, pt 4 bytes off 16: the scalar instance
    (2 * 3001, 2, FLAGSHIP._replace(gamma_f=1.5), 9, 1, 1),  # scalar and generic
])
def test_cls_loss_kernels_equal_plain_twin(cuda, rows, groups, params, c, offset, vec):
    """Sums within 1e-5 relative (the kernel sums in double, the twin in
    float); dx within 1e-5 * max|dx|; two runs give the same bits."""
    _check_cls_kernels(*_cls_inputs(cuda, rows, groups, rows, c, offset), groups, params, vec)


def test_cls_loss_kernels_pt_near_zero(cuda):
    """PowSum's MUFU ex2/lg2 err most where log2(pt) is large: the same
    limits with a trained teacher's background probabilities."""
    _check_cls_kernels(*_cls_inputs(cuda, 2 * 5000, 2, 7, pt_near_zero=True), 2, FLAGSHIP, 4)


def test_cls_loss_library_refuses_unaligned_16_byte_chunks(cuda):
    x, pt, labels, gf, gd = _cls_inputs(cuda, 2 * 301, 2, 3, offset=1)
    before = (cls_loss_kernel.fwd_launches, cls_loss_kernel.bwd_launches)
    with pytest.raises(RuntimeError, match="cudaError_t 1"):
        cls_loss_kernel._launch_fwd(x, pt, labels, 2, FLAGSHIP, 4, cls_loss_kernel.GAMMA2_POW)
    with pytest.raises(RuntimeError, match="cudaError_t 1"):
        cls_loss_kernel._launch_bwd(x, pt, labels, gf, gd, FLAGSHIP, 4, cls_loss_kernel.GAMMA2_POW)
    assert (cls_loss_kernel.fwd_launches, cls_loss_kernel.bwd_launches) == before


def _check_cls_kernels(x, pt, labels, gf, gd, groups, params, vec):
    c = x.shape[1]
    assert cls_loss_kernel.kernel_instance(c, x.data_ptr(), pt.data_ptr(), params)[0] == vec
    before = (cls_loss_kernel.fwd_launches, cls_loss_kernel.bwd_launches)
    sums = cls_loss_kernel.cls_losses_fwd(x, pt, labels, groups, params)
    dx = cls_loss_kernel.cls_losses_bwd(x, pt, labels, gf, gd, params)
    assert (cls_loss_kernel.fwd_launches, cls_loss_kernel.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    ref = cls_losses_fwd_plain(x, pt, labels, groups, params)
    dref = cls_losses_bwd_plain(x, pt, labels, gf, gd, params)
    assert torch.all((sums - ref).abs() <= 1e-5 * ref.abs())
    assert float((dx - dref).abs().max()) <= 1e-5 * float(dref.abs().max())
    assert torch.equal(sums, cls_loss_kernel.cls_losses_fwd(x, pt, labels, groups, params))
    assert torch.equal(dx, cls_loss_kernel.cls_losses_bwd(x, pt, labels, gf, gd, params))


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


def _roi_case(dev, seed, batch, canvas, c, r, dtype):
    rng = np.random.RandomState(seed)
    ch, cw = canvas
    feats = {l: torch.from_numpy(rng.randn(batch, ch >> l, cw >> l, c).astype(np.float32))
             .to(dev, dtype) for l in (2, 3, 4, 5)}
    xy = rng.uniform(-10, [cw * 0.9, ch * 0.9], (r, 2))
    wh = np.exp(rng.uniform(np.log(2.0), np.log(ch), (r, 2)))
    rois = np.concatenate([np.sort(rng.randint(0, batch, r))[:, None], xy, xy + wh], axis=1)
    rois[0, 1:] = [10, 10, 10, 10]
    rois[1, 1:] = [-900, -900, -800, -800]
    rois = torch.from_numpy(rois.astype(np.float32)).to(dev)
    valid = torch.from_numpy(rng.uniform(size=r) > 0.15).to(dev)
    return feats, rois, map_rois_to_fpn_levels(rois[:, 1:], 2, 5), valid


@pytest.mark.parametrize("c,r,res,sr", [(256, 203, 7, 2), (64, 37, 14, 2), (3, 29, 7, 3),
                                         (20, 31, 14, 2), (1, 41, 28, 2), (256, 23, 28, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_roi_align_kernel_equals_plain_twin(cuda, c, r, res, sr, dtype):
    """float32 within 1e-5 * max|ref| + 1e-6; bfloat16 within one ulp (2^-7
    of the larger magnitude); and bit for bit, since the kernel adds the same
    products in the same order. The cases reach every instance: 16-byte
    vectors (C = 256, 64), one-lane scalars (C = 20, 3, 1), sr 2 fixed and
    sr 3 at run time, res 28 with rois over many bands."""
    feats, rois, levels, valid = _roi_case(cuda, c + r, 2, (256, 384), c, r, dtype)
    before = roi_align_kernel.launches
    got = multilevel_roi_align(feats, rois, levels, valid, res, sr)
    assert roi_align_kernel.launches == before + 1
    ref = multilevel_roi_align_plain(feats, rois, levels, valid, res, sr)
    assert got.dtype == dtype and tuple(got.shape) == (r, res, res, c)
    assert not bool(got[~valid].any())
    g, f = got.float(), ref.float()
    if dtype == torch.float32:
        assert float((g - f).abs().max()) <= 1e-5 * float(f.abs().max()) + 1e-6
    else:
        assert bool(((g - f).abs() <= 2.0 ** -7 * torch.maximum(g.abs(), f.abs())).all())
    assert torch.equal(got, ref)


def test_roi_align_on_cuda_is_differentiable_and_counts_no_empty_launch(cuda):
    feats, rois, levels, valid = _roi_case(cuda, 5, 1, (128, 192), 8, 11, torch.float32)
    feats = {l: f.requires_grad_(True) for l, f in feats.items()}
    rois = rois.requires_grad_(True)
    out = multilevel_roi_align(feats, rois, levels, valid, 7, 2)
    before = roi_align_kernel.bwd_launches
    out.sum().backward()
    assert roi_align_kernel.bwd_launches == before + 1
    assert rois.grad is None and all(f.grad is not None and f.grad.shape == f.shape
                                     for f in feats.values())
    before = roi_align_kernel.launches, roi_align_kernel.bwd_launches
    empty = multilevel_roi_align(feats, rois[:0], levels[:0], valid[:0], 7, 2)
    empty.sum().backward()
    assert tuple(empty.shape) == (0, 7, 7, 8)
    assert (roi_align_kernel.launches, roi_align_kernel.bwd_launches) == before


@pytest.mark.parametrize("c,r,res,sr", [(256, 203, 7, 2), (64, 37, 14, 2), (3, 29, 7, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_roi_align_bwd_kernel_within_tolerance_of_plain(cuda, c, r, res, sr, dtype):
    """float32 within 1e-5 * max|ref|; bfloat16 one ulp (2^-7 of the larger
    magnitude) more: the gather and the plain scatter add in other orders."""
    feats, rois, levels, valid = _roi_case(cuda, c + r + 1, 2, (256, 384), c, r, dtype)
    hw = {l: tuple(f.shape[1:3]) for l, f in feats.items()}
    g = torch.randn((r, res, res, c), device=cuda).to(dtype)
    before = roi_align_kernel.bwd_launches
    got = roi_align_kernel.roi_align_bwd_cuda(g, [hw[l] for l in sorted(hw)], 2, 2, rois,
                                              levels, valid, sr)
    assert roi_align_kernel.bwd_launches == before + 1
    ref = multilevel_roi_align_bwd_plain(g, hw, 2, rois, levels, valid, sr)
    ref_max = max(float(t.float().abs().max()) for t in ref.values())
    for k, l in enumerate(sorted(hw)):
        a, f = got[k].float(), ref[l].float()
        assert got[k].dtype == dtype and got[k].shape == feats[l].shape
        tol = 1e-5 * ref_max
        if dtype == torch.bfloat16:
            tol = tol + 2.0 ** -7 * torch.maximum(a.abs(), f.abs())
        assert bool(((a - f).abs() <= tol).all())


def test_roi_align_bwd_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    feats, rois, levels, valid = _roi_case(cuda, 7, 1, (128, 192), 8, 11, torch.float32)
    dims = [tuple(feats[l].shape[1:3]) for l in (2, 3, 4, 5)]
    g = torch.randn((11, 7, 7, 8), device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        roi_align_kernel.roi_align_bwd_cuda(g.double(), dims, 2, 1, rois, levels, valid, 2)
    with pytest.raises(TypeError, match="int32 levels"):
        roi_align_kernel.roi_align_bwd_cuda(g, dims, 2, 1, rois, levels.long(), valid, 2)
    with pytest.raises(ValueError, match="contiguous"):
        roi_align_kernel.roi_align_bwd_cuda(g.transpose(1, 2), dims, 2, 1, rois, levels, valid, 2)
    with pytest.raises(ValueError, match="one CUDA device"):
        roi_align_kernel.roi_align_bwd_cuda(g, dims, 2, 1, rois.cpu(), levels, valid, 2)
    with pytest.raises(ValueError, match="shapes"):
        roi_align_kernel.roi_align_bwd_cuda(g, dims, 2, 1, rois[:5], levels, valid, 2)


def test_roi_align_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    feats, rois, levels, valid = _roi_case(cuda, 6, 1, (128, 192), 8, 11, torch.float32)
    fl = [feats[l] for l in (2, 3, 4, 5)]
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        roi_align_kernel.roi_align_fwd_cuda([f.double() for f in fl], 2, rois, levels, valid, 7, 2)
    with pytest.raises(TypeError, match="int32 levels"):
        roi_align_kernel.roi_align_fwd_cuda(fl, 2, rois, levels.long(), valid, 7, 2)
    with pytest.raises(ValueError, match="contiguous"):
        roi_align_kernel.roi_align_fwd_cuda([f.transpose(1, 2) for f in fl], 2, rois, levels,
                                            valid, 7, 2)
    with pytest.raises(ValueError, match="one CUDA device"):
        roi_align_kernel.roi_align_fwd_cuda(fl, 2, rois.cpu(), levels, valid, 7, 2)
    with pytest.raises(ValueError, match="shared memory"):  # tap tables over the SM's room
        roi_align_kernel.roi_align_fwd_cuda(fl, 2, rois, levels, valid, 1, 3900)


@pytest.mark.parametrize("c", [1, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_roi_align_kernel_positions_that_fail_to_grow(cuda, c, dtype):
    """Rois past 2^19 cells on a map over 2^20 cells wide, where float
    rounding steps some roi's sample position back a cell: the kernel's
    two-slots-a-tap tables, bit-equal to the plain twin."""
    from sad_tpu_torch.ops.roi_align import roi_geometry

    rng = np.random.RandomState(11)
    w, r, res = 2**20 + 64, 48, 28
    feats = {2: torch.from_numpy(rng.randn(1, 2, w, c).astype(np.float32)).to(cuda, dtype)}
    x1 = rng.uniform(2**21, 2**22, r)
    rois = torch.from_numpy(np.stack([np.zeros(r), x1, np.zeros(r), x1 + rng.uniform(0, 12, r),
                                      np.full(r, 6.0)], axis=1).astype(np.float32)).to(cuda)
    levels = torch.full((r,), 2, dtype=torch.int32, device=cuda)
    valid = torch.ones(r, dtype=torch.bool, device=cuda)
    xlo = roi_geometry([(2, w)], 2, 1, rois, levels, res, 2)[5][0].reshape(r, -1)
    assert bool((xlo[:, 1:] < xlo[:, :-1]).any())
    got = multilevel_roi_align(feats, rois, levels, valid, res, 2)
    assert torch.equal(got, multilevel_roi_align_plain(feats, rois, levels, valid, res, 2))


@pytest.mark.parametrize("n,k,max_out,thr", [(40, 1000, 1000, 0.7), (8, 80000, 100, 0.5)])
def test_nms_kernel_equals_plain_at_the_rcnn_shapes(cuda, n, k, max_out, thr):
    boxes, scores = _boxes(n + k, n, k, clusters=300)
    scores[-3:, int(k * 0.8):] = np.float32(-1e30)
    b, s = torch.from_numpy(boxes).to(cuda), torch.from_numpy(scores).to(cuda)
    idx, valid = nms.nms_multi(b, s, thr, max_out)
    ref = nms.nms_multi_plain(b, s, thr, max_out)
    assert torch.equal(idx, ref[0]) and torch.equal(valid, ref[1])


@pytest.mark.parametrize("case", ["all over the cap", "one over the cap", "signed zeros",
                                  "K = max_out"])
def test_nms_kernel_sorted_and_argmax_paths_equal_plain(cuda, case):
    """Problems over the sort's cap (nms_kernel.ORDER_CAP valid candidates)
    take the argmax loop, the others sort, mask and sweep; -0.0 and +0.0
    tie; K = max_out runs the sweep to the end of every list."""
    n, k, max_out, thr = {"all over the cap": (2, 9000, 100, 0.5),
                          "one over the cap": (3, 9000, 100, 0.5),
                          "signed zeros": (4, 3000, 300, 0.5),
                          "K = max_out": (6, 1500, 1500, 0.7)}[case]
    boxes, scores = _boxes(k + n, n, k, clusters=200)
    if case == "one over the cap":
        scores[1:, 3000:] = np.float32(-1e30)
    if case == "signed zeros":
        scores -= np.float32(0.5)
        pick = np.random.RandomState(k).uniform(size=scores.shape)
        scores[pick < 0.25] = np.float32(0.0)
        scores[pick > 0.75] = np.float32(-0.0)
    b, s = torch.from_numpy(boxes).to(cuda), torch.from_numpy(scores).to(cuda)
    idx, valid = nms.nms_multi(b, s, thr, max_out)
    ref = nms.nms_multi_plain(b, s, thr, max_out)
    assert torch.equal(idx, ref[0]) and torch.equal(valid, ref[1])


def test_roi_align_bwd_kernel_many_tiles_one_cell_and_two_runs(cuda):
    """The whole canvas on P5 and on P2 (every map tile of the image), 300
    rois on one cell, and two runs of the kernel bit-equal."""
    feats, rois, levels, valid = _roi_case(cuda, 11, 2, (256, 384), 64, 40, torch.float32)
    rois[2:6] = torch.tensor([[0, 0, 0, 383, 255], [1, 0, 0, 383, 255], [0, 0, 0, 383, 255],
                              [1, 100, 60, 101, 61]], dtype=torch.float32, device=cuda)
    levels[2:6] = torch.tensor([5, 5, 2, 2], dtype=torch.int32, device=cuda)
    valid[2:6] = True
    rois = torch.cat([rois, rois[5:6].repeat(300, 1)])
    levels = torch.cat([levels, levels[5:6].repeat(300)])
    valid = torch.cat([valid, valid[5:6].repeat(300)])
    hw = {l: tuple(f.shape[1:3]) for l, f in feats.items()}
    dims = [hw[l] for l in sorted(hw)]
    g = torch.randn((rois.shape[0], 7, 7, 64), device=cuda).abs()
    got = roi_align_kernel.roi_align_bwd_cuda(g, dims, 2, 2, rois, levels, valid, 2)
    again = roi_align_kernel.roi_align_bwd_cuda(g, dims, 2, 2, rois, levels, valid, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = multilevel_roi_align_bwd_plain(g, hw, 2, rois, levels, valid, 2)
    ref_max = max(float(t.abs().max()) for t in ref.values())
    for k, l in enumerate(sorted(hw)):
        assert float((got[k] - ref[l]).abs().max()) <= 1e-4 * ref_max


@pytest.mark.parametrize("mask", [False, True], ids=["faster", "mask"])
def test_small_rcnn_on_the_card_launches_both_kernels(cuda, mask):
    cfg = merge_cfg_from_dict(Config(), {
        "MODEL": {"TYPE": "generalized_rcnn", "NUM_CLASSES": 81, "FASTER_RCNN": True,
                  "MASK_ON": mask, "CONV_BODY": "FPN.add_fpn_ResNet50_conv5_body"},
        "RESNETS": {"CHANNEL_RATIO": 0.25},
        "FPN": {"FPN_ON": True, "MULTILEVEL_RPN": True, "MULTILEVEL_ROIS": True},
        "FAST_RCNN": {"ROI_XFORM_RESOLUTION": 7, "MLP_HEAD_DIM": 256},
        "MRCNN": {"RESOLUTION": 28, "ROI_XFORM_RESOLUTION": 14, "DIM_REDUCED": 64},
        "TEST": {"SCALES": (256,), "MAX_SIZE": 384, "NMS": 0.5, "RPN_PRE_NMS_TOP_N": 300,
                 "RPN_POST_NMS_TOP_N": 200},
    })
    model = create_model(cfg, cuda, torch.Generator(device=cuda).manual_seed(0)).to(torch.bfloat16)
    rng = np.random.RandomState(1)
    data = torch.from_numpy(rng.randint(0, 256, (2, 256, 384, 3), dtype=np.uint8)).to(cuda)
    content = torch.tensor([[256, 300], [200, 384]], dtype=torch.float32, device=cuda)
    scale = torch.tensor([1.0, 0.5], device=cuda)
    before = nms_kernel.launches, roi_align_kernel.launches
    dets = make_rcnn_inference_fn(cfg, model)(data, content / scale[:, None], scale, content)
    torch.cuda.synchronize()
    assert nms_kernel.launches == before[0] + 2
    assert roi_align_kernel.launches == before[1] + (2 if mask else 1)
    assert tuple(dets["boxes"].shape) == (2, 100, 4) and bool(torch.isfinite(dets["boxes"]).all())
    if mask:
        assert tuple(dets["mask_prob"].shape) == (2, 100, 28, 28, 81)
        assert bool(torch.isfinite(dets["mask_prob"]).all())


@pytest.mark.parametrize("mask", [False, True], ids=["faster", "mask"])
def test_small_rcnn_train_step_on_the_card_launches_the_kernels(cuda, mask):
    """Two steps of a quarter-width R-CNN on the card: one NMS, one (Faster)
    or three (Mask: box, mask, target crop) RoIAlign forward and one or two
    backward launches a step; finite losses; parameters move."""
    from sad_tpu_torch.tools.profile_train import seeded_rcnn_train_step

    yaml = f"sad_tpu_torch/configs/e2e_{'mask' if mask else 'faster'}_rcnn_R-50-FPN.yaml"
    run = seeded_rcnn_train_step(yaml, seed=1, n_groups=1, device=cuda, opts=[
        "RESNETS.CHANNEL_RATIO", "0.25", "TRAIN.SCALES", "(256,)", "TRAIN.MAX_SIZE", "384",
        "TEST.SCALES", "(256,)", "TEST.MAX_SIZE", "384", "FAST_RCNN.MLP_HEAD_DIM", "256",
        "MRCNN.DIM_REDUCED", "64", "TRAIN.BATCH_SIZE_PER_IM", "128"])
    snap = {n: p.detach().clone() for n, p in run.model.named_parameters()}
    before = (nms_kernel.launches, roi_align_kernel.launches, roi_align_kernel.bwd_launches)
    for _ in range(2):
        m = run.step(run.state, run.batch, 1e-4)
    torch.cuda.synchronize()
    after = (nms_kernel.launches, roi_align_kernel.launches, roi_align_kernel.bwd_launches)
    want = (2, 6 if mask else 2, 4 if mask else 2)
    assert tuple(a - b for a, b in zip(after, before)) == want
    assert all(bool(torch.isfinite(v)) for v in m.values()) and ("loss_mask" in m) == mask
    names = set(run.step.names)
    params = dict(run.model.named_parameters())
    assert any(not torch.equal(params[n], snap[n]) for n in names)
    assert all(torch.equal(params[n], snap[n]) for n in params if n not in names)


class _SeededBatches:
    """Host batches of a training batch's kinds (uint8 canvas, int32 and
    float32 level dicts, bool masks, a plain number), each a function of its
    index."""

    def __init__(self):
        self.i = 0

    @staticmethod
    def batch(i):
        rng = np.random.RandomState(i)
        return {"data_u8": rng.randint(0, 256, (4, 320, 512, 3)).astype(np.uint8),
                "labels": {3: rng.randint(-1, 81, (4, 40, 64, 9)).astype(np.int32)},
                "bbox_targets": {3: rng.randn(4, 40, 64, 9, 4).astype(np.float32)},
                "fg_mask": {3: rng.uniform(size=(4, 40, 64, 9)) < 0.2},
                "gt_mask_stride": 4}

    def get_next_batch(self, timeout=None):
        self.i += 1
        return self.batch(self.i - 1)

    def queue_depth(self):
        return 0

    def shutdown(self):
        pass


def test_device_prefetcher_copies_equal_synchronous_copies(cuda):
    """50 batches through DevicePrefetcher's pinned non_blocking copies on
    its side stream equal the same arrays copied synchronously, while a
    long kernel runs on the default stream between gets and the comparison
    of each batch waits behind it (so the next copies overlap the use of the
    last batch, and its memory is freed while still in use)."""
    from sad_tpu_torch.data.loader import DevicePrefetcher

    feed = DevicePrefetcher(_SeededBatches(), cuda)
    busy = torch.randn((4096, 4096), device=cuda)
    equal = []
    try:
        for i in range(50):
            got = feed.get_next_batch(timeout=60)
            for _ in range(4):
                busy = torch.tanh(busy @ busy * 1e-3)
            want = _SeededBatches.batch(i)
            flat = [(got["data_u8"], want["data_u8"])] + [
                (got[k][3], want[k][3]) for k in ("labels", "bbox_targets", "fg_mask")]
            assert got["gt_mask_stride"] == 4
            for g, w in flat:
                w = torch.from_numpy(w)
                assert g.device.type == "cuda" and g.dtype == w.dtype and g.shape == w.shape
                equal.append((g == w.to(cuda)).all())  # read when the queue gets there
            del got, flat
        equal = torch.stack(equal).cpu()
    finally:
        feed.shutdown()
    assert bool(equal.all()) and len(equal) == 200
    assert len(feed.copy_seconds) >= 50


def test_mask_class_gather_and_paste_on_the_card_equal_the_cpus(cuda):
    """run_inference_on_roidb gathers each kept detection's own class
    channel of a bf16 mask_prob where it lies, then pastes on the host: the
    card's gather gives the CPU's values, so the same pasted masks and RLE."""
    from sad_tpu_torch.eval.test_engine import gather_class_masks
    from sad_tpu_torch.utils.segms import mask_to_rle, paste_mask_into_image

    gen = torch.Generator().manual_seed(0)
    mask_prob = torch.rand((2, 100, 28, 28, 81), generator=gen).to(torch.bfloat16)
    classes = torch.randint(0, 81, (2, 100), generator=gen, dtype=torch.int32)
    got = gather_class_masks(mask_prob.to(cuda), classes.to(cuda)).cpu()
    want = gather_class_masks(mask_prob, classes)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    rng = np.random.RandomState(1)
    for j in range(2):
        for k in range(0, 100, 7):
            x1, y1 = rng.uniform(0, 500, 2)
            box = np.array([x1, y1, x1 + rng.uniform(1, 300), y1 + rng.uniform(1, 300)],
                           np.float32)
            a = paste_mask_into_image(got[j, k].numpy(), box, 600, 800, 0.5)
            b = paste_mask_into_image(want[j, k].numpy(), box, 600, 800, 0.5)
            assert np.array_equal(a, b) and mask_to_rle(a) == mask_to_rle(b)


def test_init_distributed_world_one_on_nccl(cuda, tmp_path):
    """The training code's default on the card: a world of 1 over NCCL on
    cuda:LOCAL_RANK; the gradient all-reduce returns its input at once and
    the metrics all-reduce is the identity."""
    from sad_tpu_torch.parallel import distributed as pd

    info = pd.init_distributed(0, 1, 0, init_method="file://" + str(tmp_path / "store"))
    try:
        assert (info.rank, info.world, info.backend) == (0, 1, "nccl")
        assert pd.rank_device("cuda") == torch.device("cuda", 0)
        grads = [torch.ones(3, device=cuda)]
        assert pd.all_reduce_grads(grads)[0] is grads[0]
        vec = torch.tensor([1.0, 2.0], device=cuda)
        assert torch.equal(pd.all_reduce_metrics(vec, ["loss", "distill_normalizer"]), vec)
        pd.barrier()
    finally:
        pd.destroy()
    assert pd.current().world == 1


def test_a_named_backend_that_is_missing_raises_on_the_card(cuda, tmp_path):
    from sad_tpu_torch.parallel import distributed as pd

    with pytest.raises(RuntimeError, match="not available"):
        pd.init_distributed(0, 1, 0, backend="no_such_backend",
                            init_method="file://" + str(tmp_path / "store"))
    assert pd.current().world == 1


def test_queued_ms_reads_the_profilers_kernel_time_and_refuses_a_synchronising_fn(cuda):
    """profile_infer.queued_ms (CUDA events around calls queued behind a spin
    kernel) agrees with torch.profiler's kernel time of a matmul, and raises
    when fn synchronises, so the hold ends before the calls are enqueued."""
    from sad_tpu_torch.tools.profile_infer import device_ms, queued_ms

    a = torch.randn(4096, 4096, device=cuda)
    queued = queued_ms(lambda: a @ a, 20, 3)
    profiled = sum(device_ms(lambda: a @ a, 20, 3).values())
    assert queued == pytest.approx(profiled, rel=0.15)
    with pytest.raises(RuntimeError, match="hold"):
        queued_ms(lambda: (a @ a).sum().item(), 5, 1, hold_cycles=1_000_000)
