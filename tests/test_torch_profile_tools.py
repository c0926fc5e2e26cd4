"""The arithmetic of ``tools/profile_infer.device_ms`` on the CPU: how a
profiler session's kernel records become ms a call when the profiler did
not record every launch (it runs on the card only; these are its numbers
by hand)."""

import pytest

from sad_tpu_torch.tools.profile_infer import DEVICE_MS_KEPT, kernel_ms_a_call


def test_every_launch_recorded_is_the_total_over_the_calls():
    ms, least = kernel_ms_a_call([("fwd", 50, 9000.0), ("sum", 50, 100.0)], 50, True)
    assert ms == pytest.approx({"fwd": 0.18, "sum": 0.002}) and least == 1.0


def test_missed_launches_take_the_mean_of_the_recorded_ones():
    # 47 of 50 recorded: the mean of the 47, not their total over 50
    ms, least = kernel_ms_a_call([("fwd", 47, 47 * 200.0)], 50, True)
    assert ms["fwd"] == pytest.approx(0.2) and least == pytest.approx(0.94)
    assert least >= DEVICE_MS_KEPT


@pytest.mark.parametrize("count, per_call", [(100, 2), (97, 2), (150, 3)])
def test_a_kernel_launched_k_times_a_call(count, per_call):
    ms, least = kernel_ms_a_call([("k", count, count * 10.0)], 50, True)
    assert ms["k"] == pytest.approx(per_call * 0.01)
    assert least == pytest.approx(count / (per_call * 50))


def test_a_named_kernel_mostly_missed_reads_below_the_floor():
    _, least = kernel_ms_a_call([("fwd", 10, 2000.0)], 50, True)
    assert least == pytest.approx(0.2) and least < DEVICE_MS_KEPT


def test_rare_kernels_spread_over_the_calls_and_count_no_share_unnamed():
    ms, least = kernel_ms_a_call([("conv", 50, 5000.0), ("init", 1, 300.0)], 50, False)
    assert ms == pytest.approx({"conv": 0.1, "init": 0.006}) and least == 1.0


def test_single_scale_stages_chain_to_the_served_result():
    """profile_infer's single-scale stages (C4 Mask: body, RPN head,
    candidates, RPN NMS, collect, RoIAlign, res5 head, decode, detection NMS,
    gather, the cascaded mask's RoIAlign and res5 head), run one after the
    other on the CPU, give make_rcnn_inference_fn's detections and masks bit
    for bit: the stage timers time the served path, stage by stage."""
    import numpy as np
    import torch

    import sad_tpu_torch.config as tcfg
    from sad_tpu_torch.config.config import merge_cfg_from_dict
    from sad_tpu_torch.eval.rcnn_inference import make_rcnn_inference_fn
    from sad_tpu_torch.models import create_model
    from sad_tpu_torch.tools.profile_infer import rcnn_stages

    over = {"MODEL": {"TYPE": "generalized_rcnn", "CONV_BODY": "ResNet.add_ResNet50_conv4_body",
                      "NUM_CLASSES": 4, "FASTER_RCNN": True, "MASK_ON": True},
            "RESNETS": {"CHANNEL_RATIO": 0.0625}, "RPN": {"SIZES": (32, 64)},
            "FAST_RCNN": {"ROI_BOX_HEAD": "ResNet.add_ResNet_roi_conv5_head",
                          "ROI_XFORM_RESOLUTION": 14},
            "MRCNN": {"ROI_MASK_HEAD": "mask_rcnn_heads.mask_rcnn_fcn_head_v0upshare",
                      "ROI_XFORM_RESOLUTION": 14, "RESOLUTION": 14, "DIM_REDUCED": 16},
            "TEST": {"RPN_PRE_NMS_TOP_N": 60, "RPN_POST_NMS_TOP_N": 12, "SCORE_THRESH": 0.0},
            "COMPUTE_DTYPE": "float32"}
    cfg = merge_cfg_from_dict(tcfg.Config(), over)
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model = create_model(cfg, "cpu", torch.Generator().manual_seed(0))
        rng = np.random.RandomState(0)
        x = (torch.from_numpy(rng.randint(0, 256, (2, 64, 96, 3)).astype(np.uint8)),
             torch.tensor([[64.0, 96.0], [50.0, 80.0]]), torch.tensor([1.0, 1.0]),
             torch.tensor([[64.0, 96.0], [50.0, 80.0]]))
        stages = rcnn_stages(cfg, model, x)
        names = [n for n, _ in stages]
        assert names == ["normalize", "body", "rpn_head", "candidates", "rpn_nms", "collect",
                         "roi_align", "res5_head", "decode", "detection_nms", "gather",
                         "cascaded_mask_roi_align", "cascaded_mask_res5_head", "count"]
        with torch.inference_mode():
            state, outs = None, {}
            for name, fn in stages:
                state = outs[name] = fn(state)
            served = make_rcnn_inference_fn(cfg, model)(*x)
        for k in ("boxes", "scores", "classes", "valid"):
            assert torch.equal(outs["gather"][k], served[k]), k
        assert torch.equal(outs["cascaded_mask_res5_head"].reshape(served["mask_prob"].shape),
                           served["mask_prob"])
        assert int(outs["count"]) > 0
    finally:
        torch.set_num_threads(prior)
