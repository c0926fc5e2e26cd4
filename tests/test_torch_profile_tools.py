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
