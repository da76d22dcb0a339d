"""The trace reader on events made by hand: the union of device
intervals, the idle gaps named by the CUDA runtime call that the host
was in at their middle, the host time around the device's work, and a
window whose kernel events differ from the launches counted refused."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from benchmark.lib import trace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def ev(name, a, b, dev=CPU, thread=1):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=a, end=b),
                           device_type=dev, thread=thread)


def window_events():
    return [
        ev("cudaLaunchKernel", 290.0, 300.0),
        ev("cudaStreamSynchronize", 400.0, 900.0),
        ev("cudaLaunchKernel", 590.0, 600.0),
        ev("void dt1d_axis2_kernel<false, 1>(...)", 300.0, 400.0, CUDA, 7),
        ev("void dt1d_axis2_kernel<true, 1>(...)", 350.0, 420.0, CUDA, 7),
        ev("conv3xtf32_grouped_kernel", 600.0, 700.0, CUDA, 7),
        ev("spin_kernel", 50.0, 90.0, CUDA, 7),
        ev("Memcpy DtoH", 1000.0, 1050.0, CUDA, 7),
    ]


def test_a_window_reads_busy_gaps_and_families():
    w = trace.read_window(window_events(), 2, {"dt1d": 2, "dt1d_aux": 1, "conv": 1}, 1e-3)
    assert w.wall_s == pytest.approx(1e-3)
    assert w.busy_s == pytest.approx((120 + 100 + 50) / 1e6)
    assert w.ops == 4
    assert w.family_s["conv"] == pytest.approx(1e-4)
    assert w.family_s["dt1d"] == pytest.approx(1.7e-4)
    gaps = dict(w.idle_gaps)
    # 420-600 at 510 inside the synchronize; 700-1000 at 850 inside it;
    # the device's work spans 300-1050 of a 1000-us request
    assert gaps["cudaStreamSynchronize"] == pytest.approx((180 + 300) * 1e-6)
    assert gaps["host before the first and after the last device op"] == \
        pytest.approx(250e-6)
    assert sum(gaps.values()) == pytest.approx(w.wall_s - w.busy_s)


def test_a_gap_outside_any_runtime_call_is_the_hosts():
    events = [e for e in window_events() if e.name != "cudaStreamSynchronize"]
    w = trace.read_window(events, 1, {"dt1d": 2, "dt1d_aux": 1, "conv": 1}, 1e-3)
    assert dict(w.idle_gaps)["host (python)"] == pytest.approx(480e-6)


@pytest.mark.parametrize("counted", [{"dt1d": 3, "dt1d_aux": 1, "conv": 1},
                                     {"dt1d": 2, "dt1d_aux": 1, "conv": 0},
                                     {"dt1d": 2, "dt1d_aux": 2, "conv": 1}])
def test_a_window_that_lost_or_gained_a_kernel_is_refused(counted):
    with pytest.raises(trace.IncompleteProfile):
        trace.read_window(window_events(), 1, counted, 1e-3)


def test_a_window_without_device_events_is_refused():
    with pytest.raises(trace.IncompleteProfile):
        trace.read_window([ev("cudaLaunchKernel", 1.0, 2.0)], 1, {}, 1e-3)
