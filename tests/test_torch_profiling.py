"""The port's check that a profiled window is complete
(utils/profiling.py: device_profile's kernel-event counts per family,
launch_counts, require_launches, profiled), on synthetic profiler events
that carry the hand kernels' names as torch.profiler shows them on the
card, and on the CPU profiler with the launch registry moved by hand.
"""

import contextlib

import pytest
import torch

from partsbaseddetector_tpu_torch.utils import profiling

_DT_ARGS = ("(float const*, int const*, float const*, float const*, float const*, "
            "int const*, int const*, float*, int*, int, int, int, int, int)")
# the hand kernels' demangled names, and the family each counts in
# (K3 is K1's instance with aux: family dt1d, also counted as dt1d_aux)
NAMES = {
    "K1": ("void pbd_dt::dt1d_axis2_kernel<false, true, pbd_dt::dt1d_exact>"
           + _DT_ARGS, "dt1d"),
    "K3": ("void pbd_dt::dt1d_axis2_kernel<true, true, pbd_dt::dt1d_exact>"
           + _DT_ARGS, "dt1d"),
    "K5": ("void pbd_dt::dt1d_axis2_kernel<true, true, pbd_dt::dt1d_window>"
           + _DT_ARGS, "dt1d_window"),
    "K4": ("void (anonymous namespace)::dt1d_axis2_bwd_kernel<true, true>(float const*, "
           "float const*, int const*, float const*, float*, float*, float*, int, int, "
           "int, int, int)", "dt1d_bwd"),
    "K2": ("void pbd_conv::conv3xtf32_grouped_kernel<7>(pbd_conv::Groups)", "conv"),
    "T1": ("void pbd_conv::conv3xtf32_t1_kernel<8>(pbd_conv::Args)", "conv"),
    "T2": ("void (anonymous namespace)::transpose32_kernel(unsigned int const*, "
           "unsigned int*, unsigned int const*, unsigned int*, unsigned int, int, int, "
           "unsigned int, unsigned int)", "transpose"),
    "torch": ("void at::native::vectorized_elementwise_kernel<4, "
              "at::native::AddFunctor<float>>(int, AddFunctor<float>, "
              "std::array<char*, 3ul>)", "other"),
}


class _Event:
    def __init__(self, key, count, us):
        self.key, self.count, self.self_device_time_total = key, count, us
        self.device_type = torch.autograd.DeviceType.CUDA


class _Prof:
    def __init__(self, counts):
        self.events = [_Event(NAMES[k][0], n, 10.0 * n) for k, n in counts.items() if n]

    def key_averages(self):
        return self.events


# one window of a person26 detect's kernels and a train step's, as the
# wrappers count them: K1 and K3 both under dt1d
WINDOW = {"K1": 50, "K3": 50, "K5": 4, "K4": 6, "K2": 1, "T1": 2, "T2": 100, "torch": 7}
EXPECTED = {"dt1d": 100, "dt1d_aux": 50, "dt1d_window": 4, "dt1d_bwd": 6,
            "conv": 3, "transpose": 100}


@pytest.mark.parametrize("kernel", sorted(NAMES))
def test_each_kernel_name_maps_to_its_family(kernel):
    name, family = NAMES[kernel]
    assert profiling.kernel_family(name) == family
    assert profiling._has_aux(name) == (kernel in ("K3", "K5"))
    got = profiling.device_profile(_Prof({kernel: 3}))
    want = {k: 0 for k in EXPECTED}
    if family != "other":
        want[family] = 3
    want["dt1d_aux"] = 3 if kernel == "K3" else 0
    assert got["launches"] == want
    assert got["families"][family] == pytest.approx(0.03)


def test_a_complete_window_passes():
    got = profiling.device_profile(_Prof(WINDOW), per=2)
    assert got["launches"] == EXPECTED
    assert got["ops"] == sum(WINDOW.values()) / 2
    profiling.require_launches(got, EXPECTED)
    profiling.require_launches(got, {"conv": 3})  # families not named are not held


@pytest.mark.parametrize("family", sorted(EXPECTED))
def test_a_window_one_launch_short_raises_and_names_the_family(family):
    got = profiling.device_profile(_Prof(WINDOW))
    short = dict(EXPECTED, **{family: EXPECTED[family] + 1})
    with pytest.raises(RuntimeError, match=rf"incomplete profile: {family} recorded "
                       rf"{EXPECTED[family]} kernel events, the wrappers launched "
                       rf"{EXPECTED[family] + 1}"):
        profiling.require_launches(got, short)
    extra = dict(EXPECTED, **{family: EXPECTED[family] - 1})
    with pytest.raises(RuntimeError, match=rf"{family} recorded {EXPECTED[family]} "
                       "kernel events"):
        profiling.require_launches(got, extra)


def test_launch_counts_read_the_wrappers_counters(monkeypatch):
    """launch_counts() reads the registry the wrappers add to, in
    HAND_FAMILIES' order; add_launches moves it by a multiple of a
    reading."""
    for fam, n in (("dt1d", 9), ("dt1d_aux", 4), ("dt1d_bwd", 3), ("dt1d_window", 2),
                   ("conv", 6), ("transpose", 7)):
        monkeypatch.setitem(profiling.hand_launches, fam, n)
    before = profiling.launch_counts()
    assert before == {"dt1d": 9, "dt1d_aux": 4, "dt1d_bwd": 3, "dt1d_window": 2,
                      "conv": 6, "transpose": 7}
    assert tuple(before) == profiling.HAND_FAMILIES
    profiling.hand_launches["conv"] += 2  # a K2 and a T1 launch
    profiling.add_launches({"dt1d_aux": 1})
    assert profiling.launches_since(before) == {
        "dt1d": 0, "dt1d_aux": 1, "dt1d_bwd": 0, "dt1d_window": 0, "conv": 2,
        "transpose": 0}
    profiling.add_launches({"dt1d_aux": 1, "conv": 2}, -1)
    assert profiling.launch_counts() == before


def test_profiled_raises_on_launches_its_window_did_not_record(monkeypatch):
    """On the CPU the profiler records no kernel event: a window in
    which a wrapper counted a launch is short by it; one in which none
    counted passes. (The window is the CPU profiler's here: `window`
    opens with a kernel on the card.)"""

    @contextlib.contextmanager
    def cpu_window():
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            yield prof

    monkeypatch.setattr(profiling, "window", cpu_window)
    x = torch.ones(64)
    got = profiling.profiled(lambda: x.add(1), per=1)
    assert got["launches"]["transpose"] == 0

    def launch():
        profiling.hand_launches["transpose"] += 1
        x.add(1)

    monkeypatch.setitem(profiling.hand_launches, "transpose", 0)
    with pytest.raises(RuntimeError, match="incomplete profile: transpose recorded 0"):
        profiling.profiled(launch)


# window()'s opening kernel as torch.profiler names it on the card
OPENER = "at::cuda::(anonymous namespace)::spin_kernel(long)"


@pytest.mark.parametrize("per", [1, 3])
def test_the_windows_opening_kernel_is_left_out(per):
    """window() opens with torch.cuda._sleep's spin kernel; a window's
    busy time, ops, families and launches read as if it were not there."""
    assert profiling.OPENER in OPENER
    bare = profiling.device_profile(_Prof(WINDOW), per=per)
    prof = _Prof(WINDOW)
    prof.events.append(_Event(OPENER, 1, 5.0))
    got = profiling.device_profile(prof, per=per)
    assert got["busy"] == pytest.approx(bare["busy"])
    assert got["ops"] == bare["ops"] == sum(WINDOW.values()) / per
    assert got["families"] == pytest.approx(bare["families"])
    assert got["launches"] == bare["launches"] == EXPECTED
    assert "spin_kernel" not in got["top"]
