"""The span reader (lib/spans.py) on spans and profiler events made by
hand: stage sums per image and their medians, device events attributed
by correlation id to the innermost span (each counted once, to a stage
or "outside"), the idle gaps named by span, and the unspanned share of
the idle time."""

from __future__ import annotations

import pytest

from benchmark.lib import spans
from benchmark.lib.spans import Event
from partsbaseddetector_tpu_torch.utils.profiling import Span

MS = 1_000_000


def tree():
    """detect 0-1000 ns: pyramid 100-300, dp 400-700, select 750-900."""
    return [Span("pyramid", 100, 300, 2, 1, 1, None), Span("dp", 400, 700, 3, 1, 1, None),
            Span("select", 750, 900, 4, 1, 1, None), Span("detect", 0, 1000, 1, None, 1, 1)]


def events():
    host = lambda name, a, b, c=0: Event(name, a, b, False, c)
    dev = lambda a, b, c: Event("kernel", a, b, True, c)
    return [
        host("cudaLaunchKernel", 120, 130, 11), dev(140, 200, 11),    # pyramid
        host("cudaLaunchKernel", 410, 420, 12), dev(430, 450, 12),    # dp
        host("cudaLaunchKernel", 420, 430, 13), dev(460, 470, 13),    # dp
        host("cudaStreamSynchronize", 600, 700),
        host("cudaMemcpyAsync", 760, 780, 14), dev(790, 800, 14),     # select
        host("cudaLaunchKernel", 950, 960, 15), dev(965, 990, 15),    # the root's
        host("cudaLaunchKernel", 1100, 1110, 16), dev(1120, 1130, 16),  # outside
        dev(1200, 1210, 99),                                           # no record
    ]


def test_device_events_go_to_the_innermost_span_that_issued_them():
    got = spans.stage_ops(events(), tree())
    assert got == {"pyramid": 1, "dp": 2, "select": 1, "detect": 1, "outside": 2}
    assert sum(got.values()) == sum(e.device for e in events())


def test_idle_gaps_are_named_by_span_and_runtime_call():
    got = spans.gap_labels(events(), tree())
    now = {k: pytest.approx(v) for k, v in got["now"]}
    # gaps 200-430 (mid in the root only), 450-460 and 470-790 (in dp,
    # the second in a synchronize), 800-965 (select), 990-1120 and
    # 1130-1200 (no span)
    assert now == {"detect": 230e-9, "dp": 10e-9, "dp / cudaStreamSynchronize": 320e-9,
                   "select": 165e-9, "host (python)": 200e-9}
    was = dict(got["was"])
    assert was["host (python)"] == pytest.approx(605e-9)
    assert sum(v for _, v in got["now"]) == pytest.approx(sum(was.values()))


def test_the_unspanned_share_is_idle_time_outside_every_stage():
    # 925 ns idle, of which 130 + 10 + 270 + 100 in a span below the root
    assert spans.unspanned_idle_share(events(), tree()) == pytest.approx(100 * 415 / 925)
    assert spans.unspanned_idle_share([e for e in events() if not e.device], tree()) is None


def requests():
    """Request 1 (2 images): pyramid 2 ms, dp 3 + 1 ms, in a 10-ms root;
    request 5 (1 image): pyramid 1 ms, dp 2 ms, in 4 ms; a worker's
    upload, a root without images, is no request."""
    return [Span("pyramid", 0, 2 * MS, 2, 1, 1, None), Span("dp", 2 * MS, 5 * MS, 3, 1, 1, None),
            Span("dp", 5 * MS, 6 * MS, 4, 1, 1, None),
            Span("detect_many", 0, 10 * MS, 1, None, 1, 2),
            Span("upload", 0, 9 * MS, 9, None, 9, None),
            Span("pyramid", 0, 1 * MS, 6, 5, 5, None), Span("dp", 1 * MS, 3 * MS, 7, 5, 5, None),
            Span("detect", 0, 4 * MS, 5, None, 5, 1)]


def test_stage_sums_are_per_image_and_the_reading_their_median():
    reqs = spans.per_request(requests())
    assert [r["root"].id for r in reqs] == [1, 5]
    assert reqs[0]["stage_ns"] == {"pyramid": 2 * MS, "dp": 4 * MS}
    # per image: request 1 dp 4 / 2 = 2 ms, request 5 2 ms; pyramid 1, 1
    assert spans.span_ms(reqs, ("dp",)) == pytest.approx(2.0)
    assert spans.span_ms(reqs, ("pyramid", "dp")) == pytest.approx(3.0)
    assert spans.span_ms(reqs, ("select",)) == 0.0
    assert spans.span_ms([], ("dp",)) is None
    # covered: 6 of 10 ms, 3 of 4 ms
    assert spans.coverage(reqs) == pytest.approx((0.6 + 0.75) / 2)


def test_a_reading_is_none_where_the_measurement_has_none(monkeypatch):
    from types import SimpleNamespace

    monkeypatch.setitem(spans._MEASURED, "cell.x", {"span_ms": {"dp": 2.5}})
    ctx = SimpleNamespace(cell="cell.x")
    assert spans.reading(ctx, "span_ms", "dp") == 2.5
    assert spans.reading(ctx, "layer_ops", "dp") is None
    monkeypatch.setitem(spans._MEASURED, "cell.y", None)
    assert spans.reading(SimpleNamespace(cell="cell.y"), "span_ms", "dp") is None


def test_the_seed_comes_from_the_runs_arguments(monkeypatch):
    monkeypatch.setattr(spans.sys, "argv", ["run.py", "--workload", "w", "--seed", "4700000001"])
    assert spans.run_seed() == 4700000001
    monkeypatch.setattr(spans.sys, "argv", ["run.py", "--workload", "w"])
    with pytest.raises(RuntimeError):
        spans.run_seed()
