"""The port's stage spans (utils/profiling.py::span, recording) on the
CPU: their clock is torch.profiler's, a span with the recorder off is
one shared object that allocates nothing, and a detect, detect_many
(microbatch 1 and 2, and the pipelined path) and a capped recording
give one root per request, only the detect path's fixed names, children
inside their parents, one dp span per bucket and component, one request
id per request and a count of the spans dropped at the cap."""

import threading
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from partsbaseddetector_tpu_torch import PartsBasedDetector
from partsbaseddetector_tpu_torch.models.model import make_synthetic_model
from partsbaseddetector_tpu_torch.pipeline import root_scores
from partsbaseddetector_tpu_torch.utils import profiling
from partsbaseddetector_tpu_torch.utils.profiling import NO_SPAN, recording, span

ROOTS = {"detect", "detect_many", "detect_batch"}
STAGES = {"upload", "pyramid", "conv", "mask", "dp", "backtrack", "select", "pack",
          "readback", "assemble"}


@pytest.fixture(scope="module")
def det():
    model = make_synthetic_model(nparts=4, nmix=2, fsize=(5, 5), sbin=4, interval=4,
                                 thresh=-2.0, ncomponents=2, seed=3)
    return PartsBasedDetector(model, max_detections=16, buckets_per_octave=2, device="cpu")


@pytest.fixture(scope="module")
def frames():
    rng = np.random.RandomState(0)
    return [(rng.rand(120, 160, 3) * 255).astype(np.uint8) for _ in range(3)]


@pytest.fixture(scope="module")
def dp_per_image(det, frames):
    """The forests one image's root_scores runs: one a bucket, over its
    (bucket, component) pairs."""
    im = torch.as_tensor(frames[0])
    scores = root_scores(im, det._packed, det._dmodel, det._plan(im.shape[:2]))
    assert len(scores) == 2 * len({s.bucket_index for s in scores})
    return len({s.bucket_index for s in scores})


@pytest.fixture(scope="module")
def detects(det, frames):
    det.detect(frames[0])
    with recording() as rec:
        for im in frames[:2]:
            det.detect(im)
    return rec


def _check_tree(spans, root_names):
    """One request a root (with its images; a worker thread's span a
    root without), children inside their parents, no stage inside
    another stage, every span's request its root's id; returns the
    roots."""
    by_id = {s.id: s for s in spans}
    roots = [s for s in spans if s.parent is None]
    assert {s.name for s in roots} <= root_names
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is None:
            assert s.request == s.id and bool(s.images) == (s.name in ROOTS)
            continue
        parent = by_id[s.parent]
        assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns
        assert s.request == parent.request and s.images is None
        if s.name in STAGES:
            assert parent.name not in STAGES, (s.name, parent.name)
    return roots


def test_a_span_holds_a_torch_ops_profiler_times():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with recording() as rec:
            with span("op"):
                torch.ones(4) + 1
    (s,) = rec.spans
    kineto = prof.profiler.kineto_results
    (add,) = [e for e in kineto.events() if e.name() == "aten::add"]
    assert s.start_ns <= add.start_ns() <= add.end_ns() <= s.end_ns
    (fe,) = [e for e in prof.events() if e.name == "aten::add"]
    assert fe.time_range.start == pytest.approx(
        (add.start_ns() - kineto.trace_start_ns()) / 1e3, abs=1e-3)


def test_a_span_with_the_recorder_off_is_the_shared_no_op():
    assert span("dp") is NO_SPAN and span("detect", images=4) is NO_SPAN
    items = [None] * 2000

    def spans():
        for _ in items:
            with span("dp"):
                pass

    def calls():
        for _ in items:
            len("dp")

    spans()
    calls()
    peaks = []
    tracemalloc.start()
    try:
        for fn in (calls, spans):
            tracemalloc.reset_peak()
            base = tracemalloc.get_traced_memory()[0]
            fn()
            peaks.append(tracemalloc.get_traced_memory()[1] - base)
    finally:
        tracemalloc.stop()
    assert peaks[1] <= peaks[0], peaks


def test_a_detect_with_the_recorder_off_records_nothing(det, frames, monkeypatch):
    def refuse(*args):
        raise AssertionError("a span opened with the recorder off")

    monkeypatch.setattr(profiling, "_OpenSpan", refuse)
    assert det.detect(frames[0]) is not None


def test_a_detect_is_one_root(detects):
    roots = _check_tree(detects.spans, ROOTS)
    assert [(s.name, s.images) for s in roots] == [("detect", 1), ("detect", 1)]


def test_a_detect_has_only_the_fixed_names(detects):
    names = {s.name for s in detects.spans}
    assert names == {"detect"} | STAGES


def test_a_detects_spans_lie_inside_its_root(detects):
    for root in _check_tree(detects.spans, ROOTS):
        inside = [s for s in detects.spans if s.request == root.id]
        assert all(root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns for s in inside)


def test_a_detect_has_one_dp_span_a_bucket_and_component(detects, dp_per_image):
    """Off the card the DP runs eagerly, one `dp` span a bucket, over the
    forest of every component the bucket scores."""
    for root in _check_tree(detects.spans, ROOTS):
        dps = [s for s in detects.spans if s.request == root.id and s.name == "dp"]
        assert len(dps) == dp_per_image > 1


def test_a_detects_spans_carry_its_request_id(detects):
    roots = _check_tree(detects.spans, ROOTS)
    assert {s.request for s in detects.spans} == {r.id for r in roots}
    assert len({s.id for s in detects.spans}) == len(detects.spans)


def test_spans_past_the_cap_are_dropped_and_counted(det, frames, detects, monkeypatch):
    per_detect = len(detects.spans) // 2
    monkeypatch.setattr(profiling, "SPAN_CAP", 5)
    with recording() as rec:
        det.detect(frames[0])
    assert len(rec.spans) == 5 and rec.dropped == per_detect - 5
    assert rec.spans[-1].name == "detect"  # the newest are kept


@pytest.mark.parametrize("microbatch", [1, 2])
def test_detect_many_is_one_root_of_fixed_names(det, frames, dp_per_image, microbatch):
    det.detect_many(frames, microbatch=microbatch)
    with recording() as rec:
        det.detect_many(frames, microbatch=microbatch)
    (root,) = _check_tree(rec.spans, ROOTS)
    assert (root.name, root.images) == ("detect_many", 3)
    assert {s.name for s in rec.spans} <= ROOTS | STAGES
    # microbatch 1 runs each frame's program (through detect_batch);
    # microbatch 2 runs two stacks, the last padded
    runs = 3 if microbatch == 1 else 2
    assert sum(s.name == "dp" for s in rec.spans) == runs * dp_per_image
    assert sum(s.name == "pyramid" for s in rec.spans) == runs
    assert {s.request for s in rec.spans} == {root.id}


def test_the_pipelined_uploaders_spans_are_roots_of_their_own(det, frames):
    with recording() as rec:
        det.detect_many(frames, prefetch=2)
    roots = _check_tree(rec.spans, ROOTS | {"upload"})
    main = [s for s in roots if s.name == "detect_many"]
    assert len(main) == 1 and main[0].images == 3
    uploads = [s for s in roots if s.name == "upload"]
    assert len(uploads) == 3 and all(s.images is None for s in uploads)


def test_each_thread_keeps_its_own_stack_and_recordings_do_not_nest():
    def upload():
        with span("upload"):
            pass

    with recording() as rec:
        with span("detect", images=1):
            t = threading.Thread(target=upload)
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
            with span("dp"):
                pass
        with pytest.raises(RuntimeError):
            with recording():
                pass
    assert span("dp") is NO_SPAN
    by_name = {s.name: s for s in rec.spans}
    assert by_name["upload"].parent is None
    assert by_name["dp"].parent == by_name["detect"].id
