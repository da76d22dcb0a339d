"""The inference pyramid's CUDA graph (ops/dp_graph.py::PyramidGraph).

On the CPU (tier 1): the gate. `root_scores` with a pyramid graph runs
the pyramid eagerly off the card, with trainable weights and with
autograd on, counts it `eager` and gives the same bits as without one.
With a stand-in graph (a capture that runs the function, a replay that
runs it again into the same tensors) the state machine runs here: a
shape's first call eager, its second captured, then replays, frames
that differ in turn each with their own answer; the capture reads only
the constants the graph took at its eager call; a uint8 and an f32 frame
of one size keep graphs of their own; the graph goes with its shape's
DP graph. `utils.pyramid_graph_counts()` sits beside
`dp_graph_counts()`.

On the card (marker `cuda`; without a device they skip):

    python -m pytest tests/test_torch_pyramid_graph.py -m cuda -q --noconftest

person26 at 480x640, one frame and a microbatch of 8, and face146's
interval-5 pyramid: the replayed features are the eager features bit for
bit, frames that differ in turn each their own; a replay after the
device constant caches were cleared gives the same bits; distribute_model
drops the graphs; the plain bf16 profile replays alike; a profiled
replayed detect holds the launch counters, and a shape is captured once
and replayed from then on (in a process of its own).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.lib import inputs, port
from partsbaseddetector_tpu_torch import PartsBasedDetector, pipeline, utils
from partsbaseddetector_tpu_torch.models.model import make_synthetic_model, pack_model, to_device
from partsbaseddetector_tpu_torch.ops import dp_graph, hog, resize
from partsbaseddetector_tpu_torch.ops.pyramid import build_pyramid_features
from partsbaseddetector_tpu_torch.train.sgd import model_params
from partsbaseddetector_tpu_torch.utils import dp_graph_counts, profiling, pyramid_graph_counts

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
VGA = (480, 640)
COUNT_KEYS = {"captures", "replays", "eager"}


def _model():
    return make_synthetic_model(nparts=6, nmix=3, sbin=4, interval=2, seed=8,
                                fsizes=[(5, 5), (3, 4), (4, 3)])


def _delta(before, counts=pyramid_graph_counts):
    return {k: v - before[k] for k, v in counts().items()}


def _frames(n, seed, hw=(64, 80)):
    rng = np.random.RandomState(seed)
    return [(rng.rand(*hw, 3) * 255).astype(np.uint8) for _ in range(n)]


def _same_features(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def _same_candidates(got, want):
    assert len(got) == len(want) > 0
    for x, y in zip(got, want):
        assert x.score == y.score and x.component == y.component
        np.testing.assert_array_equal(x.parts, y.parts)
        np.testing.assert_array_equal(x.mixtures, y.mixtures)


def _leaves(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _leaves(v)
    else:
        for v in obj:
            yield from _leaves(v)


class _Rerun:
    """A stand-in CUDA graph: the capture runs fn, and a replay runs it
    again and writes its results into the captured ones."""

    def __init__(self, fn):
        self.fn = fn
        self.out = fn()
        self.replays = 0

    def replay(self):
        self.replays += 1
        for dst, src in zip(_leaves(self.out), _leaves(self.fn())):
            dst.copy_(src)


def _rerun_capture(fn, device):
    g = _Rerun(fn)
    return g, g.out


def _on_card(monkeypatch):
    """Let the graphs engage on the CPU, with the stand-in capture."""
    monkeypatch.setattr(dp_graph, "_on_card", lambda t: True)
    monkeypatch.setattr(dp_graph, "cuda_capture", _rerun_capture)


# -- the CPU -------------------------------------------------------------------


def test_the_counters_sit_side_by_side_and_keep_their_keys():
    assert utils.pyramid_graph_counts is pyramid_graph_counts
    assert utils.dp_graph_counts is dp_graph_counts
    assert set(dp_graph_counts()) == COUNT_KEYS
    assert set(pyramid_graph_counts()) == COUNT_KEYS
    dp_before, pyr_before = dp_graph_counts(), pyramid_graph_counts()
    dp_graph.PyramidGraph().note_eager()
    assert _delta(pyr_before) == {"captures": 0, "replays": 0, "eager": 1}
    assert _delta(dp_before, dp_graph_counts) == {"captures": 0, "replays": 0, "eager": 0}


def test_root_scores_runs_the_pyramid_eager_off_the_gate_and_counts_it():
    model = _model()
    packed = pack_model(model)
    dm = to_device(packed, "cpu")
    plan = pipeline.make_plan(packed, (64, 80))
    im = torch.as_tensor(_frames(1, 0)[0])
    graph = dp_graph.PyramidGraph()
    params = model_params(model, device="cpu")
    before = pyramid_graph_counts()
    with torch.no_grad():
        want = pipeline.root_scores(im, packed, dm, plan)
        got = pipeline.root_scores(im, packed, dm, plan, pyramid_graph=graph)  # CPU frame
        pipeline.root_scores(im, packed, dm, plan, params=params, pyramid_graph=graph)
    pipeline.root_scores(im, packed, dm, plan, pyramid_graph=graph)  # autograd on
    assert _delta(before) == {"eager": 3, "captures": 0, "replays": 0}
    assert graph._graph is None and graph.consts == {}
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert torch.equal(g.rootv, w.rootv) and torch.equal(g.rooti, w.rooti)


def test_a_trainable_call_never_engages_the_pyramid_graph(monkeypatch):
    _on_card(monkeypatch)
    model = _model()
    packed = pack_model(model)
    dm = to_device(packed, "cpu")
    plan = pipeline.make_plan(packed, (64, 80))
    im = torch.as_tensor(_frames(1, 1)[0])
    params = model_params(model, device="cpu")
    graph = dp_graph.PyramidGraph()
    before = pyramid_graph_counts()
    for _ in range(3):
        with torch.no_grad():  # the bf16 miner's kind of call
            pipeline.root_scores(im, packed, dm, plan, params=params, pyramid_graph=graph)
        pipeline.root_scores(im, packed, dm, plan, params=params, pyramid_graph=graph)
    assert _delta(before) == {"eager": 6, "captures": 0, "replays": 0}
    assert graph._graph is None and not graph._warm
    with torch.no_grad():  # the gate holds: the same graph engages
        for _ in range(3):
            pipeline.root_scores(im, packed, dm, plan, pyramid_graph=graph)
    assert _delta(before) == {"eager": 7, "captures": 1, "replays": 1}


def test_a_shape_runs_the_pyramid_eager_then_captured_then_replayed(monkeypatch):
    _on_card(monkeypatch)
    model = _model()
    det = PartsBasedDetector(model, max_detections=16, buckets_per_octave=2, device="cpu")
    ref = PartsBasedDetector(model, max_detections=16, buckets_per_octave=2, device="cpu")
    frames = _frames(2, 3)
    with monkeypatch.context() as m:
        m.setattr(pipeline, "graphable", lambda *args: False)
        want = [ref.detect(f) for f in frames]
    before, dp_before = pyramid_graph_counts(), dp_graph_counts()
    for i in (0, 1, 0, 1, 1):
        _same_candidates(det.detect(frames[i]), want[i])
    assert _delta(before) == {"eager": 1, "captures": 1, "replays": 3}
    assert _delta(dp_before, dp_graph_counts) == {"eager": 1, "captures": 1, "replays": 3}
    (graphs,) = det._graphs.values()
    assert graphs.pyramid._graph.replays == 4  # the capture's own replay, then three
    det.distribute_model(model)
    assert det._graphs == {}


def test_the_capture_reads_only_the_graphs_own_constants(monkeypatch):
    """After the eager call, the module caches raise: the capture and
    the replays read every tap and constant from the graph's dict."""
    _on_card(monkeypatch)
    packed = pack_model(_model())
    plan = pipeline.make_plan(packed, (64, 80))
    spec = packed.spec
    a, b = (torch.as_tensor(np.stack(_frames(2, seed))) for seed in (4, 5))
    want = {id(x): build_pyramid_features(x.to(torch.float32), plan, spec) for x in (a, b)}
    graph = dp_graph.PyramidGraph()
    run = lambda ims: graph.run(
        [ims], lambda x: build_pyramid_features(x[0].to(torch.float32), plan, spec, graph.consts))
    _same_features(run(a), want[id(a)])  # eager: the constants are taken
    # resize and reduce taps (float64), tent taps (f32), the orientation units
    fns = {key[0] for key in graph.consts}
    assert fns == {resize.resize_matrix, resize.reduce_matrix, hog._hist_matrix,
                   hog._orientation_units}

    def evicted(*args):
        raise AssertionError("a captured pyramid read a module cache")

    monkeypatch.setattr(resize, "_device_taps", evicted)
    monkeypatch.setattr(resize, "_device_constant", evicted)
    before = pyramid_graph_counts()
    for x in (b, a, b):
        _same_features([f.clone() for f in run(x)], want[id(x)])
    assert _delta(before) == {"eager": 0, "captures": 1, "replays": 2}
    with pytest.raises(ValueError):
        run(a.to(torch.float32))  # another dtype than the captured frames'


def test_a_uint8_and_a_float_frame_keep_graphs_of_their_own(monkeypatch):
    _on_card(monkeypatch)
    model = _model()
    det = PartsBasedDetector(model, max_detections=16, buckets_per_octave=2, device="cpu")
    (frame,) = _frames(1, 6)
    want = det.detect(frame)
    before = pyramid_graph_counts()
    for im in (frame, frame.astype(np.float32), frame, frame.astype(np.float32)):
        _same_candidates(det.detect(im), want)
    assert [key[2] for key in det._graphs] == [torch.uint8, torch.float32]
    assert _delta(before) == {"eager": 1, "captures": 2, "replays": 1}


class _Inert:
    """A stand-in CUDA graph whose replay, like a real one, runs none of
    the captured function's Python."""

    def replay(self):
        pass


def test_any_graph_counts_the_launches_its_replays_make(monkeypatch):
    """A graph of any function, here one that launches K2 as
    conv_cuda's wrapper counts it: the eager call, the capture (which
    runs the wrapper and launches nothing) and a replay (which launches
    and runs no wrapper) count one conv launch each, as the card runs
    them."""
    for fam, n in profiling.hand_launches.items():
        monkeypatch.setitem(profiling.hand_launches, fam, n)
    monkeypatch.setattr(dp_graph, "cuda_capture", lambda fn, device: (_Inert(), fn()))

    def conv(inputs):
        profiling.hand_launches["conv"] += 1
        return [x + 1 for x in inputs]

    graph = dp_graph.ShapeGraph({"captures": 0, "replays": 0, "eager": 0})
    before = profiling.launch_counts()
    for _ in range(3):
        graph.run([torch.zeros(2, 3)], conv)
    assert graph.counts == {"captures": 1, "replays": 1, "eager": 1}
    assert profiling.launches_since(before) == dict.fromkeys(profiling.HAND_FAMILIES, 0) | {
        "conv": 3}


# -- the card ------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _cell_detector(name, device, seed=2**31 + 11, **overrides):
    """The benchmark's detector of a configuration, its frames at 480x640."""
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    g = inputs.generator(seed, device)
    arrays = inputs.model_arrays(cfg, g, device)
    return port.detector(cfg, arrays, device, **overrides)


def _vga(n, seed, device):
    rng = np.random.RandomState(seed)
    return torch.as_tensor((rng.rand(n, *VGA, 3) * 255).astype(np.uint8), device=device)


def _replays_equal_eager(det, batch, cuda, dtype=torch.float32, clear_caches=False):
    plan, spec = det._plan(VGA), det._packed.spec
    a, b = _vga(batch, 1, cuda), _vga(batch, 2, cuda)
    want = {id(x): build_pyramid_features(x.to(dtype), plan, spec) for x in (a, b)}
    graph = dp_graph.PyramidGraph()
    run = lambda ims: [f.clone() for f in graph.run(
        [ims], lambda x: build_pyramid_features(x[0].to(dtype), plan, spec, graph.consts))]
    before = pyramid_graph_counts()
    with torch.no_grad():
        # eager, captured, then replays of frames that differ in turn
        for x in (a, b, a, b):
            _same_features(run(x), want[id(x)])
        if clear_caches:
            resize._device_taps.cache_clear()
            resize._device_constant.cache_clear()
            torch.cuda.empty_cache()
            # fill what the caches freed, if anything of theirs was freed
            junk = [torch.full((1 << 24,), float("nan"), device=cuda) for _ in range(32)]
            for x in (b, a):
                _same_features(run(x), want[id(x)])
            del junk
    got = _delta(before)
    assert got == {"eager": 1, "captures": 1, "replays": 4 if clear_caches else 2}, got


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 8])
def test_the_replayed_pyramid_is_the_eager_pyramid_bit_for_bit(cuda, batch):
    _replays_equal_eager(_cell_detector("person26", cuda), batch, cuda)


@pytest.mark.cuda
def test_face146s_interval_5_pyramid_replays_bit_for_bit(cuda):
    det = _cell_detector("face146", cuda)
    assert det._packed.spec.interval == 5
    _replays_equal_eager(det, 1, cuda)


@pytest.mark.cuda
def test_a_replay_after_the_constant_caches_were_cleared_gives_the_same_bits(cuda):
    _replays_equal_eager(_cell_detector("person26", cuda), 1, cuda, clear_caches=True)


@pytest.mark.cuda
def test_distribute_model_drops_the_pyramid_graph(cuda, monkeypatch):
    det = PartsBasedDetector(_model(), buckets_per_octave=2, device=cuda)
    im = _vga(1, 5, cuda)[0].cpu().numpy()
    for _ in range(3):
        det.detect(im)
    other = make_synthetic_model(nparts=6, nmix=3, sbin=4, interval=2, seed=9,
                                 fsizes=[(5, 5), (3, 4), (4, 3)])
    det.distribute_model(other)
    assert det._graphs == {}
    before = pyramid_graph_counts()
    got = [det.detect(im) for _ in range(3)]
    assert _delta(before) == {"eager": 1, "captures": 1, "replays": 1}
    with monkeypatch.context() as m:
        m.setattr(pipeline, "graphable", lambda *args: False)
        want = PartsBasedDetector(other, buckets_per_octave=2, device=cuda).detect(im)
    for g in got:
        _same_candidates(g, want)


@pytest.mark.cuda
def test_the_plain_bf16_profile_replays_alike(cuda, monkeypatch):
    det = _cell_detector("person26", cuda, dtype=torch.bfloat16, rerank_fp32=False)
    _replays_equal_eager(det, 1, cuda, dtype=torch.bfloat16)
    frames = [x.cpu().numpy() for x in _vga(2, 6, cuda)]
    with monkeypatch.context() as m:
        m.setattr(pipeline, "graphable", lambda *args: False)
        want = [det.detect(f) for f in frames]
    before = pyramid_graph_counts()
    for i in (0, 1, 0, 1):
        _same_candidates(det.detect(frames[i]), want[i])
    assert _delta(before) == {"eager": 1, "captures": 1, "replays": 2}


_PROFILED_REPLAY = """
import json
from pathlib import Path
import numpy as np
from benchmark.lib import inputs, port
from partsbaseddetector_tpu_torch.utils.profiling import profiled, pyramid_graph_counts

cfg = json.loads(Path("benchmark/configs/person26.json").read_text())
arrays = inputs.model_arrays(cfg, inputs.generator(7, "cuda"), "cuda")
det = port.detector(cfg, arrays, "cuda")
im = (np.random.RandomState(7).rand(480, 640, 3) * 255).astype(np.uint8)
before = pyramid_graph_counts()
det.detect(im)
det.detect(im)
# the window raises unless its kernel events equal the counted launches
got = profiled(lambda: det.detect(im))
assert got["launches"]["dt1d"] > 0 and got["launches"]["conv"] > 0, got["launches"]
for _ in range(3):
    det.detect(im)
counted = pyramid_graph_counts()
delta = {k: counted[k] - before[k] for k in counted}
assert delta == {"eager": 1, "captures": 1, "replays": 4}, delta
"""


@pytest.mark.cuda
def test_a_profiled_replayed_detect_holds_the_launch_counters(cuda):
    """In a process of its own, as tests/test_torch_dp_graph.py's: one
    eager call, one capture, then replays, the profiled one among them."""
    root = str(Path(__file__).resolve().parents[1])
    env = dict(os.environ, PYTHONPATH=root)
    run = subprocess.run([sys.executable, "-c", _PROFILED_REPLAY], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stdout[-4000:] + run.stderr[-4000:]
