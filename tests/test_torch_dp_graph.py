"""The inference DP's CUDA graph (ops/dp_graph.py) on the card. Every
test here needs a CUDA device: without one it skips. On the card, run

    python -m pytest tests/test_torch_dp_graph.py -m cuda -q --noconftest

person26 at 480x640, one frame and a microbatch of 8, and Share-146's
13 trees (`benchmark/configs/face146.json`) at one frame: the replayed
DP gives the eager DP's root maps, root mixtures and pointer tables bit
for bit, with the same K1 and T2 launches, two each a level group, and
the detector's outputs and candidates too; frames that differ,
run in turn through one graph, each get their own answer (no stale
input); distribute_model drops the graph and the next detects use the
new weights; the hybrid bf16 profile and PBD_DT_WINDOW=1 replay alike;
a profiled window around a replayed detect holds the launch counters,
and a shape is captured once and replayed from then on (in a process of
its own, so that the card tests do not depend on their order).
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
from partsbaseddetector_tpu_torch import PartsBasedDetector, make_person_like_model, pipeline
from partsbaseddetector_tpu_torch.ops import dp_graph
from partsbaseddetector_tpu_torch.utils.profiling import dp_graph_counts, launch_counts

pytestmark = pytest.mark.cuda

VGA = (480, 640)
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _frames(n, seed):
    rng = np.random.RandomState(seed)
    return [(rng.rand(*VGA, 3) * 255).astype(np.uint8) for _ in range(n)]


def _eager(monkeypatch):
    """Make every DP of the block eager, as the graph's gate does off
    the card."""
    monkeypatch.setattr(pipeline, "graphable", lambda *args: False)


def _scores(det, ims, graph):
    """root_scores as the detector's _run calls it, cloned out of the
    graph's buffers: [(rootv, rooti, {p: table})] a (bucket, component)."""
    plan = det._plan(ims.shape[1:3])
    with torch.no_grad():
        got = pipeline.root_scores(
            ims, det._packed, det._dmodel, plan, engine=det.conv_engine,
            dtype=det.dtype, conv_dtype=det.wire_dtype, dp_graph=graph,
        )
    return [(s.rootv.clone(), s.rooti.clone(), {p: t.clone() for p, t in s.tables.items()})
            for s in got]


def _same_scores(got, want):
    assert len(got) == len(want) > 0
    for (gv, gi, gt), (wv, wi, wt) in zip(got, want):
        assert torch.equal(gv, wv) and torch.equal(gi, wi)
        assert gt.keys() == wt.keys() and all(torch.equal(gt[p], wt[p]) for p in gt)


def _same_candidates(got, want):
    assert len(got) == len(want) > 0
    for x, y in zip(got, want):
        assert x.score == y.score and x.component == y.component
        np.testing.assert_array_equal(x.parts, y.parts)
        np.testing.assert_array_equal(x.mixtures, y.mixtures)


def _face146(device):
    """The benchmark's Share-146 detector: 13 trees over one pool, 14 levels."""
    cfg = json.loads((ROOT / "benchmark" / "configs" / "face146.json").read_text())
    g = inputs.generator(4700000113, device)
    return port.detector(cfg, inputs.model_arrays(cfg, g, device), device)


@pytest.mark.parametrize("model,batch", [
    pytest.param("person", 1, id="1"), pytest.param("person", 8, id="8"),
    pytest.param("face146", 1, id="face146"),
])
def test_the_replayed_dp_is_the_eager_dp_bit_for_bit(cuda, model, batch, monkeypatch):
    """Every bucket's forest: root maps, mixtures and tables; and the K1
    and T2 launches, two each a level group, at every call alike."""
    if model == "face146":
        det = _face146(cuda)
    else:
        det = PartsBasedDetector(make_person_like_model(), buckets_per_octave=2, device=cuda)
    a, b = (torch.as_tensor(np.stack(_frames(batch, seed)), device=cuda) for seed in (1, 2))
    want = {}
    with monkeypatch.context() as m:
        _eager(m)
        for name, ims in (("a", a), ("b", b)):
            want[name] = _scores(det, ims, None)
    graph = dp_graph.DPGraph()
    before = dp_graph_counts()
    # eager, captured, then replays of frames that differ in turn
    launches = []
    for name, ims in (("a", a), ("b", b), ("a", a), ("b", b)):
        start = launch_counts()
        _same_scores(_scores(det, ims, graph), want[name])
        launches.append({k: n - start[k] for k, n in launch_counts().items()})
    got = dp_graph_counts()
    assert {k: got[k] - before[k] for k in got} == {"eager": 1, "captures": 1, "replays": 2}
    groups = graph.groups()
    nb = len(det._plan(VGA).buckets)
    if model == "face146":
        assert len(want["a"]) == 13 * nb and groups == 14 * nb
    assert all(c == launches[0] for c in launches), launches
    assert launches[0]["dt1d"] == launches[0]["transpose"] == 2 * groups
    assert launches[0]["dt1d_aux"] == groups


@pytest.mark.parametrize("batch", [1, 8])
def test_replayed_detects_give_the_eager_candidates(cuda, batch, monkeypatch):
    det = PartsBasedDetector(make_person_like_model(), buckets_per_octave=2, device=cuda)
    frames = [_frames(batch, seed) for seed in (3, 4)]
    if batch == 1:
        run = lambda fs: [det.detect(fs[0])]
    else:
        run = lambda fs: det.detect_many(fs, microbatch=batch)
    fn = det.detect_batch_fn(VGA, batch)
    outs = lambda fs: [t.clone() for t in fn(torch.as_tensor(np.stack(fs), device=cuda))]
    with monkeypatch.context() as m:
        _eager(m)
        want = [(run(fs), outs(fs)) for fs in frames]
    before = dp_graph_counts()
    for i in (0, 1, 0, 1, 1, 0):
        cands, tensors = run(frames[i]), outs(frames[i])
        for g, w in zip(cands, want[i][0]):
            _same_candidates(g, w)
        assert all(torch.equal(g, w) for g, w in zip(tensors, want[i][1]))
    got = dp_graph_counts()
    # detect and detect_batch_fn share one graph a shape
    assert {k: got[k] - before[k] for k in got} == {"eager": 1, "captures": 1, "replays": 10}


def test_distribute_model_drops_the_graph(cuda, monkeypatch):
    det = PartsBasedDetector(make_person_like_model(), buckets_per_octave=2, device=cuda)
    (im,) = _frames(1, 5)
    for _ in range(3):
        det.detect(im)
    other = make_person_like_model(seed=1)
    det.distribute_model(other)
    assert det._graphs == {}
    before = dp_graph_counts()
    got = [det.detect(im) for _ in range(3)]
    counted = dp_graph_counts()
    assert {k: counted[k] - before[k] for k in counted} == {
        "eager": 1, "captures": 1, "replays": 1}
    with monkeypatch.context() as m:
        _eager(m)
        want = PartsBasedDetector(other, buckets_per_octave=2, device=cuda).detect(im)
    for g in got:
        _same_candidates(g, want)


@pytest.mark.parametrize("profile", ["hybrid_bf16", "window"])
def test_the_hybrid_profile_and_the_window_dt_replay_alike(cuda, profile, monkeypatch):
    kw = {"dtype": torch.bfloat16} if profile == "hybrid_bf16" else {}
    if profile == "window":
        monkeypatch.setenv("PBD_DT_WINDOW", "1")
    det = PartsBasedDetector(make_person_like_model(), buckets_per_octave=2, device=cuda, **kw)
    frames = _frames(2, 6)
    with monkeypatch.context() as m:
        _eager(m)
        want = [det.detect(f) for f in frames]
    counts = []
    for i in (0, 1, 0, 1):
        before = launch_counts()
        _same_candidates(det.detect(frames[i]), want[i])
        counts.append({k: n - before[k] for k, n in launch_counts().items()})
    # a capture's and every replay's launches count as the eager call's
    assert all(c == counts[0] for c in counts)
    assert (counts[0]["dt1d_window"] > 0) == (profile == "window")


_PROFILED_REPLAY = """
import numpy as np
from partsbaseddetector_tpu_torch import PartsBasedDetector, make_person_like_model
from partsbaseddetector_tpu_torch.utils.profiling import dp_graph_counts, profiled

det = PartsBasedDetector(make_person_like_model(), buckets_per_octave=2, device="cuda")
im = (np.random.RandomState(7).rand(480, 640, 3) * 255).astype(np.uint8)
before = dp_graph_counts()
det.detect(im)
det.detect(im)
# the window raises unless its kernel events equal the counted launches
got = profiled(lambda: det.detect(im))
assert got["launches"]["dt1d"] > 0 and got["launches"]["transpose"] > 0, got["launches"]
for _ in range(3):
    det.detect(im)
counted = dp_graph_counts()
delta = {k: counted[k] - before[k] for k in counted}
assert delta == {"eager": 1, "captures": 1, "replays": 4}, delta
"""


def test_a_profiled_replayed_detect_holds_the_launch_counters(cuda):
    """In a process of its own: run in the process of the card tests,
    this window was followed by lone-launch profiler windows in
    test_torch_cuda.py that recorded no device event (torch.profiler's
    dropped records, PERF.md, open question 5). Out of it the card
    tests pass in one process in either order."""
    root = str(Path(__file__).resolve().parents[1])
    env = dict(os.environ, PYTHONPATH=root)
    run = subprocess.run([sys.executable, "-c", _PROFILED_REPLAY], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stdout[-4000:] + run.stderr[-4000:]
