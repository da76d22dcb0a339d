"""The tree DP's per-shape plan and the CUDA graph's gate and counters
(ops/dp.py::dp_plan, ops/dp_graph.py), on the CPU.

The plan holds the live counts and consumer extents the DP computed on
every call before it (checked against that computation, written out
here), and tree_min_sum gives the same bits with a plan built once as
with one built per call. The graph engages only for CUDA maps, no
trainable weights and no autograd recording; every other DP call is
eager and counted so. With a stand-in graph (a capture that runs the
function, a replay that runs it again into the same tensors) the
detector's state machine runs here: a shape's first call eager, its
second captured, then replays, frames that differ in turn each with
their own answer; the detector keeps the graphs of the shapes it used
last and drops the others, a shape's pyramid graph with its DP graph; a
capture leaves the launch counters as they
were and a replay adds exactly what the capture counted.
"""

import numpy as np
import pytest
import torch

from partsbaseddetector_tpu_torch import PartsBasedDetector, pipeline
from partsbaseddetector_tpu_torch import detector as detector_mod
from partsbaseddetector_tpu_torch.models.model import make_synthetic_model, pack_model, to_device
from partsbaseddetector_tpu_torch.ops import dp as tdp
from partsbaseddetector_tpu_torch.ops import dp_graph
from partsbaseddetector_tpu_torch.train.sgd import model_params
from partsbaseddetector_tpu_torch.ops.pyramid import mask_responses, response_valid_extents
from partsbaseddetector_tpu_torch.utils import dp_graph_counts, pyramid_graph_counts
from partsbaseddetector_tpu_torch.utils.profiling import hand_launches, launch_counts


def _model(octave: bool):
    m = make_synthetic_model(nparts=6, nmix=3, sbin=4, interval=2, seed=8,
                             fsizes=[(5, 5), (3, 4), (4, 3)])
    if octave:
        for d in m.defid[0][2]:  # part 2 (and its subtree) one octave down
            m.anchors[int(d)][2] = 1
    return m


def _setup(octave: bool, batch: int = 2, seed: int = 0):
    packed = pack_model(_model(octave))
    dm = to_device(packed, "cpu")
    plan = pipeline.make_plan(packed, (64, 80))
    rng = np.random.RandomState(seed)
    resps, vhs, vws = [], [], []
    for bucket in plan.buckets:
        vh, vw = response_valid_extents(plan, bucket, packed.filter_sizes)
        r = torch.as_tensor(rng.randn(batch, len(bucket.scale_indices), bucket.resp_h,
                                      bucket.resp_w, packed.filters.shape[0]),
                            dtype=torch.float32)
        resps.append(mask_responses(r, vh, vw))
        vhs.append(vh)
        vws.append(vw)
    return packed, dm, resps, (vhs, vws)


def _counts_per_call(comp, resps, ext, b, p, hr_par):
    """The live counts and consumer extents as tree_min_sum computed
    them on every call before the plan (its live_counts)."""
    ds = comp.ds_total
    s = resps[b].shape[1]
    par = int(comp.parentid[p])
    bp, bpar = b - int(ds[p]), b - int(ds[par])
    w_child = resps[bp].shape[3]
    vh_sm = ext[0][bp][:s][:, comp.filterid[p]]
    vw_sm = ext[1][bp][:s][:, comp.filterid[p]]
    vh_par = ext[0][bpar][:s][:, comp.filterid[par]].max(axis=1)
    vw_par = ext[1][bpar][:s][:, comp.filterid[par]].max(axis=1)
    nvy = np.where(np.minimum(vw_sm, w_child) > 0, vh_sm, 0)
    nvx = np.where(np.minimum(vh_par, hr_par)[:, None] > 0, vw_sm, 0)
    ovy = np.where(np.arange(w_child)[None, None, :] < vw_sm[:, :, None],
                   vh_par[:, None, None], 0)
    ovx = np.where(np.arange(hr_par)[None, None, :] < vh_par[:, None, None],
                   vw_par[:, None, None], 0)
    return nvy, nvx, ovy, ovx


@pytest.mark.parametrize("octave", [False, True])
def test_the_plan_holds_the_per_call_counts_and_extents(octave):
    packed, dm, resps, ext = _setup(octave)
    comp = packed.components[0]
    b = len(resps) - 1
    plan = tdp.dp_plan(resps, comp, dm.components[0], ext, b)
    assert sorted(p for g in plan for p in g.parts) == list(range(1, comp.nparts))
    assert any(g.step == 2 for g in plan) == octave
    for g in plan:
        want = [np.stack(c)[:, None] for c in zip(*(
            _counts_per_call(comp, resps, ext, b, p, g.hr_par) for p in g.parts))]
        for got, w in zip((g.nv_y, g.nv_x, g.ov_y, g.ov_x), want):
            np.testing.assert_array_equal(got.numpy(), w)
        assert g.ov_y.dtype == torch.int32
        assert torch.equal(g.defw, dm.components[0].defw[g.pidx][:, None, None])
        assert torch.equal(g.shift_x, dm.components[0].shift_x[g.pidx][:, None, None])
    trained = tdp.dp_plan(resps, comp, dm.components[0], ext, b, trainable=True)
    assert all(g.defw is None and g.nv_y is None and g.ov_x is None for g in trained)


@pytest.mark.parametrize("octave", [False, True])
def test_tree_min_sum_with_a_plan_built_once_equals_a_plan_per_call(octave):
    packed, dm, resps, ext = _setup(octave)
    comp, dcomp = packed.components[0], dm.components[0]
    for b in range(comp.max_ds, len(resps)):
        plan = tdp.dp_plan(resps, comp, dcomp, ext, b)
        for seed in (1, 2):  # one plan, responses that differ
            _, _, rs, _ = _setup(octave, seed=seed)
            want = tdp.tree_min_sum(rs, comp, dcomp, ext, b)
            got = tdp.tree_min_sum(rs, comp, dcomp, ext, b, plan=plan)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            assert got[2].keys() == want[2].keys()
            assert all(torch.equal(got[2][p], want[2][p]) for p in got[2])


def test_the_gate_takes_cuda_maps_without_weights_or_autograd(monkeypatch):
    resps = [torch.zeros(1, 1, 2, 2, 1)]
    with torch.no_grad():
        assert not dp_graph.graphable(resps, False)  # CPU maps
    monkeypatch.setattr(dp_graph, "_on_card", lambda t: True)
    with torch.no_grad():
        assert dp_graph.graphable(resps, False)
        assert not dp_graph.graphable(resps, True)
    assert not dp_graph.graphable(resps, False)  # autograd on


def _leaves(obj):
    """The tensors of a nested result of lists, tuples and dicts, in order."""
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


def _delta(before, counts=dp_graph_counts):
    return {k: v - before[k] for k, v in counts().items()}


def test_root_scores_keeps_the_dp_eager_off_the_gate_and_counts_it():
    model = _model(False)
    packed = pack_model(model)
    dm = to_device(packed, "cpu")
    plan = pipeline.make_plan(packed, (64, 80))
    im = torch.as_tensor(np.random.RandomState(0).rand(64, 80, 3) * 255, dtype=torch.float32)
    graph = dp_graph.DPGraph()
    params = model_params(model, device="cpu")
    before = dp_graph_counts()
    with torch.no_grad():
        want = pipeline.root_scores(im, packed, dm, plan)
        got = pipeline.root_scores(im, packed, dm, plan, dp_graph=graph)  # CPU maps
        pipeline.root_scores(im, packed, dm, plan, params=params, dp_graph=graph)
    pipeline.root_scores(im, packed, dm, plan, dp_graph=graph)  # autograd on
    assert _delta(before) == {"eager": 3, "captures": 0, "replays": 0}
    assert graph._graph is None and len(graph.plans) == len(got)
    for g, w in zip(got, want):
        assert torch.equal(g.rootv, w.rootv) and torch.equal(g.rooti, w.rooti)


def test_a_shape_runs_eager_then_captured_then_replayed(monkeypatch):
    monkeypatch.setattr(dp_graph, "_on_card", lambda t: True)
    monkeypatch.setattr(dp_graph, "cuda_capture", _rerun_capture)
    model = _model(False)
    det = PartsBasedDetector(model, max_detections=16, buckets_per_octave=2, device="cpu")
    ref = PartsBasedDetector(model, max_detections=16, buckets_per_octave=2, device="cpu")
    rng = np.random.RandomState(1)
    frames = [(rng.rand(64, 80, 3) * 255).astype(np.uint8) for _ in range(2)]
    with monkeypatch.context() as m:
        m.setattr(pipeline, "graphable", lambda *args: False)
        want = [ref.detect(f) for f in frames]
    before = dp_graph_counts()
    for i in (0, 1, 0, 1, 1):
        got = det.detect(frames[i])
        assert len(got) == len(want[i]) > 0
        for g, w in zip(got, want[i]):
            assert g.score == w.score and g.component == w.component
            np.testing.assert_array_equal(g.parts, w.parts)
    assert _delta(before) == {"eager": 1, "captures": 1, "replays": 3}
    (graphs,) = det._graphs.values()
    assert graphs.dp._graph.replays == 4  # the capture's own replay, then three
    assert list(det._graphs) == [
        ((64, 80), 1, torch.uint8, torch.float32, "spatial", False)]
    det.distribute_model(model)
    assert det._graphs == {}


def test_the_detector_keeps_the_graphs_of_the_shapes_it_used_last(monkeypatch):
    monkeypatch.setattr(dp_graph, "_on_card", lambda t: True)
    monkeypatch.setattr(dp_graph, "cuda_capture", _rerun_capture)
    monkeypatch.setattr(detector_mod, "DP_GRAPHS_KEPT", 2)
    det = PartsBasedDetector(_model(False), max_detections=16, buckets_per_octave=2,
                             device="cpu")
    rng = np.random.RandomState(2)
    sizes = {"a": (64, 80), "b": (72, 88), "c": (80, 96)}
    frames = {k: (rng.rand(*hw, 3) * 255).astype(np.uint8) for k, hw in sizes.items()}
    before, pyr_before = dp_graph_counts(), pyramid_graph_counts()
    # a is captured at its second call; c drops b, b drops a, so a and b
    # start eager again
    for k in "abacba":
        assert len(det.detect(frames[k])) > 0
    assert _delta(before) == {"eager": 5, "captures": 1, "replays": 0}
    assert [key[0] for key in det._graphs] == [sizes["b"], sizes["a"]]
    det.detect(frames["b"])  # b used last: it stays, a goes when c comes
    det.detect(frames["c"])
    assert [key[0] for key in det._graphs] == [sizes["b"], sizes["c"]]
    assert _delta(before) == {"eager": 6, "captures": 2, "replays": 0}
    # a shape's pyramid graph goes and comes back with its DP graph
    assert _delta(pyr_before, pyramid_graph_counts) == _delta(before)


class _Inert:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_a_capture_takes_its_launches_off_the_counters_and_a_replay_adds_them(monkeypatch):
    for fam, n in hand_launches.items():
        monkeypatch.setitem(hand_launches, fam, n)

    def dp(resps):  # what the wrappers count while the DP is captured
        hand_launches["dt1d"] += 4
        hand_launches["dt1d_aux"] += 2
        hand_launches["dt1d_window"] += 3
        hand_launches["transpose"] += 5
        return [r + 1 for r in resps]

    monkeypatch.setattr(dp_graph, "cuda_capture", lambda fn, device: (_Inert(), fn()))
    graph = dp_graph.DPGraph()
    resps = [torch.zeros(2, 3)]
    base = launch_counts()
    graph.run(resps, dp)  # eager: its launches are real
    eager = launch_counts()
    assert {k: eager[k] - base[k] for k in base} == {
        "dt1d_window": 3, "dt1d_bwd": 0, "dt1d": 4, "dt1d_aux": 2, "conv": 0, "transpose": 5}
    graph._record(resps, dp)
    assert launch_counts() == eager
    for n in (1, 2):
        graph._replay(resps)
        got = launch_counts()
        assert {k: got[k] - eager[k] for k in got} == {
            "dt1d_window": 3 * n, "dt1d_bwd": 0, "dt1d": 4 * n, "dt1d_aux": 2 * n,
            "conv": 0, "transpose": 5 * n}
    assert graph._graph.replays == 2
    with pytest.raises(ValueError):
        graph._replay([torch.zeros(2, 4)])
