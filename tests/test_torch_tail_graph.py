"""The inference tail's CUDA graph (ops/dp_graph.py::TailGraph): the
backtrack walks of detector.py's `_run`, their concatenation and the
top-k select, on their walk plans (ops/dp.py::walk_plan).

On the CPU (tier 1): a walk with its plan gives the walk without one bit
for bit, and the plan holds the constants the walk would build, for
person26's one tree, face146's 13 trees of 68 and 39 parts over one
pool, and a model with an octave-offset tree beside a merged one (the
per-bucket `backtrack`). The gate: off the card the tail runs eagerly
and counts it. With a stand-in graph (a capture that runs the function,
a replay that runs it again into the same tensors) the state machine
runs here: eager at a shape's first call, captured with the DP at its
second, replayed after, reading the DP graph's results in place; the
outputs that serving holds past the next replay (detect_batch,
detect_many's microbatches and its pipelined path, detect_stream) keep
their values; the hybrid profile re-scores after the replay and the
part NMS runs after it. `utils.tail_graph_counts()` sits beside
`dp_graph_counts()`.

On the card (marker `cuda`; without a device they skip):

    python -m pytest tests/test_torch_tail_graph.py -m cuda -q --noconftest

person26 and face146 at 480x640: eager, captured and replayed detects
give the same outputs bit for bit, frames that differ in turn each their
own; a shape is captured once and replayed from then on; the tree and
launch counters of a call are the same whichever way it ran; and
detect_many (microbatch 8, and the pipelined microbatch-1 path holding
PACK results), detect_stream, the hybrid profile with its re-score and
the part NMS replay alike.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.lib import inputs, port
from partsbaseddetector_tpu_torch import PartsBasedDetector, detector as detector_mod, pipeline
from partsbaseddetector_tpu_torch import utils
from partsbaseddetector_tpu_torch.models.model import make_synthetic_model
from partsbaseddetector_tpu_torch.ops import dp as tdp
from partsbaseddetector_tpu_torch.ops import dp_graph
from partsbaseddetector_tpu_torch.utils.profiling import (
    dp_graph_counts, launch_counts, tail_graph_counts, tree_counts,
)

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
VGA = (480, 640)
SMALL = (48, 64)
SEED = 2**31 + 13
COUNT_KEYS = {"captures", "replays", "eager"}


def _delta(before, counts=tail_graph_counts):
    return {k: v - before[k] for k, v in counts().items()}


def _frames(n, seed, hw=(64, 80)):
    rng = np.random.RandomState(seed)
    return [(rng.rand(*hw, 3) * 255).astype(np.uint8) for _ in range(n)]


def _cell_detector(name, device, frame=SMALL, seed=SEED, **overrides):
    """The benchmark's detector of a configuration, and frames of its
    traffic at `frame` (h, w)."""
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cfg.update(frame_h=frame[0], frame_w=frame[1])
    g = inputs.generator(seed, device)
    det = port.detector(cfg, inputs.model_arrays(cfg, g, device), device, **overrides)
    return det, inputs.frames(cfg, 2, g, device)


def _two_trees(**kw):
    """Two trees of one model: tree 0 on the root grid (the merged walk),
    tree 1 with a subtree one octave finer (the per-bucket walk)."""
    m = make_synthetic_model(nparts=4, nmix=2, sbin=4, interval=2, seed=8,
                             ncomponents=2)
    for d in m.defid[1][2]:
        m.anchors[int(d)][2] = 1
    det = PartsBasedDetector(m, max_detections=24, device="cpu", **kw)
    assert [c.max_ds for c in det._packed.components] == [0, 1]
    return det


def _levels(comp):
    depth = [0] * comp.nparts
    for p in range(1, comp.nparts):
        depth[p] = depth[int(comp.parentid[p])] + 1
    return [[p for p in range(1, comp.nparts) if depth[p] == d]
            for d in range(1, max(depth) + 1)]


def _dp_groups(det, nb):
    """The DT groups of a detect over nb buckets: a bucket's distinct
    (depth, ds, parent's ds, step, mixtures) over the trees it scores
    (tree 1 from the second bucket: one octave finer there)."""
    keys = []
    for comp in det._packed.components:
        ds = comp.ds_total
        keys.append({(d + 1, int(ds[p]), int(ds[comp.parentid[p]]), int(comp.step[p]),
                      comp.maxmix) for d, level in enumerate(_levels(comp)) for p in level})
    return len(keys[0]) + (nb - 1) * len(keys[0] | keys[1])


def _same(got, want):
    if isinstance(got, torch.Tensor):
        assert got.dtype == want.dtype and torch.equal(got, want)
    else:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)


def _same_candidates(got, want):
    assert len(got) == len(want) > 0
    for x, y in zip(got, want):
        assert x.score == y.score and x.component == y.component
        np.testing.assert_array_equal(x.parts, y.parts)
        np.testing.assert_array_equal(x.mixtures, y.mixtures)


# -- the CPU -------------------------------------------------------------------


@pytest.mark.parametrize("case", ["person26", "face146", "octave"])
def test_a_walk_with_its_plan_is_the_walk_without_one(case):
    """Each walk of a batch of two frames, the detector's plan (from
    `_walks`) against the walk that builds its own, and the plan's
    constants against what the walk builds: the flat offsets, grids and
    scale rows of the buckets, the parts' table offsets by tree level,
    and the box scales in the maps' dtype."""
    torch.set_num_threads(4)
    if case == "octave":
        det, frames = _two_trees(), _frames(2, 1)
    else:
        det, frames = _cell_detector(case, "cpu")
    packed, dmodel = det._packed, det._dmodel
    ims = torch.as_tensor(np.stack(frames))
    plan = det._plan(ims.shape[1:3])
    with torch.no_grad():
        scores = pipeline.root_scores(ims, packed, dmodel, plan)
    walks = det._walks(scores, plan, dp_graph.TailGraph())
    kw = dict(box_off_x=-packed.spec.padx, box_off_y=-packed.spec.pady,
              thresh=packed.spec.thresh, max_det=det.max_detections)
    sizes = set()
    for c, lst, wplan in walks:
        comp, dcomp = packed.components[c], dmodel.components[c]
        sizes.add(comp.nparts)
        scales = [torch.as_tensor([plan.scales[s].box_scale
                                   for s in plan.buckets[bs.bucket_index].scale_indices],
                                  dtype=det.dtype) for bs in lst]
        rootvs = [bs.rootv for bs in lst]
        _same(wplan.images, torch.arange(2))
        _same(wplan.box_scales, torch.cat(scales).to(rootvs[0].dtype))
        if comp.max_ds == 0:
            assert [bs.bucket_index for bs in lst] == list(range(len(plan.buckets)))
            cells = [int(np.prod(rv.shape[1:])) for rv in rootvs]
            ntot = sum(cells)
            _same(wplan.offsets, torch.as_tensor(np.cumsum([0] + cells[:-1])))
            _same(wplan.heights, torch.as_tensor([rv.shape[2] for rv in rootvs]))
            _same(wplan.widths, torch.as_tensor([rv.shape[3] for rv in rootvs]))
            _same(wplan.scale_offsets,
                  torch.as_tensor(np.cumsum([0] + [rv.shape[1] for rv in rootvs[:-1]])))
            _same(wplan.parts, torch.arange(comp.nparts))
            _same(wplan.level_bases, [
                torch.as_tensor([(p - 1) * comp.maxmix * ntot for p in parts])[:, None, None]
                for parts in _levels(comp)])
            args = (rootvs, [bs.rooti for bs in lst], [bs.tables for bs in lst], comp, dcomp)
            got = tdp.backtrack_merged(*args, None, plan=wplan, **kw)
            want = tdp.backtrack_merged(*args, scales, **kw)
        else:
            assert wplan.offsets is None and wplan.level_bases is None
            (bs,) = lst
            args = (bs.rootv, bs.rooti, bs.tables, comp, dcomp)
            got = tdp.backtrack(*args, None, plan=wplan, **kw)
            want = tdp.backtrack(*args, scales[0], **kw)
        _same(got, want)
        assert torch.isfinite(got[1]).any()
    # the octave tree: one walk a bucket but the finest, beside the merged tree's
    assert len(walks) == {"person26": 1, "face146": 13, "octave": len(plan.buckets)}[case]
    assert sizes == {"person26": {26}, "face146": {68, 39}, "octave": {4}}[case]


def test_the_counters_sit_side_by_side_and_keep_their_keys():
    assert utils.tail_graph_counts is tail_graph_counts
    assert set(tail_graph_counts()) == COUNT_KEYS
    tail_before, dp_before = tail_graph_counts(), dp_graph_counts()
    dp_graph.TailGraph().note_eager()
    assert _delta(tail_before) == {"captures": 0, "replays": 0, "eager": 1}
    assert _delta(dp_before, dp_graph_counts) == {"captures": 0, "replays": 0, "eager": 0}
    assert dp_graph.ShapeGraphs.__slots__ == ("pyramid", "dp", "tail")


def test_off_the_card_the_tail_runs_eagerly_and_counts_it():
    det = _two_trees()
    (frame,) = _frames(1, 2)
    before = tail_graph_counts()
    got = [det.detect(frame) for _ in range(3)]
    assert _delta(before) == {"eager": 3, "captures": 0, "replays": 0}
    (graphs,) = det._graphs.values()
    assert graphs.tail._graph is None and not graphs.dp.graphed
    # built once: the merged walk's plan, one a bucket of the octave
    # tree's walks, the image rows
    nb = len(det._plan(frame.shape[:2]).buckets)
    assert len(graphs.tail.plans) == 1 + (nb - 1) + 1
    for g in got[1:]:
        _same_candidates(g, got[0])


class _Rerun:
    """A stand-in CUDA graph: the capture runs fn, and a replay runs it
    again and writes its results into the captured ones, as a real
    replay rewrites the graph's outputs."""

    def __init__(self, fn):
        self.fn = fn
        self.out = fn()

    def replay(self):
        for dst, src in zip(_leaves(self.out), _leaves(self.fn())):
            dst.copy_(src)


def _leaves(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _leaves(v)
    elif obj is not None:
        for v in obj:
            yield from _leaves(v)


def _rerun_capture(fn, device):
    g = _Rerun(fn)
    return g, g.out


def _on_card(monkeypatch):
    """Let the graphs engage on the CPU, with the stand-in capture."""
    monkeypatch.setattr(dp_graph, "_on_card", lambda t: True)
    monkeypatch.setattr(dp_graph, "cuda_capture", _rerun_capture)


def _eager(monkeypatch, run):
    """run() with every graph off, as off the card."""
    with monkeypatch.context() as m:
        m.setattr(pipeline, "graphable", lambda *a: False)
        return run()


def test_the_tail_is_captured_with_the_dp_and_replayed_after(monkeypatch):
    """Eager at a shape's first call (the DP's eager call), captured at
    its second (the DP's capture), replayed from the third, reading the
    DP graph's results in place; frames that differ in turn get their
    own answers; the tree counters count every call alike."""
    _on_card(monkeypatch)
    det, ref = _two_trees(), _two_trees()
    frames = _frames(2, 3)
    want = _eager(monkeypatch, lambda: [ref.detect(f) for f in frames])
    before, dp_before = tail_graph_counts(), dp_graph_counts()
    per_call = []
    for i in (0, 1, 0, 1, 1):
        trees = tree_counts()
        _same_candidates(det.detect(frames[i]), want[i])
        per_call.append({k: v - trees[k] for k, v in tree_counts().items()})
    assert _delta(before) == {"eager": 1, "captures": 1, "replays": 3}
    assert _delta(dp_before, dp_graph_counts) == {"eager": 1, "captures": 1, "replays": 3}
    nb = len(det._plan(frames[0].shape[:2]).buckets)
    assert all(c == per_call[0] for c in per_call)
    assert per_call[0] == {"images": 1, "dp_pairs": 2 * nb - 1,
                           "dp_groups": _dp_groups(det, nb), "walks": nb,
                           "tail_rows": nb * det.max_detections}
    (graphs,) = det._graphs.values()
    assert graphs.tail.graphed and graphs.dp.graphed
    # in place: the tail's inputs are the DP graph's own root maps
    assert len(graphs.tail._inputs) == len(graphs.dp._outputs) == 2 * nb - 1
    assert all(x is out[0] for x, out in zip(graphs.tail._inputs, graphs.dp._outputs))


def test_a_replay_reads_its_inputs_in_place_and_refuses_others(monkeypatch):
    _on_card(monkeypatch)
    graph = dp_graph.TailGraph()
    x = torch.arange(4.0)
    double = lambda inputs: inputs[0] * 2
    before = tail_graph_counts()
    out = graph.run([x], double)  # the DP's eager call warmed it: a capture
    assert graph._inputs[0] is x and torch.equal(out, x * 2)
    x.add_(1)
    assert graph.run([x], double) is out and torch.equal(out, x * 2)
    assert _delta(before) == {"eager": 0, "captures": 1, "replays": 1}
    with pytest.raises(ValueError):
        graph.run([x.clone()], double)


def test_outputs_held_past_the_next_replay_keep_their_values(monkeypatch):
    """A replay rewrites the graph's outputs: the serving paths that
    hold a call's outputs past the next call (detect_batch, detect_many
    pipelined and in microbatches, detect_stream) read back their own."""
    _on_card(monkeypatch)
    det, ref = _two_trees(), _two_trees()
    frames = _frames(detector_mod.PACK + 3, 4)
    want = _eager(monkeypatch, lambda: [ref.detect(f) for f in frames])
    want_mb = _eager(monkeypatch, lambda: ref.detect_many(frames, microbatch=4))
    runs = [
        (lambda: det.detect_batch(frames), want),
        (lambda: det.detect_many(frames, prefetch=2), want),
        (lambda: det.detect_many(frames, readback_top=8), want),
        (lambda: list(det.detect_stream(frames, lookahead=4, workers=0, readback_batch=2)),
         want),
        (lambda: det.detect_many(frames, microbatch=4), want_mb),
    ]
    before = tail_graph_counts()
    for run, answers in runs:
        got = run()
        assert len(got) == len(answers)
        for g, w in zip(got, answers):
            if len(w) > 8 and len(g) == 8:  # readback_top
                w = w[:8]
            _same_candidates(g, w)
    n, mb = len(frames), -(-len(frames) // 4)
    # per shape: one eager call, one capture, then replays
    assert _delta(before) == {"eager": 2, "captures": 2, "replays": 4 * n + mb - 4}


@pytest.mark.parametrize("profile", ["hybrid", "nms"])
def test_the_rescore_and_the_part_nms_run_after_the_replay(profile, monkeypatch):
    """The hybrid profile's tail graph holds the walks, and the re-score
    (which reads the conv's f32 responses) runs after it; the part NMS
    runs after the replayed select."""
    _on_card(monkeypatch)
    kw = {"dtype": torch.bfloat16} if profile == "hybrid" else {"nms_overlap": 0.3}
    det, ref = _two_trees(**kw), _two_trees(**kw)
    frames = _frames(2, 5)
    want = _eager(monkeypatch, lambda: [ref.detect(f) for f in frames])
    before = tail_graph_counts()
    for i in (0, 1, 0, 1):
        _same_candidates(det.detect(frames[i]), want[i])
    assert _delta(before) == {"eager": 1, "captures": 1, "replays": 2}


# -- the card ------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _vga(n, seed):
    rng = np.random.RandomState(seed)
    return [(rng.rand(*VGA, 3) * 255).astype(np.uint8) for _ in range(n)]


def _counted(run):
    """run()'s result, and the tree counters and hand-kernel launches
    the call added."""
    trees, launches = tree_counts(), launch_counts()
    got = run()
    return (got, {k: v - trees[k] for k, v in tree_counts().items()},
            {k: v - launches[k] for k, v in launch_counts().items()})


def _same_dense(got, want):
    for f in ("boxes", "scores", "components", "valid", "mixtures"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert want.valid.any()


def _replays_equal_eager(det, frames, monkeypatch):
    """Eager (every graph off), then the graphs' eager, captured and
    replayed calls over frames that differ in turn: the same dense
    outputs bit for bit, and the same counters a call."""
    want = _eager(monkeypatch, lambda: [_counted(lambda: det.detect_dense(f)) for f in frames])
    before = tail_graph_counts()
    for i in (0, 1, 0, 1):
        got, trees, launches = _counted(lambda: det.detect_dense(frames[i]))
        _same_dense(got, want[i][0])
        assert trees == want[i][1] and launches == want[i][2]
    assert _delta(before) == {"eager": 1, "captures": 1, "replays": 2}
    return want[0][1]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["person26", "face146"])
def test_replayed_tails_give_the_eager_outputs_bit_for_bit(cuda, name, monkeypatch):
    det, _ = _cell_detector(name, cuda, frame=VGA)
    trees = _replays_equal_eager(det, _vga(2, 1), monkeypatch)
    assert trees["walks"] == {"person26": 1, "face146": 13}[name]


@pytest.mark.cuda
@pytest.mark.parametrize("profile", ["hybrid", "nms"])
def test_the_rescore_and_the_part_nms_replay_alike_on_the_card(cuda, profile, monkeypatch):
    kw = {"dtype": torch.bfloat16} if profile == "hybrid" else {"nms_overlap": 0.3}
    det, _ = _cell_detector("person26", cuda, frame=VGA, **kw)
    assert det.rerank_fp32 == (profile == "hybrid")
    _replays_equal_eager(det, _vga(2, 2), monkeypatch)


@pytest.mark.cuda
def test_held_outputs_outlive_the_next_replay_on_the_card(cuda, monkeypatch):
    """detect_many at microbatch 8 and on its pipelined microbatch-1
    path (which holds PACK results before it packs them), and
    detect_stream: each run twice, so that its shape is eager, captured
    and replayed, every answer the eager one."""
    det, _ = _cell_detector("person26", cuda, frame=VGA)
    frames = _vga(detector_mod.PACK + 2, 3)
    runs = [
        lambda: det.detect_many(frames, prefetch=2),
        lambda: det.detect_many(frames, microbatch=8),
        lambda: list(det.detect_stream(frames, lookahead=4, readback_batch=2)),
    ]
    for run in runs:
        want = _eager(monkeypatch, run)
        for _ in range(2):
            got = run()
            assert len(got) == len(want) == len(frames)
            for g, w in zip(got, want):
                _same_candidates(g, w)
    counts = tail_graph_counts()
    assert counts["captures"] >= 2 and counts["replays"] > 0
