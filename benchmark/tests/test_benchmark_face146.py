"""Share-146, Zhu & Ramanan's face model (benchmark/configs/face146.json),
added as new files: `spec.load` takes it and its cell; its trees are the
landmark trees its file assumes over the shared pool of 146; the work of
a 480x640 frame; the readers of the program's tree counters; and on the
CPU at a small size, the bf16 control and altered answers come out not
correct (on the card at the cell's size, the control)."""

from __future__ import annotations

import sys
import types

import numpy as np
import pytest
import torch

from benchmark import calibrate
from benchmark.lib import compare, counters, spec, work
from benchmark.tests import _small
from partsbaseddetector_tpu_torch import types as port_types
from partsbaseddetector_tpu_torch.utils import profiling

# a 60x80 frame, and a threshold below its 256th best root score (the
# cell's is set at 480x640, where scores run higher: more cells, more levels)
SMALL = {"frame_h": 60, "frame_w": 80, "thresh": 10.0}

# the 68-point Multi-PIE markup's tree, 0-based, rooted at the nose tip 30
FRONTAL_PARENT = {29: 30, 28: 29, 27: 28, 33: 30, 32: 33, 31: 32, 34: 33, 35: 34,
                  21: 27, 20: 21, 19: 20, 18: 19, 17: 18, 22: 27, 23: 22, 24: 23, 25: 24,
                  26: 25, 39: 27, 38: 39, 37: 38, 36: 37, 40: 39, 41: 40, 42: 27, 43: 42,
                  44: 43, 45: 44, 47: 42, 46: 47, 51: 33, 50: 51, 49: 50, 48: 49, 52: 51,
                  53: 52, 54: 53, 62: 51, 61: 62, 60: 61, 63: 62, 64: 63, 66: 62, 67: 66,
                  65: 66, 57: 66, 58: 57, 59: 58, 56: 57, 55: 56, 8: 57, 9: 8}
FRONTAL_PARENT.update({i: i + 1 for i in range(8)})
FRONTAL_PARENT.update({i: i - 1 for i in range(10, 17)})


def _cfg():
    return spec.load().config("face146")


def _depth(parents) -> int:
    d = [0] * len(parents)
    for p in range(1, len(parents)):
        d[p] = d[parents[p]] + 1
    return max(d)


def test_spec_takes_the_new_files():
    s = spec.load()
    assert s.workload("face146.frame") == spec.Workload("face146.frame", "face146", "frame", 1)
    assert s.configs["face146"]["reduced"] == []
    cfg = s.config("face146")
    assert cfg["interval"] == 5 and cfg["buckets_per_octave"] == 1 and cfg["mixtures"] == 1
    assert cfg["views"] == list(range(90, -91, -15))
    pool, trees = spec.trees(cfg)
    assert pool == 146 and [len(t["parents"]) for t in trees] == [39] * 3 + [68] * 7 + [39] * 3
    got = {m.name for m in s.metrics_for("face146.frame", "end_to_end")}
    assert got == {"frame_ms_p50", "frame_ms_p90", "setup_s"}
    layer = {m.name for m in s.metrics_for("face146.frame", "per_layer")}
    assert layer == {m.name for m in s.metrics_for("person26.frame", "per_layer")}
    assert {"dp_pairs_per_image.frame", "tree_walks_per_image.frame"} <= layer


def test_the_frontal_trees_are_the_68_point_landmark_tree():
    cfg = _cfg()
    lm = cfg["landmarks"]["frontal"]
    assert sorted(lm) == list(range(68)) and lm[0] == 30
    trees = spec.trees(cfg)[1]
    for t in trees[3:10]:
        assert t == trees[3]
    parents = trees[3]["parents"]
    assert all(lm[parents[p]] == FRONTAL_PARENT[lm[p]] for p in range(1, 68))
    # landmark L takes pool filter L
    assert trees[3]["filters"] == [[x] for x in lm]
    assert _depth(parents) == 14


@pytest.mark.parametrize("side,trees,base", [("profile", slice(0, 3), 68),
                                              ("profile_mirrored", slice(10, 13), 107)])
def test_the_profile_trees_are_the_frontal_tree_on_one_sides_landmarks(side, trees, base):
    cfg = _cfg()
    lm = cfg["landmarks"][side]
    assert len(set(lm)) == 39 and lm[0] == 30
    # part p of either side is landmarks.profile[p] or its mirror image;
    # the r-th landmark of landmarks.profile in id order takes filter base + r
    prof = cfg["landmarks"]["profile"]
    rank = {x: r for r, x in enumerate(sorted(prof))}
    for t in spec.trees(cfg)[1][trees]:
        parents = t["parents"]
        assert parents == spec.trees(cfg)[1][0]["parents"]
        assert all(lm[parents[p]] == FRONTAL_PARENT[lm[p]] for p in range(1, 39))
        assert t["filters"] == [[base + rank[x]] for x in prof]
        assert _depth(parents) == 14
    # the two sides share no filter with the frontal trees or each other
    used = [sorted(r[0] for t in spec.trees(cfg)[1][s] for r in t["filters"])
            for s in (slice(0, 3), slice(3, 10), slice(10, 13))]
    assert [sorted(set(u)) for u in used] == [list(range(68, 107)), list(range(68)),
                                              list(range(107, 146))]


def test_face146s_work_figures():
    """A 480x640 frame: 23 levels in 5 one-octave buckets, 65 DP pairs;
    the pool of 146 once a level; 697 DT children a level."""
    cfg = _cfg()
    assert work.n_filters(cfg) == 146
    assert work.dt_children(cfg) == 7 * 67 + 6 * 38 == 697
    assert len(work.levels(cfg)) == 23
    per_bucket = cfg["interval"] // cfg["buckets_per_octave"]
    assert -(-23 // per_bucket) * len(cfg["trees"]) == 65
    assert round(work.conv_bound_s(cfg) * 1e3, 3) == 0.118
    assert round(work.dt_bound_s(cfg) * 1e3, 3) == 0.487
    assert round(work.conv_work(cfg)[0] / 1e9, 1) == 19.5
    assert round(work.dt_bytes(cfg) / 1e9, 2) == 1.63


READERS = ("dp_pairs_per_image.frame", "tree_walks_per_image.frame")


def _readings() -> list:
    """The two counter metrics as a --trace 1 run reads them."""
    metrics = {m.name: m for m in spec.load().metrics}
    return [spec.load_module(metrics[n].reader_path(), f"metric_{n}").read(None)
            for n in READERS]


def test_the_counter_readers_read_a_detects_trees(monkeypatch):
    for key in profiling.tree_work:
        monkeypatch.setitem(profiling.tree_work, key, 0)
    assert _readings() == [None, None]
    out = _small.run("face146.frame", frame=SMALL)
    assert out["correct"], out["compared"]
    buckets = -(-len(work.levels({**_cfg(), **SMALL})) // 5)
    assert buckets == 2
    assert _readings() == [13.0 * buckets, 13.0]


def test_the_counter_readers_read_nothing_without_the_counters(monkeypatch):
    # a program whose utils has no tree_counts, as before this reader
    monkeypatch.setitem(sys.modules, "partsbaseddetector_tpu_torch.utils",
                        types.ModuleType("partsbaseddetector_tpu_torch.utils"))
    assert counters.per_image("walks") is None
    assert _readings() == [None, None]


def test_the_bf16_control_is_not_correct():
    out = _small.run("face146.frame", overrides=calibrate.control(), frame=SMALL)
    assert out["failed"] == 0 and out["seconds"]["answers_compared"] >= 1
    assert not out["correct"], out["compared"]


def _alter(kind: str):
    orig = port_types.DetectionResult.to_candidates

    def to_candidates(self):
        cands = orig(self)
        if cands:
            c = cands[len(cands) // 2]
            if kind == "score":
                c.confidence[0] += 0.05
            else:
                c.parts[2] = c.parts[2] + np.array([4.0, 0.0, 4.0, 0.0])
        return cands

    return to_candidates


@pytest.mark.parametrize("kind", ["score", "box"])
def test_an_altered_answer_is_not_correct(monkeypatch, kind):
    monkeypatch.setattr(port_types.DetectionResult, "to_candidates", _alter(kind))
    out = _small.run("face146.frame", frame=SMALL)
    assert out["seconds"]["answers_compared"] >= 1
    assert not out["correct"], out["compared"]


@pytest.mark.cuda
def test_the_control_fails_at_the_cells_size_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    seeds = [2**31 + 101, 2**31 + 102, 2**31 + 103]
    program, control = calibrate.collect("face146.frame", seeds, seeds, 3.0,
                                         emit=lambda line: None)
    limits = spec.load().limits("face146.frame")
    assert all(compare.verdict(r, limits) for r in program), program
    assert not any(compare.verdict(r, limits) for r in control), control
