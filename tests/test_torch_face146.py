"""The Zhu & Ramanan Share-146 face model (`benchmark/configs/face146.json`:
13 view trees, 7 of 68 parts and 6 of 39, over one pool of 146 filters)
on the port's normal path, `PartsBasedDetector.detect` on the model that
the benchmark builds (`benchmark/lib/port.py::detector`), against the
plain reference (`benchmark/reference/pbd_tree.py`), tree by tree:

  - every tree's root-score map at every pyramid level: the map that
    `_run` takes from `pipeline.root_scores`, inside the level's grid
    within the cell's `score_gap` limit of the reference's, -inf
    outside it;
  - every tree's candidates, with the threshold below every score and a
    budget of every root cell of every tree: each has its own tree's part count, its
    score, placement and boxes within the cell's limits of the
    reference's (`benchmark/lib/compare.py`), and the tree's scores,
    best first, are the reference's map values, best first;

at 48x64 on the CPU, and at 480x640 on the card (the root maps of the
replayed DP graph, and the cell's own comparison of a detect). And the
detect path's tree counters (`utils.tree_counts`): 13 walks,
buckets x 13 DPs and buckets x 14 DT groups (the trees' depth) a face146
detect, 1, the bucket count and buckets x 9 a person26 detect, and a
microbatch of 2 counting 2 images in one program.

On the card:

    python -m pytest tests/test_torch_face146.py -m cuda -q --noconftest
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.lib import compare, inputs, port
from benchmark.reference import pbd_tree as ref
from partsbaseddetector_tpu_torch import detector as detector_mod
from partsbaseddetector_tpu_torch.utils import tree_counts

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
SMALL = {"frame_h": 48, "frame_w": 64}
SEEDS = [2**31 + 7, 4700000113]


def _config(name: str, **change) -> dict:
    return {**json.loads((BENCH / "configs" / f"{name}.json").read_text()), **change}


def _limits() -> dict:
    return json.loads((BENCH / "limits" / "face146.frame.json").read_text())


def _setup(cfg: dict, seed: int, device):
    """The run's arrays, one frame, and the reference's model and
    detection of it, as a cell makes them."""
    g = inputs.generator(seed, device)
    arrays = inputs.model_arrays(cfg, g, device)
    frame = inputs.frames(cfg, 1, g, device)[0]
    model = ref.model_from_arrays(arrays, cfg["interval"], cfg["sbin"], cfg["thresh"])
    return arrays, frame, model, ref.detect(torch.as_tensor(frame, device=device), model)


def _root_maps(monkeypatch, det, frame, calls: int = 1):
    """(bucket, tree, root map (S, Hr, Wr)) of every DP pair of the
    last of `calls` detects, as `_run` took them from root_scores."""
    seen = []
    orig = detector_mod.root_scores

    def root_scores(*a, **kw):
        out = orig(*a, **kw)
        # a replayed graph rewrites its outputs at the next replay
        seen.append([(bs.bucket_index, bs.component, bs.rootv[0].clone()) for bs in out])
        return out

    monkeypatch.setattr(detector_mod, "root_scores", root_scores)
    for _ in range(calls):
        cands = det.detect(frame)
    return seen[-1], cands


def _check_root_maps(maps, plan, rdet, ntrees: int, tol: float) -> None:
    """Every tree's map of every level (the plan's buckets' scales)
    against the reference's, and every (tree, level) seen."""
    seen = set()
    for b, c, rootv in maps:
        for s, level in enumerate(plan.buckets[b].scale_indices):
            h, w = rdet.grid[level].tolist()
            off = int(rdet.root_off[level])
            want = rdet.root[off : off + ntrees * h * w].reshape(ntrees, h, w)[c]
            got = rootv[s].double()
            gap = (got[:h, :w] - want).abs().max().item()
            assert gap <= tol, (b, c, level, gap)
            outside = torch.ones_like(got, dtype=torch.bool)
            outside[:h, :w] = False
            assert torch.isneginf(got[outside]).all(), (b, c, level)
            seen.add((c, level))
    assert seen == {(c, level) for c in range(ntrees) for level in range(len(rdet.scales))}


@pytest.mark.parametrize("seed", SEEDS)
def test_every_tree_agrees_with_the_reference(seed, monkeypatch):
    torch.set_num_threads(4)
    lim = _limits()
    # every root cell of every tree a candidate
    cfg = _config("face146", **SMALL, thresh=-1e30)
    arrays, frame, model, rdet = _setup(cfg, seed, "cpu")
    ntrees = len(model.trees)
    cells = sum(int(h) * int(w) for h, w in rdet.grid.tolist())
    det = port.detector(cfg, arrays, "cpu", max_detections=ntrees * cells)
    maps, cands = _root_maps(monkeypatch, det, frame)
    plan = det._plan(frame.shape[:2])
    _check_root_maps(maps, plan, rdet, ntrees, lim["score_gap"])
    assert len(maps) == len(plan.buckets) * ntrees

    sizes = set()
    for c, tree in enumerate(model.trees):
        mine = [x for x in cands if x.component == c]
        nparts = len(tree.parent)
        sizes.add(nparts)
        assert len(mine) == cells
        assert all(len(x.parts) == nparts == len(x.mixtures) for x in mine)
        got = compare.answer_readings(mine, rdet, model, cfg, ref)
        for key in ("score_gap", "place_gap", "box_gap_px"):
            assert got[key] <= lim[key], (c, key, got[key])
        flat = torch.cat([rdet.root[int(o) : int(o) + ntrees * h * w].reshape(ntrees, -1)[c]
                          for o, (h, w) in zip(rdet.root_off, rdet.grid.tolist())])
        want = flat.sort(descending=True).values.numpy()
        scores = np.array([x.score for x in mine])
        assert np.abs(scores - want).max() <= lim["list_gap"], c
    assert sizes == {39, 68}


def _delta(before):
    return {k: v - before[k] for k, v in tree_counts().items()}


@pytest.fixture(scope="module")
def small_detectors():
    """face146 and person26 on the CPU at 48x64, with their frames."""
    torch.set_num_threads(4)
    out = {}
    for name in ("face146", "person26"):
        cfg = _config(name, **SMALL)
        g = inputs.generator(SEEDS[0], "cpu")
        arrays = inputs.model_arrays(cfg, g, "cpu")
        frames = inputs.frames(cfg, 2, g, "cpu")
        out[name] = (port.detector(cfg, arrays, "cpu"), frames)
    return out


# the trees and their depth: every part of a configuration on its root's
# grid with its K mixtures, so one DT group a depth a bucket
TREES = [("face146", 13, 14), ("person26", 1, 9)]


@pytest.mark.parametrize("name,trees,levels", TREES)
def test_a_detect_counts_its_trees(small_detectors, name, trees, levels):
    det, frames = small_detectors[name]
    before = tree_counts()
    det.detect(frames[0])
    got = _delta(before)
    buckets = len(det._plan(frames[0].shape[:2]).buckets)
    assert got == {"images": 1, "dp_pairs": buckets * trees, "dp_groups": buckets * levels,
                   "walks": trees, "tail_rows": trees * det.max_detections}


@pytest.mark.parametrize("name,trees,levels", TREES)
def test_a_batch_counts_its_images(small_detectors, name, trees, levels):
    det, frames = small_detectors[name]
    before = tree_counts()
    det.detect_many(frames, microbatch=2)
    got = _delta(before)
    buckets = len(det._plan(frames[0].shape[:2]).buckets)
    # one program over the stack: a DP pair, a DT group and a walk a tree
    # carry both images
    assert got == {"images": 2, "dp_pairs": buckets * trees, "dp_groups": buckets * levels,
                   "walks": trees, "tail_rows": 2 * trees * det.max_detections}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_every_tree_agrees_with_the_reference_at_vga_on_the_card(cuda, monkeypatch):
    """The cell's configuration at 480x640: the third detect (a replay
    of the DP graph, as the timed window runs it) against the reference,
    every tree's root maps and the cell's own comparison of the
    candidates."""
    lim = _limits()
    cfg = _config("face146")
    arrays, frame, model, rdet = _setup(cfg, SEEDS[1], cuda)
    det = port.detector(cfg, arrays, cuda)
    maps, cands = _root_maps(monkeypatch, det, frame, calls=3)
    ntrees = len(model.trees)
    plan = det._plan(frame.shape[:2])
    _check_root_maps(maps, plan, rdet, ntrees, lim["score_gap"])
    # 23 levels in 5 one-octave buckets
    assert len(maps) == 5 * ntrees and len(rdet.scales) == 23
    assert len(cands) == cfg["max_detections"]
    got = compare.answer_readings(cands, rdet, model, cfg, ref)
    assert compare.verdict(got, lim), got
    assert all(math.isfinite(v) for v in got.values())
