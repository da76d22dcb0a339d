"""Filters of several sizes and parts one octave finer than their parent
(the keys filter_sizes, ds and maxsize of a configuration's file,
lib/spec.py): STAR2, a two-resolution star, added to a copy of the
benchmark as new files only, is drawn at its own sizes, runs a whole
frame cell on the CPU correct, and its bf16 control is not; and the
plain reference's octave path agrees with the port's NumPy loop
reference (ops/reference_pipeline.py, which models ds) on it."""

from __future__ import annotations

import math
import types

import numpy as np
import pytest
import torch

from benchmark import calibrate
from benchmark.lib import inputs, port, spec
from benchmark.reference import pbd_tree as ref
from benchmark.tests import _small
from partsbaseddetector_tpu_torch.ops import reference as loops
from partsbaseddetector_tpu_torch.ops import reference_pipeline


def _star2(tmp_path) -> spec.Spec:
    return _small.add_config(tmp_path, _small.star2_config(), traffics=("frame",))


def test_the_star_is_added_without_edits(tmp_path):
    before = {p.relative_to(_small.ROOT): p.read_bytes()
              for p in (_small.ROOT / "benchmark").rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    s = _star2(tmp_path)
    for rel, b in before.items():
        assert (tmp_path / rel).read_bytes() == b, rel
    cfg = s.config("star2")
    assert "filter_h" not in cfg and spec.maxsize(cfg) == (6, 6)
    assert spec.filter_sizes(cfg)[:3] == [(6, 4), (4, 6), (3, 3)]
    assert [t["ds"] for t in spec.trees(cfg)[1]] == [[0, 1, 1, 1, 1, 0]] * 2


def test_the_star_draws_each_filter_at_its_own_size():
    cfg = _small.star2_config()
    arrays = inputs.model_arrays(cfg, inputs.generator(_small.SEED, "cpu"), "cpu")
    bank = arrays["filters"]
    assert tuple(bank.shape) == (12, 6, 6, 32) and arrays["maxsize"] == (6, 6)
    std = cfg["weights"]["filter_std"]
    for f, (fh, fw) in enumerate(arrays["sizes"].tolist()):
        own = bank[f, :fh, :fw]
        assert bank[f].abs().sum() == own.abs().sum()  # zeros beyond its size
        assert own.norm().item() == pytest.approx(std * math.sqrt(fh * fw * 32), rel=1e-5)
        assert own.mean(dim=(0, 1)).abs().max() < 1e-6
    for t in arrays["trees"]:
        assert t["ds"].tolist() == [0, 1, 1, 1, 1, 0]
    # a part one octave finer stays inside its parent's footprint at
    # twice the resolution; the grandchild, on its parent's level, within
    # twice its own size
    for t, (rh, rw) in zip(arrays["trees"], [(6, 4), (4, 6)]):
        ax, ay = t["anchors"][:, 0, 0], t["anchors"][:, 0, 1]
        assert (ax[1:5] >= 0).all() and (ax[1:5] <= 2 * rw - 3).all()
        assert (ay[1:5] >= 0).all() and (ay[1:5] <= 2 * rh - 3).all()
        assert 0 <= ax[5] < 6 and 0 <= ay[5] < 6


def test_a_two_resolution_star_runs_a_whole_frame_cell_correct(tmp_path):
    out = _small.run_in(_star2(tmp_path), "star2.frame", frame=_small.FRAME)
    assert out["failed"] == 0 and out["seconds"]["answers_compared"] >= 1
    assert out["correct"], out["compared"]


def test_the_stars_bf16_control_is_not_correct(tmp_path):
    out = _small.run_in(_star2(tmp_path), "star2.frame", overrides=calibrate.control(),
                        frame=_small.FRAME)
    assert out["failed"] == 0 and out["seconds"]["answers_compared"] >= 1
    assert not out["correct"], out["compared"]


def _loop_kernels():
    """The loop kernels on the plain reference's levels and features:
    each resampled level rounded to float32 once (pbd_tree.resize,
    reduce), and pbd_tree.hog, held to the loop HOG on its own
    (test_benchmark_reference.py). On other than whole-number pixels the
    loop HOG's float64 gradient magnitudes part from the float32 ones
    that pbd_tree takes by ~1e-8, which is not the path under test."""
    f32 = lambda fn: lambda *a: fn(*a).astype(np.float32).astype(np.float64)
    hog = lambda im, sbin: ref.hog(torch.as_tensor(im.astype(np.float32)), sbin).numpy()
    return types.SimpleNamespace(resize=f32(loops.resize), reduce=f32(loops.reduce), hog=hog,
                                 fconv_valid=loops.fconv_valid, shift_dt_2d=loops.shift_dt_2d)


# Both sides then sum float64 products of the same features in other
# orders (conv2d against a loop correlation, a brute-force DT against
# the envelope scan): scores of order 1-10 read gaps of 4.4e-16 to
# 1.7e-15 (two seeds), so 1e-9
# holds them with room, and a part on a wrong cell, level or step moves
# a score by far more (a response or a spring's cost, ~0.01-1).
SCORE_TOL = 1e-9


@pytest.mark.parametrize("seed", [_small.SEED, 4700000001])
def test_the_octave_path_agrees_with_the_loop_reference(seed):
    """pbd_tree.detect on STAR2 against reference_pipeline.detect_reference
    on the program's Model of the same arrays (lib/port.py::model), at
    96x128 and interval 10 (23 levels, 13 with roots): the
    same finite root cells at every (component, level), with scores
    within SCORE_TOL; and each loop cell's argmax placement (every part's
    level, cell and mixture, backtracked through its own DT pointers)
    scores the reference's best at that cell by placement_score."""
    torch.set_num_threads(4)
    cfg = {**_small.star2_config(), "frame_h": 96, "frame_w": 128}
    g = inputs.generator(seed, "cpu")
    arrays = inputs.model_arrays(cfg, g, "cpu")
    frame = inputs.frames(cfg, 1, g, "cpu")[0]
    model = ref.model_from_arrays(arrays, cfg["interval"], cfg["sbin"], cfg["thresh"])
    det = ref.detect(torch.as_tensor(frame), model)
    got = reference_pipeline.detect_reference(frame.astype(np.float64),
                                              port.model(cfg, arrays), thresh=-1e300,
                                              kernels=_loop_kernels())
    ntrees = len(model.trees)
    cells = {}
    for d in got:
        cells.setdefault((d["component"], d["level"]), []).append(d)
    for level, (h, w) in enumerate(det.grid.tolist()):
        off = int(det.root_off[level])
        maps = det.root[off : off + ntrees * h * w].reshape(ntrees, h, w)
        for c in range(ntrees):
            mine = cells.get((c, level), [])
            assert len(mine) == int(torch.isfinite(maps[c]).sum()), (c, level)
            if level < cfg["interval"]:
                assert not mine  # no level an octave below: no root
    assert len(cells) == ntrees * (len(det.scales) - cfg["interval"])
    octave = [0, 1, 1, 1, 1, 1]
    assert [t.octaves() for t in model.trees] == [octave] * ntrees
    for c in range(ntrees):
        mine = [d for d in got if d["component"] == c]
        level = torch.tensor([d["level"] for d in mine])
        xs = torch.tensor(np.stack([d["xs"] for d in mine]))
        ys = torch.tensor(np.stack([d["ys"] for d in mine]))
        mix = torch.tensor(np.stack([d["mixtures"] for d in mine]))
        best = ref.root_score_at(det, c, level, xs[:, 0], ys[:, 0])
        score = torch.tensor([d["score"] for d in mine], dtype=torch.float64)
        assert (best - score).abs().max().item() <= SCORE_TOL
        levels = level[:, None] - torch.as_tensor(octave)[None, :] * cfg["interval"]
        placed = ref.placement_score(det, model, c, levels, xs, ys, mix)
        assert (placed - best).abs().max().item() <= SCORE_TOL
