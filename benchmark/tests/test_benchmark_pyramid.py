"""The pyramid's two forms (the key `pyramid` of a configuration's file,
lib/spec.py): "pose", every level at sbin, which every configuration
without the key means and reads bit for bit as before; and "dpm",
voc-release4's featpyramid.m, an octave of HOG at sbin / 2 before the
levels at sbin. No independent implementation of the "dpm" form exists
in the repo, so the reference's is held to its composition (each level
rebuilt from resize and hog directly), to the "pose" form where the two
share levels, to hand arithmetic, to the work counts, and to its own
DP and comparison on a star of parts one octave finer."""

from __future__ import annotations

import math
import random
import types

import numpy as np
import pytest
import torch

from benchmark.lib import compare, detection, inputs, port, spec, work
from benchmark.reference import pbd_tree as ref
from benchmark.tests import _small

# the keywords lib/port.py::model gave the program's Model before the key
TODAYS_KEYWORDS = {"name", "interval", "sbin", "thresh", "filters", "defs", "anchors",
                   "biases", "parentid", "filterid", "defid", "biasid", "maxsize"}
INTERVAL = 10
# (sbin, frame height, frame width): sbin 8 as voc-release4's models
# take it, and STAR2's own sbin 4 (half-cell cells of 2 pixels)
FRAMES = [(8, 96, 128), (8, 121, 163), (4, 60, 80)]


def _frame(h: int, w: int, seed: int = _small.SEED) -> torch.Tensor:
    cfg = {"frame_h": h, "frame_w": w}
    return torch.as_tensor(inputs.frames(cfg, 1, inputs.generator(seed, "cpu"), "cpu")[0])


def _model(sbin: int, form: str) -> ref.Model:
    cfg = _small.star2_config()
    arrays = inputs.model_arrays(cfg, inputs.generator(_small.SEED, "cpu"), "cpu")
    return ref.model_from_arrays(arrays, INTERVAL, sbin, cfg["thresh"], pyramid=form)


def _same(a, b) -> bool:
    """Equal values, arrays by their bytes, containers entry by entry."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return type(a) is type(b) and a == b


def test_port_model_makes_todays_call_unless_the_pyramid_is_dpm(monkeypatch):
    """Absent, or given as "pose", the program's Model gets today's
    keywords and values; "dpm" adds pyramid="dpm" and changes nothing
    else (a stand-in Model records each call)."""
    from partsbaseddetector_tpu_torch.models import model as program

    calls = []
    monkeypatch.setattr(program, "Model", lambda **kw: calls.append(kw) or kw)
    arrays = inputs.model_arrays(_small.star2_config(), inputs.generator(_small.SEED, "cpu"),
                                 "cpu")
    absent = port.model(_small.star2_config(), arrays)
    pose = port.model({**_small.star2_config(), "pyramid": "pose"}, arrays)
    dpm = port.model({**_small.star2_dpm_config(), "name": "star2"}, arrays)
    assert len(calls) == 3 and set(absent) == TODAYS_KEYWORDS
    assert _same(pose, absent)
    assert dpm.pop("pyramid") == "dpm" and _same(dpm, absent)


def test_the_star_draws_the_same_arrays_on_either_pyramid():
    """The key changes the pyramid, not the model: the same draws."""
    a = inputs.model_arrays(_small.star2_config(), inputs.generator(_small.SEED, "cpu"), "cpu")
    b = inputs.model_arrays(_small.star2_dpm_config(), inputs.generator(_small.SEED, "cpu"),
                            "cpu")
    assert torch.equal(a["filters"], b["filters"]) and a["maxsize"] == b["maxsize"]
    for s, t in zip(a["trees"], b["trees"]):
        assert all(torch.equal(s[k], t[k]) for k in s)


def test_the_cells_reference_takes_the_configurations_pyramid():
    """lib/detection.py builds the reference's Model with the file's form."""
    seen = []
    stub = types.SimpleNamespace(model_from_arrays=lambda *a, **kw: seen.append(kw))
    client = object.__new__(detection.Client)
    client.p, client.answers, client.arrays = {"compare_frames": 1}, {}, None
    for cfg in (_small.star2_config(), _small.star2_dpm_config()):
        client.cfg = cfg
        client.readings(stub, random.Random(0))
    assert seen == [{"pyramid": "pose"}, {"pyramid": "dpm"}]


@pytest.mark.parametrize("sbin,h,w", FRAMES)
def test_the_dpm_levels_are_composed_as_featpyramid_m(sbin, h, w):
    """Level i < interval is hog(resize(frame, 1 / sc^i), sbin / 2) at
    (sbin / 2) sc^i; level interval + i the "pose" form's level i, bit
    for bit, at sbin sc^i; each later octave hog at sbin of the image an
    octave above resized by 0.5, at twice its scale; every level padded
    as the "pose" form pads."""
    frame = _frame(h, w)
    model, pose_model = _model(sbin, "dpm"), _model(sbin, "pose")
    feats, scales = ref.pyramid(frame, model)
    pose, pose_scales = ref.pyramid(frame, pose_model)
    n, sc = len(pose), 2.0 ** (1.0 / INTERVAL)
    assert n > INTERVAL and len(feats) == len(scales) == n + INTERVAL
    pad = lambda f: ref._padded([f], model)[0]
    im = frame.to(torch.float32)
    octaves = 0
    for i in range(INTERVAL):
        scaled = ref.resize(im, 1.0 / sc**i) if i else im
        assert torch.equal(feats[i], pad(ref.hog(scaled, sbin // 2))), i
        assert scales[i] == sbin / 2 * sc**i
        assert torch.equal(feats[INTERVAL + i], pose[i]), i
        assert scales[INTERVAL + i] == pose_scales[i] == sbin * sc**i == 2.0 * scales[i]
        for j in range(i + 2 * INTERVAL, n + INTERVAL, INTERVAL):
            scaled = ref.resize(scaled, 0.5)
            assert torch.equal(feats[j], pad(ref.hog(scaled, sbin))), j
            assert scales[j] == 2.0 * scales[j - INTERVAL] == pose_scales[j - INTERVAL]
            # the pose form reduces where this one resizes
            assert not torch.equal(feats[j], pose[j - INTERVAL]), j
            octaves += 1
    assert octaves > 0
    assert feats[0].shape[0] > pose[0].shape[0] and feats[0].shape[1] > pose[0].shape[1]


@pytest.mark.parametrize("form", ["pose", "dpm"])
@pytest.mark.parametrize("sbin,h,w", FRAMES)
def test_work_counts_the_levels_the_reference_builds(form, sbin, h, w):
    cfg = {**_small.star2_dpm_config(), "pyramid": form, "sbin": sbin, "interval": INTERVAL,
           "frame_h": h, "frame_w": w}
    feats, _ = ref.pyramid(_frame(h, w), _model(sbin, form))
    assert work.levels(cfg) == [tuple(f.shape[:2]) for f in feats]


def test_a_dpm_pyramid_by_hand_at_vga():
    """480x640, sbin 8, interval 10: 1 + floor(10 log2(480 / 40)) = 36
    levels at sbin, 10 more at sbin 4 before them. Unpadded, level 0 is
    120 - 2 by 160 - 2 cells and level 10 60 - 2 by 80 - 2; 140,525 cells
    in all, 107,247 of them in the half-cell octave, against the pose
    form's 36 levels and 33,278 cells."""
    cfg = {**_small.star2_dpm_config(), "sbin": 8, "frame_h": 480, "frame_w": 640}
    # each side pads by maxsize - 2 cells and one more
    py, px = (m - 1 for m in spec.maxsize(cfg))
    cells = lambda c: [(h - 2 * py, w - 2 * px) for h, w in work.levels(c)]
    dpm, pose = cells(cfg), cells({**cfg, "pyramid": "pose"})
    assert len(dpm) == 46 and len(pose) == 36
    assert dpm[0] == (118, 158) and dpm[10] == (58, 78) and dpm[10:] == pose
    assert sum(h * w for h, w in dpm) == 140525
    assert sum(h * w for h, w in dpm[:10]) == 107247
    assert sum(h * w for h, w in pose) == 33278


def _star2_dpm(seed: int = _small.SEED):
    """STAR2 on the "dpm" pyramid at 60x80: (cfg, model, detection)."""
    torch.set_num_threads(4)
    cfg = {**_small.star2_dpm_config(), "frame_h": 60, "frame_w": 80}
    g = inputs.generator(seed, "cpu")
    arrays = inputs.model_arrays(cfg, g, "cpu")
    frame = torch.as_tensor(inputs.frames(cfg, 1, g, "cpu")[0])
    model = ref.model_from_arrays(arrays, cfg["interval"], cfg["sbin"], cfg["thresh"],
                                  pyramid=spec.pyramid(cfg))
    with torch.no_grad():
        return cfg, model, ref.detect(frame, model)


def test_a_dpm_star_is_added_as_new_files_only(tmp_path):
    s = _small.add_config(tmp_path, _small.star2_dpm_config(), traffics=("frame",))
    assert spec.pyramid(s.config("star2dpm")) == "dpm"
    assert spec.pyramid(s.config("person26")) == spec.pyramid(s.config("face146")) == "pose"


def test_a_dpm_star_has_roots_on_every_level_above_the_half_cell_octave():
    """No root on the half-cell octave (its parts at ds = 1 would read a
    level that does not exist); on every level from interval up, a
    finite root at every cell of each root filter's own extent."""
    cfg, model, det = _star2_dpm()
    lv = work.levels(cfg)
    assert len(lv) == len(det.scales) > 2 * cfg["interval"]
    roots = [tuple(model.sizes[t.filterid[0, 0]].tolist()) for t in model.trees]
    for level, (h, w) in enumerate(det.grid.tolist()):
        off = int(det.root_off[level])
        maps = det.root[off : off + len(roots) * h * w].reshape(len(roots), h, w)
        for c, (fh, fw) in enumerate(roots):
            finite = int(torch.isfinite(maps[c]).sum())
            if level < cfg["interval"]:
                assert finite == 0, (c, level)
            else:
                assert finite == (lv[level][0] - fh + 1) * (lv[level][1] - fw + 1), (c, level)
    assert det.scores.numel() > 0


def test_compare_reads_a_box_built_from_the_references_scales_as_exact():
    """A candidate of component 0 with its root at level interval + 3,
    its boxes built from the reference's own scales (each part on level
    3, the half-cell octave), reads box_gap_px 0 and score_gap 0; its
    parts' boxes built at the root's scale instead read a gap."""
    cfg, model, det = _star2_dpm()
    tree = model.trees[0]
    level = cfg["interval"] + 3
    octaves = np.array(tree.octaves())
    levels = level - octaves * cfg["interval"]
    pady, padx = model.pad
    x, y = padx + 2, pady + 1
    xs = np.where(octaves == 1, 2 * x + 1, x)
    ys = np.where(octaves == 1, 2 * y, y)
    size = model.sizes[tree.filterid[:, 0]].numpy()

    def candidate(scales):
        sc = np.asarray(scales)
        x1, y1 = (xs - padx) * sc, (ys - pady) * sc
        boxes = np.stack([x1, y1, x1 + size[:, 1] * sc - 1, y1 + size[:, 0] * sc - 1], -1)
        score = ref.root_score_at(det, 0, torch.tensor([level]), torch.tensor([x]),
                                  torch.tensor([y]))
        assert math.isfinite(float(score))
        return types.SimpleNamespace(score=float(score), parts=boxes, component=0,
                                     mixtures=np.zeros(len(xs), np.int64),
                                     confidence=np.zeros(len(xs)))

    own = [det.scales[lv] for lv in levels]
    got = compare.answer_readings([candidate(own)], det, model, cfg, ref)
    assert got["box_gap_px"] == 0.0 and got["score_gap"] == 0.0
    wrong = compare.answer_readings([candidate([det.scales[level]] * len(xs))], det, model,
                                    cfg, ref)
    assert wrong["box_gap_px"] > 1.0
