"""Configurations that declare neither filters of several sizes nor parts
an octave finer read what they read before the keys filter_sizes, ds
and maxsize existed, bit for bit: the values below were taken with the
harness as it stood before those keys, and are compared with == and
torch.equal's bytes."""

from __future__ import annotations

import hashlib

import pytest
import torch

from benchmark.lib import compare, inputs, port, spec, work
from benchmark.reference import pbd_tree as ref
from benchmark.tests import _small

# sha256 of every array model_arrays draws (the pool's filters, then
# each tree's parent, filterid, defs, anchors and bias) on the CPU
DIGESTS = {
    ("person26", 2**31 + 12345): "6fedc79a6d24dc9694959d8cd25acf9bb1adde5e64fa0d6a288d6b3cc876b5df",
    ("person26", 4700000001): "dceff91776a513cd6da1bf67a186fded2aac9ae4c4421918c3d616e306684a08",
    ("face146", 2**31 + 12345): "089dbe3791c7345e41f1e1c7a911a011ab440cd67d7647a11bc48290d7509b76",
    ("face146", 4700000001): "9cb724e17c26416cdb8f0535fa5d7cf072579b9a9e8fb610f8fd565ff2fe71e1",
}

# work's figures of a 480x640 frame and of a microbatch of 8
FIGURES = {
    "person26": {
        "levels": 46, "response_cells": 156825, "n_filters": 156, "dt_children": 150,
        "conv_work": [(39143520000.0, 120680816.0), (313148160000.0, 961952128.0)],
        "conv_work_padded": [(55224249600.0, 169608400.0), (441793996800.0, 1353372800.0)],
        "conv_bound_s": [0.00023723345454545455, 0.0018978676363636364],
        "dt_bytes": [658665000.0, 5269320000.0],
        "dt_bound_s": [0.00019661641791044777, 0.0015729313432835822],
        "model_flops": 39849232500.0,
    },
    "face146": {
        "levels": 23, "response_cells": 83657, "n_filters": 146, "dt_children": 697,
        "conv_work": [(19542275200.0, 61191176.0), (156338201600.0, 486259008.0)],
        "conv_work_padded": [(33788371200.0, 105012368.0), (270306969600.0, 836828544.0)],
        "conv_bound_s": [0.00011843803151515151, 0.0009475042521212121],
        "dt_bytes": [1632650012.0, 13061200096.0],
        "dt_bound_s": [0.00048735821253731345, 0.0038988657002985076],
        "model_flops": 21291543070.0,
    },
}

# (candidates, compare.answer_readings) of the CPU program's answer to
# one frame at _small.FRAME, seed _small.SEED
READINGS = {
    "person26": (256, {"list_gap": 5.487565825745833e-06, "score_gap": 5.487565825745833e-06,
                       "place_gap": 7.105427357601002e-15,
                       "box_gap_px": 1.5319330458396507e-05}),
    "face146": (6, {"list_gap": 3.988525577369728e-06, "score_gap": 3.988525577369728e-06,
                    "place_gap": 7.105427357601002e-15, "box_gap_px": 0.0}),
}


def _digest(arrays) -> str:
    h = hashlib.sha256()
    h.update(arrays["filters"].contiguous().numpy().tobytes())
    for t in arrays["trees"]:
        for key in ("parent", "filterid", "defs", "anchors", "bias"):
            h.update(t[key].contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("config,seed", sorted(DIGESTS))
def test_the_model_arrays_are_the_one_size_harness_bits(config, seed):
    cfg = spec.load().config(config)
    arrays = inputs.model_arrays(cfg, inputs.generator(seed, "cpu"), "cpu")
    assert _digest(arrays) == DIGESTS[config, seed]
    sizes = arrays["sizes"]
    assert torch.equal(sizes, torch.tensor([[5, 5]] * len(sizes)))
    assert arrays["maxsize"] == (5, 5)
    assert all(not t["ds"].any() for t in arrays["trees"])


def _pose(config: str) -> dict:
    """The configuration's file with its pyramid's form given as "pose"."""
    return {**spec.load().config(config), "pyramid": "pose"}


@pytest.mark.parametrize("config,keys", [
    *(pytest.param(c, "sizes", id=c) for c in sorted(FIGURES)),
    *(pytest.param(c, "pyramid", id=f"{c}-pyramid") for c in sorted(FIGURES))])
def test_the_new_keys_at_their_defaults_read_as_absent(config, keys):
    """Each tree's ds all 0, every filter's size and maxsize 5x5, given;
    or the pyramid given as "pose": the same arrays and figures as the
    file without them."""
    cfg = spec.load().config(config)
    pool, trees = spec.trees(cfg)
    given = {**cfg, "filter_sizes": [[5, 5]] * pool, "maxsize": [5, 5]}
    if keys == "pyramid":
        given = _pose(config)
    elif "trees" in cfg:
        given["trees"] = [{**t, "ds": [0] * len(t["parents"])} for t in cfg["trees"]]
    else:
        given["ds"] = [0] * len(cfg["parents"])
    seed = 2**31 + 12345
    assert _digest(inputs.model_arrays(given, inputs.generator(seed, "cpu"), "cpu")) == \
        DIGESTS[config, seed]
    assert work.model_flops(given) == FIGURES[config]["model_flops"]
    assert work.dt_bytes(given) == FIGURES[config]["dt_bytes"][0]


@pytest.mark.parametrize("config", sorted(FIGURES))
def test_the_work_figures_are_the_one_size_arithmetics(config):
    cfg = spec.load().config(config)
    want = FIGURES[config]
    assert len(work.levels(cfg)) == want["levels"]
    assert sum(work.response_cells(cfg)) == want["response_cells"]
    assert work.n_filters(cfg) == want["n_filters"]
    assert work.dt_children(cfg) == want["dt_children"]
    for key in ("conv_work", "conv_work_padded", "conv_bound_s", "dt_bytes", "dt_bound_s"):
        assert [getattr(work, key)(cfg, images) for images in (1, 8)] == want[key], key
    assert work.model_flops(cfg) == want["model_flops"]


@pytest.mark.parametrize("config", sorted(READINGS))
def test_the_compare_readings_are_the_one_size_harness_numbers(config):
    torch.set_num_threads(4)
    cfg = {**spec.load().config(config), **_small.FRAME}
    g = inputs.generator(_small.SEED, "cpu")
    arrays = inputs.model_arrays(cfg, g, "cpu")
    frame = inputs.frames(cfg, 1, g, "cpu")[0]
    cands = port.detector(cfg, arrays, "cpu").detect(frame)
    model = ref.model_from_arrays(arrays, cfg["interval"], cfg["sbin"], cfg["thresh"])
    with torch.no_grad():
        det = ref.detect(torch.as_tensor(frame), model)
    assert (len(cands), compare.answer_readings(cands, det, model, cfg, ref)) == READINGS[config]


@pytest.mark.parametrize("config", sorted(READINGS))
def test_a_pose_pyramid_given_reads_the_pinned_figures_and_readings(config):
    """"pyramid": "pose" given: every work figure, and the readings of
    the CPU program's answer against the reference built as the harness
    builds it (lib/detection.py), are the pins above."""
    torch.set_num_threads(4)
    cfg = _pose(config)
    want = FIGURES[config]
    assert len(work.levels(cfg)) == want["levels"]
    assert sum(work.response_cells(cfg)) == want["response_cells"]
    for key in ("conv_work", "conv_work_padded", "conv_bound_s", "dt_bytes", "dt_bound_s"):
        assert [getattr(work, key)(cfg, images) for images in (1, 8)] == want[key], key
    assert work.model_flops(cfg) == want["model_flops"]
    cfg = {**cfg, **_small.FRAME}
    g = inputs.generator(_small.SEED, "cpu")
    arrays = inputs.model_arrays(cfg, g, "cpu")
    frame = inputs.frames(cfg, 1, g, "cpu")[0]
    cands = port.detector(cfg, arrays, "cpu").detect(frame)
    model = ref.model_from_arrays(arrays, cfg["interval"], cfg["sbin"], cfg["thresh"],
                                  pyramid=spec.pyramid(cfg))
    with torch.no_grad():
        det = ref.detect(torch.as_tensor(frame), model)
    assert (len(cands), compare.answer_readings(cands, det, model, cfg, ref)) == READINGS[config]
