"""The port's bench entry point (partsbaseddetector_tpu_torch/bench.py) on
the CPU, at 60x80 with 4-part stand-ins for person26 and the face model
and one sample a config: what it prints, in which order, and its exit
code. Numbers from this run time the CPU and say nothing of the card.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from partsbaseddetector_tpu_torch import bench, make_synthetic_model

ARGS = ["--device", "cpu", "--samples", "1"]
KEYS = [(2, None), (6, None), (2, "hybrid"), (1, None), (4, None), (5, None), (3, None)]
GATED = {(6, None), (2, "hybrid"), (3, None)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes on
    the host's cores, and torch's spinning thread pool then slows each
    detect by two orders of magnitude."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _small_models():
    return {
        "person26": lambda: make_synthetic_model(name="p4", nparts=4, nmix=2, sbin=4,
                                                 interval=4, seed=1),
        "face": lambda: make_synthetic_model(name="f4", nparts=4, nmix=2, sbin=4,
                                             interval=5, seed=2),
    }


def _run(tmp_path, budget=None, patch=()):
    """bench.main(ARGS) with the small models and a cache of its own:
    (exit code, stdout's JSON lines)."""
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, "MODELS", _small_models())
        mp.setattr(bench, "IMSIZE", (60, 80))
        mp.setattr(bench, "TRAIN_BATCH", 2)
        mp.setattr(bench, "CACHE", tmp_path / "cpu_baseline.json")
        if budget is not None:
            mp.setenv("PBD_BENCH_BUDGET", str(budget))
        for name, fn in patch:
            mp.setattr(bench, name, fn)
        with contextlib.redirect_stdout(out):
            rc = bench.main(ARGS)
    return rc, [json.loads(line) for line in out.getvalue().splitlines()]


def _key(rec):
    return (rec["config"], rec.get("profile"))


def _records(lines):
    return [r for r in lines if "config" in r and not r.get("detail")
            and not r.get("headline")]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("bench"))


@pytest.fixture(scope="module")
def failing_run(tmp_path_factory):
    """The face config raises and the Fourier config fails its gate."""

    def boom(b):
        raise RuntimeError("face failed on purpose")

    def fourier_off(b):
        res = bench.Result(bench.Spread([1.0, 2.0, 3.0]), 0.5, gate=False)
        return res

    return _run(tmp_path_factory.mktemp("bench_fail"),
                patch=[("face", boom), ("fourier", fourier_off)])


def test_exits_0_with_a_header_first(run):
    rc, lines = run
    assert rc == 0
    assert lines[0]["bench"] == "partsbaseddetector_tpu_torch"
    assert lines[0]["device"] == "cpu" and lines[0]["samples"] == 1
    assert lines[0]["imsize"] == "60x80"


def test_each_config_prints_a_compact_record_then_its_detail_line(run):
    _, lines = run
    body = lines[1:1 + 2 * len(KEYS)]
    assert [_key(r) for r in body[0::2]] == KEYS
    for rec, detail in zip(body[0::2], body[1::2]):
        assert len(json.dumps(rec)) <= bench.COMPACT_BYTES
        assert set(rec) >= {"config", "metric", "value", "unit", "vs_baseline"}
        assert rec["unit"] == "images/sec" and "detail" not in rec
        assert detail["detail"] is True and _key(detail) == _key(rec)
        assert ("gate" in rec) == (_key(rec) in GATED)
        assert rec.get("gate", True) is True


def test_metric_names_are_the_jax_benchs(run):
    _, lines = run
    names = {_key(r): r["metric"] for r in _records(lines)}
    assert names[(2, None)] == "person26 VGA single-image detect throughput (1 chip)"
    assert names[(1, None)] == "face VGA single-image detect throughput (1 chip)"
    assert names[(6, None)] == "person26 latent-SSVM training throughput (1 chip, 240x320)"
    assert names[(4, None)] == "person26 VGA 64-image batched throughput (1 chip)"
    assert names[(3, None)] == "person26 VGA Fourier-engine detect throughput (1 chip)"


def test_records_carry_median_min_and_max(run):
    _, lines = run
    details = {_key(r): r for r in lines if r.get("detail")}
    for rec in _records(lines)[: len(KEYS)]:
        d = details[_key(rec)]
        assert len(d["samples"]) == 1
        assert d["min"] <= d["median"] <= d["max"]
        assert rec["value"] == round(d["median"], 3) > 0
        assert rec["min"] <= rec["value"] <= rec["max"]
    batch = details[(4, None)]
    assert batch["microbatch8_min"] <= batch["microbatch8_median"] <= batch["microbatch8_max"]
    assert details[(6, None)]["loss_finite"] is True


def test_the_tail_repeats_every_record_then_the_headline(run):
    _, lines = run
    first = lines[1:1 + 2 * len(KEYS)][0::2]
    tail = lines[-len(KEYS) - 1:-1]
    assert tail == first
    head = lines[-1]
    assert head["headline"] is True and _key(head) == (2, None)
    assert head["value"] == first[0]["value"]


def test_a_config_that_raises_prints_an_error_and_the_rest_run(failing_run):
    rc, lines = failing_run
    assert rc == 1
    recs = _records(lines)
    assert [_key(r) for r in recs] == KEYS + KEYS
    face = [r for r in recs if _key(r) == (1, None)]
    assert all("face failed on purpose" in r["error"] and "value" not in r for r in face)
    others = [r for r in recs if _key(r) not in {(1, None), (3, None)}]
    assert all(r["value"] > 0 for r in others)
    assert lines[-1]["headline"] and lines[-1]["value"] > 0


def test_a_failed_gate_exits_1(failing_run):
    rc, lines = failing_run
    fourier = [r for r in _records(lines) if _key(r) == (3, None)]
    assert rc == 1 and len(fourier) == 2
    assert all(r["gate"] is False and r["value"] == 2.0 for r in fourier)
    assert all(r["min"] == 1.0 and r["max"] == 3.0 for r in fourier)


def test_a_budget_of_0_skips_every_config(tmp_path):
    rc, lines = _run(tmp_path, budget=0)
    recs = _records(lines)
    assert [_key(r) for r in recs] == KEYS + KEYS
    assert all(r["skipped"] is True and "budget" in r["reason"] for r in recs)
    assert rc == 0
    head = lines[-1]
    assert head["headline"] and head["value"] == 0.0 and "budget" in head["error"]
    assert not (tmp_path / "cpu_baseline.json").exists()


def test_no_card_raises_as_the_detector_does(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--samples", "1"])


def test_the_cpu_baseline_is_cached_per_host_model_and_size(tmp_path, monkeypatch):
    monkeypatch.setattr(bench, "CACHE", tmp_path / "c.json")
    b = bench.Bench(torch.device("cpu"), 1, (40, 48), 2, 800.0)
    model = _small_models()["face"]()
    first = b.cpu_seconds(model)
    cache = json.loads((tmp_path / "c.json").read_text())
    (host, entries), = cache.items()
    assert entries == {"f4:40x48": first} and first > 0
    cache[host]["f4:40x48"] = 123.0
    (tmp_path / "c.json").write_text(json.dumps(cache))
    assert b.cpu_seconds(model) == 123.0


def test_match_boxes_pairs_each_candidate_once():
    """bench.py::_match_boxes's contract: greedy, each reference used
    once, within tol_px on every box coordinate."""
    ref = np.zeros((3, 2, 4))
    ref[1] += 10.0
    ref[2] += 20.0
    sc_ref = np.array([3.0, 2.0, 1.0])
    query = ref[[0, 0, 2]] + 0.5
    sc = np.array([3.25, 2.5, 1.0])
    valid = np.array([True, True, True])
    nq, nm, dmax = bench._match_boxes(ref, sc_ref, valid, query, sc, valid)
    assert (nq, nm, dmax) == (3, 2, 0.25)
    assert bench._match_boxes(ref, sc_ref, valid, query, sc, valid * False)[:2] == (0, 0)
