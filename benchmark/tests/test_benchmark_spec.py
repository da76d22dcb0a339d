"""The harness is driven by data: a configuration, a traffic mix and a
metric added as new files (and entries in BENCHMARK.json) in a copy of
the benchmark are found and checked by name, with no file edited; names
and units outside the rules are refused."""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest
import torch

from benchmark.lib import cell, spec, traffic
from benchmark.tests import _small

ROOT = Path(__file__).resolve().parents[2]

# a client that the benchmark does not have: open-loop arrivals at a
# fixed rate (a new parameter), each frame's latency from its arrival
PACED = """
import time
from benchmark.lib import detection, loop

KEYS = detection.KEYS | {"rate_hz"}


class Client(detection.Client):
    per_request = 1

    def call(self):
        i = self.next % len(self.frames)
        self.next += 1
        return [(i, self.det.detect(self.frames[i]))]

    def warm_call(self):
        self.det.detect(self.frames[0])

    def traced_request(self):
        return (lambda: self.det.detect(self.frames[0])), 1

    def window(self, seconds, clock=time.perf_counter):
        lat, start = [], clock()
        while len(lat) < 2 or clock() - start < seconds:
            due = start + len(lat) / self.p["rate_hz"]
            time.sleep(max(0.0, due - clock()))
            self.request()
            lat.append(clock() - due)
        return loop.Timed(lat, len(lat), clock() - start, 0, 1)
"""


@pytest.fixture
def copy(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path


def _add(root: Path, bench: dict) -> dict:
    b = root / "benchmark"
    cfg = json.loads((b / "configs/person26.json").read_text())
    cfg.update(name="tiny9", parts=9, mixtures=2, parents=[0, 0, 1, 1, 2, 0, 5, 5, 3])
    (b / "configs/tiny9.json").write_text(json.dumps(cfg))
    (b / "clients/paced.py").write_text(PACED)
    (b / "traffic/paced.json").write_text(json.dumps(
        {"client": "paced", "pool": 2, "compare_frames": 2, "warm_requests": 1,
         "rate_hz": 50.0}))
    (b / "limits/tiny9.paced.json").write_text(json.dumps(
        {"score_gap": 0.01, "place_gap": 0.01, "box_gap_px": 0.01, "list_gap": 0.01}))
    (b / "metrics/requests_seen.tiny.py").write_text(
        "def read(ctx):\n    return len(ctx.latencies_s)\n")
    bench["configs"].append({"name": "tiny9", "source": "a test", "reduced": ["parts"],
                             "file": "benchmark/configs/tiny9.json", "why": "a test"})
    bench["workloads"].append({"name": "tiny9.paced", "config": "tiny9", "traffic": "paced",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("tiny9.paced")
    bench["per_layer"].append({"name": "requests_seen.tiny", "unit": "requests",
                               "better": "higher", "source": "host_clock", "layer": "test",
                               "moves": "frame_ms_p50", "workloads": ["tiny9.paced"]})
    return bench


def _write(root: Path, bench: dict) -> spec.Spec:
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return spec.load(root / "BENCHMARK.json", root / "benchmark")


def test_new_files_are_found_by_name_without_edits(copy):
    before = {p: p.read_bytes() for p in (copy / "benchmark").rglob("*") if p.is_file()}
    s = _write(copy, _add(copy, json.loads((copy / "BENCHMARK.json").read_text())))
    assert all(p.read_bytes() == b for p, b in before.items())
    cell_ = s.workload("tiny9.paced")
    assert s.config(cell_.config)["parts"] == 9
    params, client = traffic.load(s.bench_dir, cell_.traffic)
    assert params["rate_hz"] == 50.0 and "rate_hz" in client.KEYS
    assert s.limits("tiny9.paced")["list_gap"] == 0.01
    assert [m.name for m in s.metrics_for("tiny9.paced", "per_layer")] == ["requests_seen.tiny"]
    assert s.metrics_for("person26.frame", "per_layer") == \
        spec.load().metrics_for("person26.frame", "per_layer")
    reader = spec.load_module(s.metrics[-1].reader_path(s.bench_dir), "metric_tiny_test")
    ctx = cell.Context("tiny9.paced", {}, {}, 0.0, [0.1, 0.2], 2, 0.3, None)
    assert reader.read(ctx) == 2


def test_a_new_client_runs_a_whole_cell(copy):
    """The new mix, its client, configuration and limits run through the
    harness as it stands (CPU, small frames) and the program's answers
    come out correct."""
    torch.set_num_threads(4)
    s = _write(copy, _add(copy, json.loads((copy / "BENCHMARK.json").read_text())))
    out = cell.run(s, "tiny9.paced", 2**31 + 77, 0.5, False, "cpu", 0.0,
                   config_overrides={"frame_h": 60, "frame_w": 80})
    assert out["correct"], out["compared"]
    assert out["seconds"]["answers_compared"] >= 1 and out["seconds"]["requests"] >= 2
    assert out["metrics"]["frame_ms_p50"]["value"] > 0


@pytest.mark.parametrize("change", ["unknown_key", "missing_key", "no_client", "no_limits"])
def test_a_traffic_file_its_client_does_not_take_is_refused(copy, change):
    bench = _add(copy, json.loads((copy / "BENCHMARK.json").read_text()))
    b = copy / "benchmark"
    params = json.loads((b / "traffic/paced.json").read_text())
    if change == "unknown_key":
        params["burst"] = 4
    elif change == "missing_key":
        del params["rate_hz"]
    elif change == "no_client":
        params["client"] = "replay"
    else:
        (b / "limits/tiny9.paced.json").unlink()
    (b / "traffic/paced.json").write_text(json.dumps(params))
    with pytest.raises(spec.SpecError):
        _write(copy, bench)


@pytest.mark.parametrize("bad", ["has space", "comma,name", "slash/name", "-lead",
                                 ".lead", "x" * 65, "microµs"])
def test_names_outside_the_rules_are_refused(copy, bad):
    bench = _add(copy, json.loads((copy / "BENCHMARK.json").read_text()))
    bench["per_layer"][-1]["name"] = bad
    with pytest.raises(spec.SpecError):
        _write(copy, bench)


@pytest.mark.parametrize("unit", ["tokens per second", "x" * 17, "", "µs", "ms,s"])
def test_units_outside_the_rules_are_refused(copy, unit):
    bench = _add(copy, json.loads((copy / "BENCHMARK.json").read_text()))
    bench["per_layer"][-1]["unit"] = unit
    with pytest.raises(spec.SpecError):
        _write(copy, bench)


def test_a_metric_without_its_reader_is_refused(copy):
    bench = _add(copy, json.loads((copy / "BENCHMARK.json").read_text()))
    (copy / "benchmark/metrics/requests_seen.tiny.py").unlink()
    with pytest.raises(spec.SpecError, match="no reader"):
        _write(copy, bench)


def test_the_committed_benchmark_keeps_the_contracts_limits():
    s = spec.load()
    assert 1 <= s.run_seconds <= 51
    assert 2 + 14 * 24 * (s.run_seconds + 60) + 24 * 180 + 1200 <= 43200
    assert all(w.chips == 1 for w in s.workloads.values())
    e2e = {m.name: m for m in s.metrics if m.kind == "end_to_end"}
    assert e2e["setup_s"].bound <= 0.25 and e2e["setup_s"].workloads is None
    assert all(0.01 <= m.bound <= 0.25 for m in e2e.values())
    for name in s.workloads:
        got = {m.name for m in s.metrics_for(name, "end_to_end")}
        assert "setup_s" in got and len(got) >= 2
        assert s.metrics_for(name, "per_layer")
    for m in s.metrics:
        if m.kind == "per_layer":
            assert m.moves in e2e and all(m2.applies(c) for c in (m.workloads or ())
                                          for m2 in [e2e[m.moves]])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def _sized(change: str) -> dict:
    """A configuration with one of the keys filter_sizes, ds, maxsize or
    pyramid malformed: STAR2's (the several-tree form) or person26's
    (one tree)."""
    if change.startswith("one_tree"):
        cfg = {**spec.load().config("person26"), "name": "one26", "ds": [0] * 26,
               "filter_sizes": [[5, 5]] * 156}
    else:
        cfg = _small.star2_config()
    trees = cfg.get("trees")
    if change == "ds_on_root":
        trees[0]["ds"][0] = 1
    elif change == "ds_of_two":
        trees[1]["ds"][3] = 2
    elif change == "ds_negative":
        trees[0]["ds"][2] = -1
    elif change == "ds_not_a_number":
        trees[0]["ds"][4] = "1"
    elif change == "ds_true":
        trees[1]["ds"][1] = True
    elif change == "ds_short":
        trees[1]["ds"].pop()
    elif change == "ds_beside_trees":
        cfg["ds"] = [0, 1, 1, 1, 1, 0]
    elif change == "sizes_short":
        cfg["filter_sizes"].pop()
    elif change == "sizes_long":
        cfg["filter_sizes"].append([3, 3])
    elif change == "size_zero":
        cfg["filter_sizes"][5] = [0, 3]
    elif change == "size_of_three":
        cfg["filter_sizes"][2] = [3, 3, 3]
    elif change == "size_fraction":
        cfg["filter_sizes"][7] = [3, 2.5]
    elif change == "maxsize_zero":
        cfg["maxsize"] = [6, 0]
    elif change == "maxsize_one_number":
        cfg["maxsize"] = 6
    elif change == "one_tree_ds_on_root":
        cfg["ds"][0] = 1
    elif change == "one_tree_ds_of_two":
        cfg["ds"][17] = 2
    elif change == "one_tree_sizes_short":
        cfg["filter_sizes"].pop()
    elif change == "pyramid_unknown":
        cfg["pyramid"] = "voc"
    elif change == "pyramid_not_a_string":
        cfg["pyramid"] = ["dpm"]
    elif change == "pyramid_odd_sbin":
        cfg.update(pyramid="dpm", sbin=5)
    elif change == "pyramid_small_sbin":
        cfg.update(pyramid="dpm", sbin=2)
    elif change == "pyramid_no_octave_part":
        cfg["pyramid"] = "dpm"
        trees[1]["ds"] = [0] * 6
    elif change == "one_tree_pyramid_no_octave_part":
        cfg["pyramid"] = "dpm"
    return cfg


@pytest.mark.parametrize("change,names", [
    ("ds_on_root", "tree 0: part 0"), ("ds_of_two", "tree 1: part 3"),
    ("ds_negative", "tree 0: part 2"), ("ds_not_a_number", "tree 0: part 4"),
    ("ds_true", "tree 1: part 1"), ("ds_short", "tree 1: ds"), ("ds_beside_trees", "'ds'"),
    ("sizes_short", "filter_sizes"), ("sizes_long", "filter_sizes"),
    ("size_zero", "filter 5"), ("size_of_three", "filter 2"), ("size_fraction", "filter 7"),
    ("maxsize_zero", "maxsize"), ("maxsize_one_number", "maxsize"),
    ("one_tree_ds_on_root", "part 0"), ("one_tree_ds_of_two", "part 17"),
    ("one_tree_sizes_short", "filter_sizes"),
    ("pyramid_unknown", "config star2: pyramid 'voc'"),
    ("pyramid_not_a_string", "config star2: pyramid ['dpm']"),
    ("pyramid_odd_sbin", "config star2: pyramid 'dpm' needs an even sbin of at least 4"),
    ("pyramid_small_sbin", "config star2: pyramid 'dpm' needs an even sbin of at least 4"),
    ("pyramid_no_octave_part", "config star2: pyramid 'dpm': tree 1 has no part at ds = 1"),
    ("one_tree_pyramid_no_octave_part", "config one26: pyramid 'dpm': tree 0 has no part")])
def test_a_malformed_size_or_octave_is_refused(tmp_path, change, names):
    """Each new key, malformed, is refused when the benchmark is loaded,
    by a SpecError that names the configuration and the part, filter or
    key at fault."""
    with pytest.raises(spec.SpecError, match=re.escape(names)):
        _small.add_config(tmp_path, _sized(change), traffics=("frame",))
