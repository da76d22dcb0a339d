"""Small sizes for the benchmark's CPU tests: the cells' own code on the
program's CPU path, at frames and pools a test run can hold; and two
models added to a copy of the benchmark as new files only: three trees
over a shared pool, and a two-resolution star of filters of several
sizes, on either form of the pyramid."""

from __future__ import annotations

import copy
import json
import shutil
import time
from pathlib import Path

import torch

from benchmark.lib import cell, spec as spec_mod

ROOT = Path(__file__).resolve().parents[2]

FRAME = {"frame_h": 120, "frame_w": 160}
POOL = {"frame": {"pool": 4, "compare_frames": 2},
        "batch": {"pool": 8, "microbatch": 4, "trace_frames": 4, "compare_frames": 8}}
SEED = 2**31 + 12345


def run(name: str, seed: int = SEED, overrides=None, frame=FRAME, seconds: float = 0.0):
    """One run of a cell on the CPU: at least one request, then the
    comparison with the reference."""
    torch.set_num_threads(4)
    spec = spec_mod.load()
    traffic = spec.workload(name).traffic
    return cell.run(spec, name, seed, seconds, False, "cpu", time.perf_counter(),
                    overrides=overrides, config_overrides=frame,
                    traffic_overrides=POOL[traffic])


# three components over a pool of 9 filters (15 part nodes, K = 1): two
# trees of 6 parts, of depth 3 and 5, and one of 3 parts, of depth 1;
# filters 1, 2, 3, 4, 6 and 8 are shared between trees
TREES3 = {"pool": 9, "mixtures": 1, "thresh": 0.0, "trees": [
    {"parents": [0, 0, 1, 1, 2, 3], "filters": [[0], [1], [2], [3], [4], [5]]},
    {"parents": [0, 0, 1, 2, 3, 4], "filters": [[6], [1], [2], [7], [4], [8]]},
    {"parents": [0, 0, 0], "filters": [[6], [3], [8]]},
]}


# two components (K = 1) over a pool of 12: roots of their own sizes
# (filter 0, 6x4; filter 1, 4x6), each with four 3x3 parts one octave
# finer (ds = 1) and a 3x3 grandchild under its first part on that part's
# level (ds = 0 under a ds = 1 part: a step-1 DT on the finer grid)
STAR2 = {"pool": 12, "mixtures": 1, "thresh": 0.0,
         "filter_sizes": [[6, 4], [4, 6]] + [[3, 3]] * 10, "trees": [
             {"parents": [0, 0, 0, 0, 0, 1], "filters": [[0], [2], [3], [4], [5], [6]],
              "ds": [0, 1, 1, 1, 1, 0]},
             {"parents": [0, 0, 0, 0, 0, 1], "filters": [[1], [7], [8], [9], [10], [11]],
              "ds": [0, 1, 1, 1, 1, 0]},
         ]}


def _component_form(name: str, model: dict, drop=()) -> dict:
    cfg = {k: v for k, v in spec_mod.load().config("person26").items()
           if k not in ("parts", "parents", "components", *drop)}
    return {**cfg, "name": name, **copy.deepcopy(model)}


def trees3_config() -> dict:
    """person26's file in the component form, with TREES3's model."""
    return _component_form("trees3", TREES3)


def star2_config() -> dict:
    """person26's file in the component form, with STAR2's model and no
    filter_h and filter_w: its sizes are its own."""
    return _component_form("star2", STAR2, drop=("filter_h", "filter_w"))


def star2_dpm_config() -> dict:
    """star2_config, its pyramid in voc-release4's form (an octave of HOG
    at half the cell size first)."""
    return {**star2_config(), "name": "star2dpm", "pyramid": "dpm"}


def add_config(root: Path, cfg: dict, traffics=("frame", "batch")) -> spec_mod.Spec:
    """A copy of the benchmark under `root` with the configuration `cfg`
    and its cells <name>.<traffic> added as new files and entries (each
    cell under its person26 sibling's metrics and limits)."""
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = root / "benchmark"
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = cfg["name"]
    (b / f"configs/{config}.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": config, "source": "a test", "reduced": [],
                             "file": f"benchmark/configs/{config}.json", "why": "a test"})
    for traffic in traffics:
        name = f"{config}.{traffic}"
        shutil.copy(b / f"limits/person26.{traffic}.json", b / f"limits/{name}.json")
        bench["workloads"].append({"name": name, "config": config, "traffic": traffic,
                                   "chips": 1, "why": "a test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if f"person26.{traffic}" in m.get("workloads", ()):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return spec_mod.load(root / "BENCHMARK.json", b)


def add_trees3(root: Path, cfg: dict = None) -> spec_mod.Spec:
    """add_config of `trees3` (or `cfg`, named trees3) and its cells
    trees3.frame and trees3.batch."""
    return add_config(root, cfg or trees3_config())


def run_in(spec, name: str, seed: int = SEED, overrides=None, frame=None):
    """One run of a cell of `spec` on the CPU, at 60x80 frames unless
    `frame` says otherwise."""
    torch.set_num_threads(4)
    traffic = spec.workload(name).traffic
    return cell.run(spec, name, seed, 0.0, False, "cpu", time.perf_counter(),
                    overrides=overrides, config_overrides=frame or {"frame_h": 60, "frame_w": 80},
                    traffic_overrides=POOL[traffic])
