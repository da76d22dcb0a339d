"""Small sizes for the benchmark's CPU tests: the cells' own code on the
program's CPU path, at frames and pools a test run can hold; and a model
of three trees over a shared pool, added to a copy of the benchmark as
new files only."""

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


def trees3_config() -> dict:
    """person26's file in the component form, with TREES3's model."""
    cfg = {k: v for k, v in spec_mod.load().config("person26").items()
           if k not in ("parts", "parents", "components")}
    return {**cfg, "name": "trees3", **copy.deepcopy(TREES3)}


def add_trees3(root: Path, cfg: dict = None) -> spec_mod.Spec:
    """A copy of the benchmark under `root` with the configuration
    `trees3` and its cells trees3.frame and trees3.batch added as new
    files and entries (each cell under its person26 sibling's metrics
    and limits)."""
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = root / "benchmark"
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (b / "configs/trees3.json").write_text(json.dumps(cfg or trees3_config()))
    bench["configs"].append({"name": "trees3", "source": "a test", "reduced": [],
                             "file": "benchmark/configs/trees3.json", "why": "a test"})
    for traffic in ("frame", "batch"):
        name = f"trees3.{traffic}"
        shutil.copy(b / f"limits/person26.{traffic}.json", b / f"limits/{name}.json")
        bench["workloads"].append({"name": name, "config": "trees3", "traffic": traffic,
                                   "chips": 1, "why": "a test"})
        for m in bench["end_to_end"]:
            if f"person26.{traffic}" in m.get("workloads", ()):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return spec_mod.load(root / "BENCHMARK.json", b)


def run_in(spec, name: str, seed: int = SEED):
    """One run of a cell of `spec` on the CPU at 60x80 frames."""
    torch.set_num_threads(4)
    traffic = spec.workload(name).traffic
    return cell.run(spec, name, seed, 0.0, False, "cpu", time.perf_counter(),
                    config_overrides={"frame_h": 60, "frame_w": 80},
                    traffic_overrides=POOL[traffic])
