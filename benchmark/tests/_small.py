"""Small sizes for the benchmark's CPU tests: the cells' own code on the
program's CPU path, at frames and pools a test run can hold."""

from __future__ import annotations

import time

import torch

from benchmark.lib import cell, spec as spec_mod

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
