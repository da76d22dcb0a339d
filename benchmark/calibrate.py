"""The readings that the limits of `correct` are set from.

    python3 benchmark/calibrate.py --workload person26.frame \
        --seeds 11,12,13 --control-seeds 21,22,23 --seconds 5

For each seed, one run of the cell as run.py makes it (a window of
--seconds, the answers of the sampled frames against the reference),
all in one process: first the program as the configuration states it,
then, for each control seed, the control: the program's plain bf16
profile (bfloat16 pyramid, HOG, correlation and DP, no f32 re-score), the
nearest precision below the configuration's float32. Prints one JSON
line a run, then a summary: for each number compared, the largest the
program read (the lower reading) and the smallest the control read (the
upper reading). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control() -> dict:
    """The detector arguments of the control: the plain bf16 profile."""
    import torch

    return {"dtype": torch.bfloat16, "rerank_fp32": False}


def collect(name: str, seeds, control_seeds, seconds: float, device="cuda",
            emit=print, **run_kw):
    """Run the program on `seeds` and the control on `control_seeds`;
    returns (program compared numbers, control compared numbers), one
    dict a run."""
    from benchmark.lib import cell, spec as spec_mod

    spec = spec_mod.load(ROOT / "BENCHMARK.json", ROOT / "benchmark")
    sides = {"program": [], "control": []}
    for side, seed_list, overrides in (("program", seeds, None),
                                       ("control", control_seeds, control())):
        for seed in seed_list:
            out = cell.run(spec, name, seed, seconds, False, device, time.perf_counter(),
                           overrides=overrides, **run_kw)
            numbers = {k: v["value"] for k, v in out["compared"].items()}
            sides[side].append(numbers)
            emit(json.dumps({"workload": name, "side": side, "seed": seed,
                             "correct": out["correct"], "compared": numbers,
                             "seconds": out["seconds"]}))
    return sides["program"], sides["control"]


def summary(program, control) -> dict:
    big = lambda v: math.inf if v is None else v
    keys = program[0].keys() if program else control[0].keys()
    return {k: {"lower": max((big(r[k]) for r in program), default=None),
                "upper": min((big(r[k]) for r in control), default=None)} for k in keys}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    program, ctrl = collect(args.workload, seeds, control, args.seconds)
    print(json.dumps({"workload": args.workload, "summary": summary(program, ctrl)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
