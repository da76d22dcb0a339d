"""The benchmark of partsbaseddetector_tpu_torch on one NVIDIA H100.

    python3 benchmark/run.py --workload person26.frame --seed 7 --seconds 40 --trace 0

Runs one cell of BENCHMARK.json (at the root of the checkout) from the
root of a checkout: makes the model and the frames from --seed, warms
up the cell's shapes, drives the cell's traffic for --seconds, compares
what the timed path returned with the plain reference, and prints one
JSON object as the last line of standard output:

    {"correct", "attempted", "failed", "metrics", "device",
     ["breakdown"], "seconds", "compared"}

--trace 0 reports the cell's end-to-end metrics, --trace 1 its
per-layer metrics, from the window and one profiled request after it
(the window still runs and is compared). "compared" holds each number compared with
the reference beside its limit; the same lines end standard error.

Exit codes: 0 with a result; 2 without a CUDA device (or fewer than
the cell asks for); 3 if jax, jaxlib, flax or the JAX package were
loaded; 4 if the profiler lost kernel records. Build caches stay inside
the checkout (build/).
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "partsbaseddetector_tpu")
THREADS = "4"


def cache_dirs() -> None:
    """Every build and kernel cache at a fixed place inside the checkout."""
    cache = ROOT / "build" / "bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(cache / "nv"))
    os.environ.setdefault("OMP_NUM_THREADS", THREADS)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    sys.path.insert(0, str(ROOT))
    from benchmark.lib import cell, spec as spec_mod, trace

    spec = spec_mod.load(ROOT / "BENCHMARK.json", ROOT / "benchmark")
    chips = spec.workload(args.workload).chips
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(int(THREADS))
    try:
        out = cell.run(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                       "cuda", T0)
    except trace.IncompleteProfile as e:
        print(f"incomplete profile: {e}", file=sys.stderr)
        return 4
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    for k, v in out["compared"].items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
