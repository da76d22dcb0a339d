"""One --trace 1 run of a cell (run.py's arguments), then the span
measurement its readers made (lib/spans.py): every stage's span ms an
image, the spans' cover of the root, the profiled detect's device ops by
stage and its idle gaps named by span, which the result line has no
room for.

    python3 benchmark/spans_report.py --workload person26.frame --seed 7 --seconds 10 --trace 1

Prints run.py's result line, then one JSON line of the measurement.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv) -> int:
    sys.path.insert(0, str(ROOT))
    from benchmark import run
    from benchmark.lib import spans

    run.T0 = T0
    rc = run.main(argv)
    print(json.dumps(spans._MEASURED.get(argv[argv.index("--workload") + 1])),
          flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
