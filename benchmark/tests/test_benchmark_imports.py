"""No module that a run of any cell loads is jax, jaxlib, flax or the
JAX package (`partsbaseddetector_tpu`), compared by whole top-level name
(the port's name begins with the JAX package's); and the reference side
(the plain reference, the comparison, the inputs, the work arithmetic)
loads nothing of the port. Each in a fresh subprocess."""

from __future__ import annotations

import json
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "partsbaseddetector_tpu"}


def _loaded(script: str) -> set:
    code = textwrap.dedent(script) + textwrap.dedent("""
        import json, sys
        print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, env={"PATH": "/usr/bin:/bin",
                                                      "HOME": str(ROOT / "build")})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_of_every_cell_loads_no_jax():
    loaded = _loaded("""
        import sys
        sys.path.insert(0, ".")
        import torch
        torch.set_num_threads(2)
        from benchmark.lib import spec
        from benchmark.tests import _small
        for name in spec.load().workloads:
            out = _small.run(name, frame={"frame_h": 60, "frame_w": 80})
            assert out["seconds"]["answers_compared"] >= 1, name
        for m in spec.load().metrics:
            spec.load_module(m.reader_path(), "metric_" + m.name)
    """)
    assert "partsbaseddetector_tpu_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_reference_side_loads_nothing_of_the_port():
    loaded = _loaded("""
        import sys
        sys.path.insert(0, ".")
        from benchmark.lib import compare, inputs, spec, work
        s = spec.load()
        for c in s.configs:
            spec.load_module(s.reference_path(s.config(c)), "reference")
    """)
    assert not loaded & (FORBIDDEN | {"partsbaseddetector_tpu_torch"}), loaded
