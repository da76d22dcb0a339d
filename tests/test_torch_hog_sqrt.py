"""The CPU HOG's square roots are correctly rounded on every call.

On the CPU torch.sqrt can take a vector math library whose accuracy
depends on the call: in a fresh multi-threaded process the first HOG's
`mag` was seen up to 3,895 ulp off NumPy's correctly rounded sqrt on a
few thousand pixels (about 1 process in 6), and every later call 1 ulp
off on some. `ops/hog.py::sqrt_f32` and `rsqrt_f32` take them in a form
whose bits depend neither on the threads nor on the call.

The case: person26 at 120x160, buckets_per_octave=2, the frame
RandomState(0).rand(120, 160, 3) * 255 as uint8, in fresh processes with
the default (multi-threaded) torch thread pool. Each process records
every `mag` and `inv` of its first detect and holds them bit for bit to
NumPy's sqrt and 1 / sqrt in f32, then holds the first detect's
candidates bit for bit to the second's."""

import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent(
    """
    import numpy as np
    import torch

    from partsbaseddetector_tpu_torch import PartsBasedDetector, make_person_like_model
    from partsbaseddetector_tpu_torch.ops import hog

    assert torch.get_num_threads() > 1, torch.get_num_threads()
    calls = {"sqrt": [], "rsqrt": []}
    sqrt0, rsqrt0 = hog.sqrt_f32, hog.rsqrt_f32

    def sqrt_rec(x):
        y = sqrt0(x)
        calls["sqrt"].append((x.numpy().copy(), y.numpy().copy()))
        return y

    def rsqrt_rec(x):
        y = rsqrt0(x)
        calls["rsqrt"].append((x.numpy().copy(), y.numpy().copy()))
        return y

    hog.sqrt_f32, hog.rsqrt_f32 = sqrt_rec, rsqrt_rec
    det = PartsBasedDetector(make_person_like_model(), buckets_per_octave=2,
                             device="cpu")
    im = (np.random.RandomState(0).rand(120, 160, 3) * 255).astype(np.uint8)
    first = det.detect(im)
    hog.sqrt_f32, hog.rsqrt_f32 = sqrt0, rsqrt0
    assert calls["sqrt"] and calls["rsqrt"]
    for x, y in calls["sqrt"]:
        assert x.dtype == y.dtype == np.float32
        np.testing.assert_array_equal(y.view(np.int32), np.sqrt(x).view(np.int32))
    for x, y in calls["rsqrt"]:
        want = np.float32(1.0) / np.sqrt(x)
        np.testing.assert_array_equal(y.view(np.int32), want.view(np.int32))
    second = det.detect(im)
    assert len(first) == len(second) > 0
    for a, b in zip(first, second):
        assert a.score == b.score and a.component == b.component
        np.testing.assert_array_equal(np.asarray(a.parts), np.asarray(b.parts))
    print("ok", len(calls["sqrt"]), len(first))
    """
)


@pytest.mark.parametrize("process", range(8))
def test_first_cpu_hog_is_correctly_rounded(process):
    env = {k: v for k, v in os.environ.items()
           if k not in ("OMP_NUM_THREADS", "MKL_NUM_THREADS")}
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.split()[0] == "ok", proc.stdout
