"""The plain reference (benchmark/reference/pbd_tree.py) against the
NumPy loop semantics of the reference code (the port's frozen copy of
ops/reference.py, used here as an independent oracle), and the program's
CPU path against the reference through a whole run of each cell."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.reference import pbd_tree as ref
from benchmark.tests import _small
from partsbaseddetector_tpu_torch.ops import reference as loops


def test_resize_and_reduce_follow_the_weights():
    rng = np.random.RandomState(0)
    im = rng.randint(0, 256, (37, 45, 3)).astype(np.float32)
    got = ref.resize(torch.as_tensor(im), 0.8).numpy()
    want = loops.resize(im, 0.8).astype(np.float32)
    np.testing.assert_array_equal(got, want)
    got = ref.reduce(torch.as_tensor(im)).numpy()
    np.testing.assert_array_equal(got, loops.reduce(im).astype(np.float32))


@pytest.mark.parametrize("shape", [(24, 32), (29, 38)])
def test_hog_equals_the_loop_hog(shape):
    rng = np.random.RandomState(1)
    im = rng.randint(0, 256, (*shape, 3)).astype(np.float32)
    got = ref.hog(torch.as_tensor(im), 4).numpy()
    want = loops.hog(im, 4)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_distance_transform_equals_the_envelope_scan():
    rng = np.random.RandomState(2)
    src = rng.randn(2, 9, 11)
    defs = np.array([[0.03, 0.01, 0.02, -0.02], [0.05, -0.01, 0.01, 0.0]])
    shift = np.array([[3, 1], [0, 4]])
    got = ref.distance_transform(torch.as_tensor(src), torch.as_tensor(defs),
                                 torch.as_tensor(shift), 7, 10).numpy()
    for k in range(2):
        want, _, _ = loops.shift_dt_2d(src[k], defs[k], shift[k, 0], shift[k, 1], 10, 7)
        np.testing.assert_allclose(got[k], want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", ["person26.frame", "person26.batch"])
def test_the_program_is_correct_against_the_reference(name):
    out = _small.run(name)
    assert out["failed"] == 0 and out["seconds"]["answers_compared"] >= 1
    assert out["correct"], out["compared"]
