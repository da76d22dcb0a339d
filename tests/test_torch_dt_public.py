"""The torch port's public 2-D distance transforms against the JAX
package's, on the CPU, and the port's `ops` and `utils` re-exports.

`shift_distance_transform_2d` and `distance_transform_2d` of both
packages run on the same seeded numpy inputs, the JAX package as its own
CPU tests run it (tests/test_distance_transform.py: its XLA path), the
port on CPU tensors (the plain versions of K1, K3's x pass and T2).
Values agree within 1e-5 (absolute and relative) and the pointers
exactly; the port's (Ix, Iy) are the fields of its packed pointers.
"""

import ast
import os

import numpy as np
import pytest
import torch

import partsbaseddetector_tpu_torch.ops as tops
import partsbaseddetector_tpu_torch.utils as tutils
from partsbaseddetector_tpu.ops import distance_transform as jdt
from partsbaseddetector_tpu_torch.ops import distance_transform as tdt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
W = np.array([0.03, -0.01, 0.02, 0.015], dtype=np.float32)
# the JAX package's public names that the port does not carry under the
# same name (ROADMAP.md, "Not carried over"): the port has no jit
RENAMED = {"time_jitted": "time_fn"}


def _assert_same(got, want):
    gm, gx, gy = (t.numpy() for t in got)
    wm, wx, wy = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(np.isfinite(gm), np.isfinite(wm))
    live = np.isfinite(wm)
    np.testing.assert_allclose(gm[live], wm[live], **TOL)
    np.testing.assert_array_equal(gx, wx)
    np.testing.assert_array_equal(gy, wy)


def _packed_fields(score, wdef, *args):
    """The port's packed pointer of the same call, split into (Ix, Iy)."""
    _, ptr = tdt.shift_distance_transform_2d_packed(score, wdef, *args)
    return ptr & 0xFFF, ptr >> 12


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("sx,sy,dlx,dly,step", [
    (0, 0, 17, 13, 1), (2, -1, 10, 8, 1), (-2, 3, 17, 13, 1), (1, 1, 8, 6, 2),
    (-1, 0, 9, 7, 2),
])
def test_shift_dt_matches_jax(seed, sx, sy, dlx, dly, step):
    """tests/test_distance_transform.py::test_2d_jax_matches_reference."""
    score = np.random.RandomState(seed).randn(13, 17).astype(np.float32)
    got = tops.shift_distance_transform_2d(
        torch.from_numpy(score), torch.from_numpy(W), sx, sy, dlx, dly, step)
    want = jdt.shift_distance_transform_2d(
        score, W, np.int32(sx), np.int32(sy), dlx, dly, step)
    _assert_same(got, want)
    ix, iy = _packed_fields(torch.from_numpy(score), torch.from_numpy(W),
                            sx, sy, dlx, dly, step)
    assert torch.equal(got[1], ix) and torch.equal(got[2], iy)


@pytest.mark.parametrize("step", [1, 2])
def test_batched_per_mixture_params_match_jax(step):
    """tests/test_distance_transform.py::test_2d_batched_per_mixture_params,
    with per-map live extents (valid_h, valid_w) on a second batch axis."""
    rng = np.random.RandomState(7)
    k = 3
    scores = rng.randn(2, k, 11, 9).astype(np.float32)
    wdef = (np.abs(rng.rand(k, 4) * 0.05) + 0.01).astype(np.float32)
    wdef[:, 1] = rng.randn(k) * 0.01
    wdef[:, 3] = rng.randn(k) * 0.01
    sx = np.array([0, 2, -1], dtype=np.int32)
    sy = np.array([1, 0, -2], dtype=np.int32)
    valid_h = np.array([[11, 7, 9], [5, 11, 11]], dtype=np.int32)
    valid_w = np.array([[9, 9, 4], [6, 8, 9]], dtype=np.int32)
    rows = np.arange(11)[None, None, :, None] < valid_h[..., None, None]
    cols = np.arange(9)[None, None, None, :] < valid_w[..., None, None]
    scores = np.where(rows & cols, scores, -np.inf).astype(np.float32)
    dlx, dly = (9, 11) if step == 1 else (5, 6)
    for vh, vw in ((None, None), (valid_h, valid_w)):
        got = tops.shift_distance_transform_2d(
            torch.from_numpy(scores), torch.from_numpy(wdef), sx, sy, dlx, dly,
            step, None if vh is None else torch.from_numpy(vh),
            None if vw is None else torch.from_numpy(vw))
        want = jdt.shift_distance_transform_2d(
            scores, wdef, sx, sy, dlx, dly, step, vh, vw)
        _assert_same(got, want)


def test_neg_inf_sources_never_win_as_in_jax():
    """tests/test_distance_transform.py::test_neg_inf_sources_never_win,
    and the same on a map with several live sources among -inf ones."""
    score = np.full((6, 6), -np.inf, dtype=np.float32)
    score[2, 3] = 1.0
    w = np.array([0.01, 0.0, 0.01, 0.0], dtype=np.float32)
    got = tops.distance_transform_2d(torch.from_numpy(score), torch.from_numpy(w), 0, 0)
    assert bool((got[1] == 3).all()) and bool((got[2] == 2).all())
    assert bool(torch.isfinite(got[0]).all())
    _assert_same(got, jdt.distance_transform_2d(score, w, np.int32(0), np.int32(0)))
    rng = np.random.RandomState(11)
    score = np.where(rng.rand(2, 10, 12) < 0.8, -np.inf,
                     rng.randn(2, 10, 12)).astype(np.float32)
    score[:, 0, 0] = 0.5  # every map keeps a live source
    got = tops.distance_transform_2d(torch.from_numpy(score), torch.from_numpy(W), 1, -1)
    live = np.isfinite(score)
    ys, xs = got[2].numpy(), got[1].numpy()
    assert live[np.arange(2)[:, None, None], ys, xs].all()
    _assert_same(got, jdt.distance_transform_2d(score, W, np.int32(1), np.int32(-1)))


def _exported(path: str) -> set:
    """The names a package's __init__.py imports (its re-exports)."""
    tree = ast.parse(open(os.path.join(ROOT, path)).read())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
    return names


@pytest.mark.parametrize("jax_init,port", [
    ("partsbaseddetector_tpu/ops/__init__.py", tops),
    ("partsbaseddetector_tpu/utils/__init__.py", tutils),
])
def test_ops_and_utils_export_the_jax_packages_names(jax_init, port):
    names = _exported(jax_init)
    assert names, jax_init
    missing = [n for n in names if not hasattr(port, RENAMED.get(n, n))]
    assert not missing, missing
    for old, new in RENAMED.items():
        if old in names:
            assert not hasattr(port, old) and callable(getattr(port, new))
