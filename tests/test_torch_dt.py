"""The torch port's distance transform against the JAX package.

`dt1d_plain` (what `dt1d` runs on a CPU tensor, and what the CUDA kernel
is held against on the card) evaluates (a*d + b)*d + src with every
operation rounded on its own. The JAX package's XLA path (what its
detector runs on the CPU) does the same, so there values and live
pointers must agree bit for bit. The Pallas kernels run in the
interpreter, as the JAX package's own tests run them on the CPU; there
XLA:CPU contracts a*d + b into a fused multiply-add, so their values
may differ in the last bit: live pointers must still agree exactly, and
values to float rounding. The envelope reference (float64) must give
identical pointers and values to 1e-4.
"""

import numpy as np
import pytest
import torch

from partsbaseddetector_tpu.ops import reference
from partsbaseddetector_tpu.ops.pallas_dt import NEG, dt1d_pallas, dt1d_sublane
from partsbaseddetector_tpu_torch.ops import distance_transform as tdt
from partsbaseddetector_tpu_torch.ops.dt_cuda import dt1d, dt1d_plain


def _maps(rng, bsz, h, w, nv=None):
    src = (rng.randn(bsz, h, w) * 3).astype(np.float32)
    if nv is not None:
        for i in range(bsz):
            src[i, nv[i]:] = -np.inf
    a = -(0.01 + 0.05 * rng.rand(bsz)).astype(np.float32)
    b = (0.3 * rng.randn(bsz)).astype(np.float32)
    sh = rng.randint(-3, 4, bsz).astype(np.float32)
    return src, a, b, sh


def _live(v):
    v = np.asarray(v)
    return np.isfinite(v) & (v > 0.5 * NEG)


def _assert_live_equal(got_v, got_p, want_v, want_p, exact=True):
    got_v, got_p = np.asarray(got_v), np.asarray(got_p)
    want_v, want_p = np.asarray(want_v), np.asarray(want_p)
    live = _live(want_v)
    np.testing.assert_array_equal(_live(got_v), live)
    if exact:
        np.testing.assert_array_equal(got_v[live], want_v[live])
    else:
        np.testing.assert_allclose(got_v[live], want_v[live], rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(got_p[live], want_p[live])


@pytest.mark.parametrize("with_aux", [False, True])
@pytest.mark.parametrize("with_nvalid", [False, True])
@pytest.mark.parametrize("h,w,dlen,step", [(23, 40, 23, 1), (30, 17, 14, 2)])
def test_dt1d_matches_sublane_kernel(h, w, dlen, step, with_nvalid, with_aux):
    rng = np.random.RandomState(h + w)
    bsz = 4
    nv = np.array([h, h - 5, 3, 0], np.int32) if with_nvalid else None
    src, a, b, sh = _maps(rng, bsz, h, w, nv)
    aux = rng.randint(0, 4096, (bsz, h, w)).astype(np.int32) if with_aux else None
    want_v, want_p = dt1d_sublane(
        src, a, b, sh, dlen, step, nvalid=nv, interpret=True, aux=aux
    )
    got_v, got_p = dt1d(
        torch.from_numpy(src), torch.from_numpy(a), torch.from_numpy(b),
        torch.from_numpy(sh), dlen, step,
        nvalid=None if nv is None else torch.from_numpy(nv),
        aux=None if aux is None else torch.from_numpy(aux),
    )
    assert got_v.shape == (bsz, dlen, w) and got_p.dtype == torch.int32
    _assert_live_equal(got_v, got_p, want_v, want_p, exact=False)
    # the port's sentinel: no live source -> -inf with pointer 0
    dead = ~np.isfinite(got_v.numpy())
    assert (got_v.numpy()[dead] == -np.inf).all()
    assert (got_p.numpy()[dead] == 0).all()


@pytest.mark.parametrize("with_aux", [False, True])
@pytest.mark.parametrize("n,dlen,step", [(50, 50, 1), (40, 20, 2), (9, 130, 1)])
def test_dt1d_transposed_matches_lane_kernel(n, dlen, step, with_aux):
    """K3 (the DT along the last axis) is the axis -2 kernel on the
    transposed map."""
    rng = np.random.RandomState(n)
    bsz = 6
    src, a, b, sh = _maps(rng, bsz, n, 1)
    src = src[..., 0]
    nv = rng.randint(1, n + 1, bsz).astype(np.int32)
    for i in range(bsz):
        src[i, nv[i]:] = -np.inf
    aux = rng.randint(0, 4096, (bsz, n)).astype(np.int32) if with_aux else None
    want_v, want_p = dt1d_pallas(
        src, a, b, sh, dlen, step, interpret=True, nvalid=nv, aux=aux
    )
    got_v, got_p = dt1d(
        torch.from_numpy(src)[..., None], torch.from_numpy(a),
        torch.from_numpy(b), torch.from_numpy(sh), dlen, step,
        nvalid=torch.from_numpy(nv),
        aux=None if aux is None else torch.from_numpy(aux)[..., None],
    )
    _assert_live_equal(
        got_v[..., 0], got_p[..., 0], want_v, want_p, exact=False
    )


@pytest.mark.parametrize("n,dlen,step,shift", [
    (50, 50, 1, 0), (130, 130, 1, -3), (40, 20, 2, 1),
])
def test_dt1d_matches_envelope(n, dlen, step, shift):
    rng = np.random.RandomState(0)
    bsz = 5
    src = (rng.randn(bsz, n) * 2).astype(np.float32)
    a = -(0.01 + 0.04 * rng.rand(bsz)).astype(np.float32)
    b = (0.02 * rng.randn(bsz)).astype(np.float32)
    out, ptr = dt1d(
        torch.from_numpy(src)[..., None], torch.from_numpy(a),
        torch.from_numpy(b), float(shift), dlen, step,
    )
    for i in range(bsz):
        want_v, want_p = reference.dt1d_envelope(
            src[i].astype(np.float64), float(a[i]), float(b[i]), shift,
            dlen, step,
        )
        np.testing.assert_allclose(out[i, :, 0].numpy(), want_v, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(ptr[i, :, 0].numpy(), want_p)


@pytest.mark.parametrize("step", [1, 2])
def test_dt1d_matches_xla_path_exactly(step):
    import jax.numpy as jnp
    from partsbaseddetector_tpu.ops.distance_transform import _dt1d

    rng = np.random.RandomState(40 + step)
    src, a, b, sh = _maps(rng, 5, 33, 7, nv=[33, 20, 9, 1, 0])
    src_t = np.ascontiguousarray(np.swapaxes(src, -1, -2))  # (B, W, H)
    want_v, want_p = _dt1d(
        jnp.asarray(src_t), jnp.asarray(a)[:, None], jnp.asarray(b)[:, None],
        jnp.asarray(sh)[:, None], 30, step, use_pallas=False,
    )
    got_v, got_p = dt1d(
        *map(torch.from_numpy, (src, a, b, sh)), 30, step,
        nvalid=torch.tensor([33, 20, 9, 1, 0]),
    )
    want_v = np.swapaxes(np.asarray(want_v), -1, -2)
    want_p = np.swapaxes(np.asarray(want_p), -1, -2)
    np.testing.assert_array_equal(got_v.numpy(), want_v)  # -inf included
    _assert_live_equal(got_v, got_p, want_v, want_p)


def test_dt1d_ties_go_to_smallest_source():
    """Integer sources and weights force exact ties: the first argmax
    (smallest v) must win, as in the envelope's strict comparison."""
    rng = np.random.RandomState(7)
    src = rng.randint(-3, 4, (3, 20, 11)).astype(np.float32)
    a = np.array([-1.0, -2.0, -1.0], np.float32)
    b = np.array([0.0, 1.0, -1.0], np.float32)
    sh = np.zeros(3, np.float32)
    want_v, want_p = dt1d_sublane(src, a, b, sh, 20, 1, interpret=True)
    got_v, got_p = dt1d(*map(torch.from_numpy, (src, a, b, sh)), 20, 1)
    _assert_live_equal(got_v, got_p, want_v, want_p)


def test_dt1d_plain_chunking_is_invisible():
    rng = np.random.RandomState(3)
    src, a, b, sh = (torch.from_numpy(x) for x in _maps(rng, 3, 12, 9))
    nv = torch.tensor([12, 5, 0], dtype=torch.int32)
    whole = dt1d_plain(src, a, b, sh, nv, 15, 1)
    rows = dt1d_plain(src, a, b, sh, nv, 15, 1, max_elems=1)
    assert torch.equal(whole[0], rows[0]) and torch.equal(whole[1], rows[1])


def _dt2d_inputs(seed):
    rng = np.random.RandomState(seed)
    G, S, M, H, W = 2, 3, 2, 14, 11
    score = (rng.randn(G, S, M, H, W) * 4).astype(np.float32)
    vh = np.zeros((G, S, M), np.int32)
    vw = np.zeros((G, S, M), np.int32)
    for g in range(G):
        for s in range(S):
            for m in range(M):
                vh[g, s, m] = rng.randint(6, H + 1)
                vw[g, s, m] = rng.randint(5, W + 1)
                score[g, s, m, vh[g, s, m]:, :] = -np.inf
                score[g, s, m, :, vw[g, s, m]:] = -np.inf
    wdef = (np.abs(rng.randn(G, 1, M, 4)) * 0.05 + 0.01).astype(np.float32)
    sx = rng.randint(-2, 3, (G, 1, M)).astype(np.float32)
    sy = rng.randint(-2, 3, (G, 1, M)).astype(np.float32)
    return score, wdef, sx, sy, vh, vw


@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("step,dlen_y,dlen_x", [(1, 12, 10), (2, 7, 6)])
def test_dt2d_matches_jax(impl, step, dlen_y, dlen_x, monkeypatch):
    import jax.numpy as jnp
    import partsbaseddetector_tpu.ops.distance_transform as jdt

    monkeypatch.setenv("PBD_DT_IMPL", impl)
    score, wdef, sx, sy, vh, vw = _dt2d_inputs(11 + step)
    want_m, want_p = jdt.shift_distance_transform_2d_packed(
        jnp.asarray(score), jnp.asarray(wdef), jnp.asarray(sx),
        jnp.asarray(sy), dlen_x=dlen_x, dlen_y=dlen_y, step=step,
        valid_h=vh, valid_w=vw,
    )
    got_m, got_p = tdt.shift_distance_transform_2d_packed(
        torch.from_numpy(score), torch.from_numpy(wdef),
        torch.from_numpy(sx), torch.from_numpy(sy), dlen_x, dlen_y, step,
        valid_h=torch.from_numpy(vh), valid_w=torch.from_numpy(vw),
    )
    assert got_m.shape == (2, 3, 2, dlen_y, dlen_x)
    _assert_live_equal(got_m, got_p, want_m, want_p, exact=impl == "xla")


def test_dt2d_matches_numpy_composition():
    """Semantic ground truth: the MATLAB/shiftdt composition Iy =
    tmpIy[Ix] of ops/reference.py::shift_dt_2d."""
    score, wdef, sx, sy, _, _ = _dt2d_inputs(5)
    score = np.where(np.isfinite(score), score, -1e30).astype(np.float32)
    got_m, got_p = tdt.shift_distance_transform_2d_packed(
        torch.from_numpy(score), torch.from_numpy(wdef),
        torch.from_numpy(sx), torch.from_numpy(sy), 10, 12,
    )
    for g, s, m in [(0, 0, 0), (1, 2, 1), (0, 1, 1)]:
        msg, ix, iy = reference.shift_dt_2d(
            score[g, s, m].astype(np.float64), wdef[g, 0, m].astype(np.float64),
            int(sx[g, 0, m]), int(sy[g, 0, m]), 10, 12,
        )
        ok = msg > -1e29
        np.testing.assert_allclose(got_m[g, s, m].numpy()[ok], msg[ok], rtol=1e-4, atol=1e-3)
        p = got_p[g, s, m].numpy()
        np.testing.assert_array_equal((p & 0xFFF)[ok], ix[ok])
        np.testing.assert_array_equal((p >> 12)[ok], iy[ok])
