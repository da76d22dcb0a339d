"""The order of K4's sums (csrc/dt1d_bwd.cu), stated in torch by
ops/dt_cuda.py::dt1d_bwd_order_plain, against the plain backward and the
JAX package.

The kernel gives each warp one 32-column strip of a round of strips and
one contiguous segment of a map's output rows, scatters each segment
into the warp's own slab and adds a strip's slabs in segment order; g_a
and g_b go per lane, then by a shuffle tree, then by warp. The card tests hold the kernel to this statement bit for bit.
Here, on the CPU, the statement itself is held to dt1d_bwd_plain and to
the JAX package's gradients (the interpreted Pallas kernel's custom VJP,
`_diff_dt`, and autodiff of the XLA path) within the magnitude rule of
chip_smoke.py: 1e-5 * sum|g| per source, 1e-5 * sum|g*d^2| and sum|g*d|
per map, since only the order of the sums differs. Where every sum is
exact (small integers) it equals dt1d_bwd_plain bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partsbaseddetector_tpu.ops import distance_transform as jdt
from partsbaseddetector_tpu.ops.pallas_dt import dt1d_pallas
from partsbaseddetector_tpu_torch.ops import dt_cuda

RTOL = 1e-5  # chip_smoke.py's DT_BWD_RTOL, times dt1d_bwd_magnitudes


def _case(seed, bsz, h, w, dlen, step=1, aux=False, ints=False, dead=False):
    """Seeded maps through the port's forward on the CPU: the argument
    tuple of dt1d_bwd, (g, out, ptr, shift, h, step, has_aux)."""
    rng = np.random.RandomState(seed)
    if ints:
        src = rng.randint(-4, 5, (bsz, h, w)).astype(np.float32)
        a = -rng.randint(1, 3, bsz).astype(np.float32)
        b = rng.randint(-2, 3, bsz).astype(np.float32)
        g = rng.randint(-3, 4, (bsz, dlen, w)).astype(np.float32)
    else:
        src = (rng.randn(bsz, h, w) * 3).astype(np.float32)
        a = -(0.01 + 0.05 * rng.rand(bsz)).astype(np.float32)
        b = (0.3 * rng.randn(bsz)).astype(np.float32)
        g = rng.randn(bsz, dlen, w).astype(np.float32)
    shift = rng.randint(-3, 4, bsz).astype(np.float32)
    nvalid = np.full(bsz, h, np.int32)
    if dead:
        nvalid[::2] = 0
    ax = torch.from_numpy(rng.randint(0, 4096, (bsz, h, w)).astype(np.int32)) if aux else None
    t = [torch.from_numpy(x) for x in (src, a, b, shift, nvalid, g)]
    out, ptr = dt_cuda.dt1d(*t[:4], dlen, step, nvalid=t[4], aux=ax)
    assert bool((out == -torch.inf).any()) == dead
    return (t[5], out, ptr, t[3], h, step, aux)


CASES = {
    "ypass": dict(bsz=4, h=40, w=50, dlen=37),
    "xpass_aux": dict(bsz=4, h=50, w=40, dlen=45, aux=True),
    "step2": dict(bsz=3, h=36, w=20, dlen=15, step=2),
    "dead_outputs_aux": dict(bsz=4, h=30, w=33, dlen=30, aux=True, dead=True),
    "narrow_and_short": dict(bsz=3, h=9, w=5, dlen=6),
}


# (strips a round takes, segments per strip)
LAYOUTS = [(1, 1), (1, 3), (2, 4), (3, 2)]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_order_matches_plain_within_the_magnitude_rule(name, layout):
    args = _case(sum(map(ord, name)) + sum(layout), **CASES[name])
    got = dt_cuda.dt1d_bwd_order_plain(*args, *layout)
    want = dt_cuda.dt1d_bwd_plain(*args)
    scale = dt_cuda.dt1d_bwd_magnitudes(*args)
    for x, y, m in zip(got, want, scale):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert bool(((x - y).abs() <= RTOL * m).all())


@pytest.mark.parametrize("layout", LAYOUTS + [(2, 5)])
def test_order_is_plain_bit_for_bit_where_sums_are_exact(layout):
    """Small integers: every partial sum is exact, so the order cannot
    show, and the statement equals the plain backward bit for bit (dead
    outputs, aux pointers and step 2 included)."""
    for kw in (dict(aux=True, dead=True), dict(step=2)):
        args = _case(sum(layout), 5, 24, 70, 19, ints=True, **kw)
        for x, y in zip(dt_cuda.dt1d_bwd_order_plain(*args, *layout),
                        dt_cuda.dt1d_bwd_plain(*args)):
            assert torch.equal(x, y)


def test_order_follows_the_row_segments():
    """One source, four rows whose sum depends on its order: one segment
    adds them in row order, two add two two-row slabs."""
    g = torch.tensor([1.0, 1e8, -1e8, 1.0]).reshape(1, 4, 1)
    out = torch.zeros((1, 4, 1))
    ptr = torch.zeros((1, 4, 1), dtype=torch.int32)
    sh = torch.zeros(1)
    one = dt_cuda.dt1d_bwd_order_plain(g, out, ptr, sh, 1, 1, False, 1, 1)
    two = dt_cuda.dt1d_bwd_order_plain(g, out, ptr, sh, 1, 1, False, 1, 2)
    plain = dt_cuda.dt1d_bwd_plain(g, out, ptr, sh, 1, 1, False)
    assert one[0].item() == 1.0 and plain[0].item() == 1.0  # ((1 + 1e8) - 1e8) + 1
    assert two[0].item() == 0.0  # (1 + 1e8) + (-1e8 + 1)
    # d = i, so g_b adds 0, 1e8, -2e8 and 3 in row order
    assert one[2].item() == np.float32(np.float32(np.float32(1e8) - np.float32(2e8)) + 3)


def test_layout_follows_the_warps_and_the_slab_budget():
    """Every strip at once where they fit, then segments; the
    global-memory path where one slab does not fit."""
    top = dt_cuda.DT1D_BWD_SLAB_BYTES // 128
    assert dt_cuda.DT1D_BWD_MAX_WARPS == 8
    assert dt_cuda.dt1d_bwd_layout(66, 86, 66) == (3, 2)  # the train pair
    assert dt_cuda.dt1d_bwd_layout(86, 66, 86) == (3, 2)
    assert dt_cuda.dt1d_bwd_layout(66, 20, 66) == (1, 8)
    assert dt_cuda.dt1d_bwd_layout(66, 20, 5) == (1, 5)  # no more segments than rows
    assert dt_cuda.dt1d_bwd_layout(66, 300, 66) == (8, 1)  # ten strips in two rounds
    assert dt_cuda.dt1d_bwd_layout(500, 86, 100) == (3, 1)  # three 64,000-byte slabs
    assert dt_cuda.dt1d_bwd_layout(top, 86, 50) == (1, 1)
    assert dt_cuda.dt1d_bwd_layout(top + 1, 86, 50) == (0, 1)  # global memory
    g, out, ptr, sh, h, step, aux = _case(3, 2, 12, 70, 9)
    got = dt_cuda.dt1d_bwd_order_plain(g, out, ptr, sh, h, step, aux)
    want = dt_cuda.dt1d_bwd_order_plain(g, out, ptr, sh, h, step, aux, 3, 2)
    assert all(torch.equal(x, y) for x, y in zip(got, want))  # the default


@pytest.mark.parametrize("layout", [(1, 1), (1, 4), (3, 2)])
@pytest.mark.parametrize("with_aux", [False, True])
def test_order_matches_jax_vjp(with_aux, layout):
    """The JAX package's two gradients of sum(out * cot) w.r.t. src, a
    and b (the Pallas kernel's custom VJP in interpret mode, and XLA
    autodiff), against the statement of K4's order on the transposed
    maps (the port's DT runs along axis -2, the JAX one along the last
    axis)."""
    bsz, n, w, dlen, step = 4, 21, 70, 19, 1
    rng = np.random.RandomState(40 + sum(layout) + 2 * with_aux)
    src = (rng.randn(bsz, w, n) * 3).astype(np.float32)  # JAX layout
    a = -(0.01 + 0.05 * rng.rand(bsz)).astype(np.float32)
    b = (0.3 * rng.randn(bsz)).astype(np.float32)
    sh = rng.randint(-3, 4, bsz).astype(np.float32)
    aux = rng.randint(0, 4096, (bsz, w, n)).astype(np.int32) if with_aux else None
    cot = rng.randn(bsz, w, dlen).astype(np.float32)

    t = lambda x: torch.from_numpy(np.ascontiguousarray(np.swapaxes(x, -1, -2)))
    out, ptr = dt_cuda.dt1d(t(src), torch.from_numpy(a), torch.from_numpy(b),
                            torch.from_numpy(sh), dlen, step,
                            aux=None if aux is None else t(aux))
    args = (t(cot), out, ptr, torch.from_numpy(sh), n, step, with_aux)
    got = dt_cuda.dt1d_bwd_order_plain(*args, *layout)
    scale = dt_cuda.dt1d_bwd_magnitudes(*args)

    a2, b2, sh2 = (jnp.asarray(x)[:, None] for x in (a, b, sh))

    def loss_pallas(s, a_, b_):
        o, _ = dt1d_pallas(s, a_, b_, sh2, dlen, step, interpret=True, differentiable=True,
                           aux=None if aux is None else jnp.asarray(aux))
        return jnp.sum(o * cot)

    def loss_xla(s, a_, b_):
        o, _ = jdt._dt1d(s, a_, b_, sh2, dlen, step, use_pallas=False)
        return jnp.sum(o * cot)

    for loss in (loss_pallas, loss_xla):
        want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(src), a2, b2)
        want = [np.swapaxes(np.asarray(want[0]), -1, -2), np.asarray(want[1])[:, 0],
                np.asarray(want[2])[:, 0]]
        for x, y, m in zip(got, want, scale):
            assert x.shape == y.shape
            assert bool(((x - torch.tensor(y)).abs() <= RTOL * m).all())
