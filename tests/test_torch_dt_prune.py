"""The chunk-pruning rule of the DT kernel (csrc/dt1d.cu), stated in torch
by ops/dt_cuda.py::dt1d_chunk_keep_plain, against the brute force.

The kernel evaluates candidates chunk by chunk and skips a chunk of
source rows when the rule says no source in it can reach any of a
thread's outputs. It stays equal to dt1d_plain bit for bit (values, the
smallest winning source) as long as every source that reaches an
output's maximum lies in a chunk the rule keeps. That is what these
tests assert, on the CPU, for the cases where a wrong bound would show:
integer ties, a < 0, a = 0 and a > 0, non-integral shifts, step 2, -inf
tails, dead maps, dlen > H, and runs and chunks that do not divide the
map. The plain DT itself is held against the JAX package here too, on
the same inputs, so that the winners are the reference's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partsbaseddetector_tpu.ops.distance_transform import _dt1d
from partsbaseddetector_tpu_torch.ops import dt_cuda


def _inputs(seed, bsz, h, w, kind, shift_kind="int", tail=False, dead=False):
    rng = np.random.RandomState(seed)
    if kind == "ties":  # small integers: many exact ties
        src = rng.randint(-4, 5, (bsz, h, w)).astype(np.float32)
        a = -rng.randint(1, 3, bsz).astype(np.float32)
        b = rng.randint(-2, 3, bsz).astype(np.float32)
    else:
        src = (rng.randn(bsz, h, w) * 3).astype(np.float32)
        mag = (0.01 + 0.05 * rng.rand(bsz)).astype(np.float32)
        a = {"neg": -mag, "zero": 0 * mag, "pos": mag}[kind]
        b = (0.3 * rng.randn(bsz)).astype(np.float32)
    if shift_kind == "int":
        shift = rng.randint(-3, 4, bsz).astype(np.float32)
    else:
        shift = (rng.rand(bsz) * 6 - 3).astype(np.float32)
    nvalid = np.full(bsz, h, np.int32)
    if tail:
        nvalid = rng.randint(1, h + 1, bsz).astype(np.int32)
    if dead:
        nvalid[::2] = 0
    src = np.where(np.arange(h)[None, :, None] < nvalid[:, None, None], src, -np.inf)
    return tuple(torch.from_numpy(x) for x in (src.astype(np.float32), a, b, shift, nvalid))


def _winners(src, a, b, shift, nvalid, dlen, step):
    """(B, dlen, H, W) bool: the sources that reach each output's
    maximum, from the candidate values as dt1d_plain rounds them."""
    bsz, h, w = src.shape
    v = torch.arange(h, dtype=torch.float32)
    i = torch.arange(dlen, dtype=torch.float32)
    d = (shift[:, None] + step * i)[:, :, None] - v
    pen = (a[:, None, None] * d + b[:, None, None]) * d
    live = torch.arange(h)[None, :] < nvalid[:, None]
    srcm = torch.where(live[:, :, None], src, torch.full((), -torch.inf))
    vals = pen[..., None] + srcm[:, None]
    best = vals.amax(dim=2, keepdim=True)
    return (vals == best) & torch.isfinite(best), best[:, :, 0]


def _check(args, dlen, step=1, rows=dt_cuda.DT1D_ROWS, chunk=dt_cuda.DT1D_CHUNK):
    src, a, b, shift, nvalid = args
    bsz, h, w = src.shape
    keep = dt_cuda.dt1d_chunk_keep_plain(*args, dlen, step, rows, chunk)
    nruns, nchunks = -(-dlen // rows), -(-h // chunk)
    assert keep.shape == (bsz, nruns, nchunks, w) and keep.dtype == torch.bool
    wins, best = _winners(*args, dlen, step)
    # the brute force here is dt1d_plain's: same values, first winner
    out, ptr = dt_cuda.dt1d_plain(*args, dlen, step)
    assert torch.equal(out, best)
    assert bool(torch.gather(wins, 2, ptr.long()[:, :, None])[:, :, 0][torch.isfinite(out)].all())
    # keep, per output row and source row
    run_of = torch.arange(dlen) // rows
    chunk_of = torch.arange(h) // chunk
    kept = keep[:, run_of][:, :, chunk_of]  # (B, dlen, H, W)
    lost = wins & ~kept
    assert not bool(lost.any()), f"{int(lost.sum())} winning sources in dropped chunks"
    # no chunk beyond the live sources is kept
    dead = (torch.arange(nchunks) * chunk)[None, :] >= nvalid[:, None]
    assert not bool(keep[dead[:, None, :, None].expand_as(keep)].any())
    return keep


CASES = {
    "neg_a": dict(kind="neg", bsz=4, h=40, w=9, dlen=37),
    "ties": dict(kind="ties", bsz=4, h=24, w=12, dlen=24),
    "a_zero": dict(kind="zero", bsz=3, h=30, w=7, dlen=30),
    "a_positive": dict(kind="pos", bsz=3, h=30, w=7, dlen=30),
    "fractional_shift": dict(kind="neg", bsz=4, h=35, w=6, dlen=33, shift_kind="frac"),
    "step2": dict(kind="neg", bsz=3, h=36, w=8, dlen=15, step=2),
    "step2_fractional": dict(kind="ties", bsz=3, h=36, w=8, dlen=15, step=2,
                             shift_kind="frac"),
    "inf_tails": dict(kind="neg", bsz=5, h=40, w=6, dlen=40, tail=True),
    "dead_maps": dict(kind="neg", bsz=4, h=30, w=5, dlen=30, tail=True, dead=True),
    "dlen_beyond_h": dict(kind="neg", bsz=3, h=20, w=6, dlen=45),
    "ragged_run_and_chunk": dict(kind="ties", bsz=3, h=37, w=5, dlen=29),
    "narrow_and_short": dict(kind="neg", bsz=2, h=5, w=1, dlen=3),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_winner_lies_in_a_kept_chunk(name):
    case = dict(CASES[name])
    dlen, step = case.pop("dlen"), case.pop("step", 1)
    args = _inputs(sum(map(ord, name)), **case)
    _check(args, dlen, step)


@pytest.mark.parametrize("rows,chunk", [(4, 8), (8, 32), (1, 4)])
def test_rule_holds_for_other_run_and_chunk_sizes(rows, chunk):
    args = _inputs(rows * chunk, 3, 50, 6, "neg", tail=True)
    _check(args, 44, 1, rows, chunk)


def test_rule_drops_far_chunks():
    """Not vacuous: with a stiff spring the far chunks are dropped, and a
    chunk that holds a run's own rows never is."""
    args = _inputs(7, 4, 96, 8, "neg")
    src, a, b, shift, nvalid = args
    a = a * 4
    keep = _check((src, a, b, shift, nvalid), 96)
    assert float(keep.float().mean()) < 0.6
    for run in range(keep.shape[1]):
        own = min(max(run * dt_cuda.DT1D_ROWS // dt_cuda.DT1D_CHUNK, 0), keep.shape[2] - 1)
        assert bool(keep[:, run, own].all())


def test_plain_winners_are_the_jax_package_s():
    """The brute force the rule is held against is the reference's: the
    plain DT's values and pointers equal the JAX package's XLA path on
    the same inputs (integer ties included)."""
    for kind in ("neg", "ties"):
        src, a, b, shift, nvalid = _inputs(11, 3, 24, 10, kind)
        out, ptr = dt_cuda.dt1d_plain(src, a, b, shift, nvalid, 24, 1)
        src_t = np.ascontiguousarray(np.swapaxes(src.numpy(), -1, -2))  # (B, W, H)
        jout, jptr = _dt1d(
            jnp.asarray(src_t), jnp.asarray(a.numpy())[:, None],
            jnp.asarray(b.numpy())[:, None], jnp.asarray(shift.numpy())[:, None],
            24, 1, use_pallas=False,
        )
        np.testing.assert_array_equal(out.numpy(), np.swapaxes(np.asarray(jout), -1, -2))
        np.testing.assert_array_equal(ptr.numpy(), np.swapaxes(np.asarray(jptr), -1, -2))


def test_rule_never_drops_a_winner():
    """The same assertion over drawn shapes, sizes, springs and shifts."""
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies

    @hypothesis.settings(max_examples=40, deadline=None, database=None)
    @hypothesis.given(
        seed=st.integers(0, 2**16),
        h=st.integers(1, 50),
        w=st.integers(1, 5),
        dlen=st.integers(1, 60),
        step=st.sampled_from([1, 1, 2, 3]),
        kind=st.sampled_from(["neg", "ties", "zero", "pos"]),
        shift_kind=st.sampled_from(["int", "frac"]),
        tail=st.booleans(),
        dead=st.booleans(),
        sizes=st.sampled_from([(8, 16), (4, 8), (2, 4)]),
    )
    def prop(seed, h, w, dlen, step, kind, shift_kind, tail, dead, sizes):
        args = _inputs(seed, 3, h, w, kind, shift_kind, tail, dead)
        _check(args, dlen, step, *sizes)

    prop()
