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


# The window form (K5, csrc/dt1d_window.cu on the same core): with
# out_valid (B, W), only the rows i < out_valid[b, w] must be exact, and
# only they set a run's seed window, threshold and displacement interval.


def _out_valid(seed, bsz, w, dlen):
    """Per-column extents that include 0 and dlen and cut runs mid-way."""
    ov = np.random.RandomState(seed + 1).randint(0, dlen + 1, (bsz, w)).astype(np.int32)
    ov[:, 0] = 0
    if w > 1:
        ov[:, 1] = dlen
    return torch.from_numpy(ov)


def _lost_live_winners(keep, args, ov, dlen, step, rows, chunk):
    """How many (output, winning source) pairs at live outputs (i <
    out_valid) the kept chunks miss."""
    h = args[0].shape[1]
    wins, _ = _winners(*args, dlen, step)
    run_of = torch.arange(dlen) // rows
    chunk_of = torch.arange(h) // chunk
    kept = keep[:, run_of][:, :, chunk_of]  # (B, dlen, H, W)
    live = (torch.arange(dlen)[None, :, None] < ov[:, None, :])[:, :, None, :]
    return int((wins & ~kept & live).sum())


def _check_window(args, ov, dlen, step=1, rows=dt_cuda.DT1D_ROWS, chunk=dt_cuda.DT1D_CHUNK):
    keep = dt_cuda.dt1d_chunk_keep_plain(*args, dlen, step, rows, chunk, out_valid=ov)
    bsz, h, w = args[0].shape
    assert keep.shape == (bsz, -(-dlen // rows), -(-h // chunk), w)
    assert _lost_live_winners(keep, args, ov, dlen, step, rows, chunk) == 0
    # a run with no live row keeps nothing
    first = torch.arange(keep.shape[1]) * rows
    no_live = first[None, :, None] >= ov.long()[:, None, :]  # (B, R, W)
    assert not bool(keep[no_live[:, :, None, :].expand_as(keep)].any())
    return keep


@pytest.mark.parametrize("name", sorted(CASES))
def test_window_winner_lies_in_a_kept_chunk(name):
    case = dict(CASES[name])
    dlen, step = case.pop("dlen"), case.pop("step", 1)
    seed = sum(map(ord, name))
    args = _inputs(seed, **case)
    _check_window(args, _out_valid(seed, args[0].shape[0], args[0].shape[2], dlen), dlen, step)


def test_window_rule_at_full_extent_is_k1_rule():
    """out_valid = dlen everywhere: every row is live, and the rule is K1's."""
    for kind in ("neg", "ties"):
        args = _inputs(5, 4, 45, 9, kind, tail=True)
        ov = torch.full((4, 9), 40, dtype=torch.int32)
        k1 = dt_cuda.dt1d_chunk_keep_plain(*args, 40)
        assert torch.equal(dt_cuda.dt1d_chunk_keep_plain(*args, 40, out_valid=ov), k1)
        assert torch.equal(dt_cuda.dt1d_chunk_keep_plain(*args, 40, out_valid=ov + 7), k1)


def test_window_rule_on_person26_passes():
    """The y and x pass of the largest group of a person26 detect with
    the window DT (120x160 on the CPU), as ops/distance_transform.py
    gives them to K5: no live winner is lost, and with about a third of
    the outputs don't-care the window form keeps fewer chunks than K1's
    rule on the same maps."""
    from partsbaseddetector_tpu_torch import PartsBasedDetector, make_person_like_model
    from partsbaseddetector_tpu_torch.tools.kernel_variants import window_passes

    det = PartsBasedDetector(make_person_like_model(), buckets_per_octave=2, device="cpu")
    im = np.random.RandomState(0).randint(0, 256, (120, 160, 3)).astype(np.uint8)
    for src, a, b, shift, nvalid, ov, dlen, _ in window_passes(torch, det, im):
        args = (src, a, b, shift, nvalid)
        dont_care = float((torch.arange(dlen)[None, :, None] >= ov[:, None, :]).float().mean())
        assert 0.2 < dont_care < 0.5
        keep = _check_window(args, ov, dlen)
        assert int(keep.sum()) < int(dt_cuda.dt1d_chunk_keep_plain(*args, dlen).sum())


def test_window_rule_fails_when_dont_care_rows_set_the_threshold():
    """Not vacuous: a mutant whose seed window, threshold and interval
    come from the rows at or beyond out_valid (instead of those before
    it) drops chunks that hold live winners, on maps where a steep
    spring keeps the live rows' winners apart from the don't-care rows'."""
    lost = 0
    for seed in range(6):
        args = _inputs(seed, 4, 48, 16, "neg")
        src, a, b, shift, nvalid = args
        args = (src, a * 20, b, shift, nvalid)
        dlen, rows, chunk = 48, 8, 4
        ov = _out_valid(seed, 4, 16, dlen)
        first = torch.arange(-(-dlen // rows)) * rows
        n_in = (dlen - first).clamp(max=rows)[None, :, None].expand(4, -1, 16)
        n_live = torch.minimum(n_in, (ov.long()[:, None, :] - first[:, None]).clamp(min=0))
        assert _lost_live_winners(
            dt_cuda.chunk_keep_rows(*args, 1, rows, chunk, torch.zeros_like(n_live), n_live),
            args, ov, dlen, 1, rows, chunk) == 0
        mutant = dt_cuda.chunk_keep_rows(*args, 1, rows, chunk, n_live, n_in)
        lost += _lost_live_winners(mutant, args, ov, dlen, 1, rows, chunk)
    assert lost > 0


def test_window_rule_never_drops_a_winner():
    """The window form over drawn shapes, springs, extents and sizes."""
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies

    @hypothesis.settings(max_examples=40, deadline=None, database=None)
    @hypothesis.given(
        seed=st.integers(0, 2**16),
        h=st.integers(1, 50),
        w=st.integers(1, 5),
        dlen=st.integers(1, 60),
        kind=st.sampled_from(["neg", "ties", "zero", "pos"]),
        tail=st.booleans(),
        dead=st.booleans(),
        sizes=st.sampled_from([(8, 16), (4, 8), (2, 4)]),
    )
    def prop(seed, h, w, dlen, kind, tail, dead, sizes):
        args = _inputs(seed, 3, h, w, kind, "int", tail, dead)
        _check_window(args, _out_valid(seed, 3, w, dlen), dlen, 1, *sizes)

    prop()
