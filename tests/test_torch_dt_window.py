"""The torch port's adaptive-window DT (K5) and the detect path that takes
it under PBD_DT_WINDOW=1, against the JAX package on the CPU.

On a CPU tensor `dt1d_window` runs `dt1d_window_plain`. The JAX window
kernel runs in the Pallas interpreter, as the JAX package's own tests
run it; there XLA:CPU contracts a*d + b into a fused multiply-add, so
values agree to rounding (rtol 1e-6, atol 1e-5) while live pointers must
agree exactly. Don't-care outputs (at or beyond out_valid) are
(float32 min, 0) in JAX and (-inf, 0) in the port.

Outputs beyond the consumer extents are masked to -inf downstream, so a
detect with the window DT must give the default detect's candidates
bit for bit.
"""

import numpy as np
import pytest
import torch

from partsbaseddetector_tpu import PartsBasedDetector as JaxDetector
from partsbaseddetector_tpu.models.model import make_synthetic_model
from partsbaseddetector_tpu.ops.pallas_dt import NEG, dt1d_pallas
from partsbaseddetector_tpu_torch import PartsBasedDetector
from partsbaseddetector_tpu_torch.models.convert import model_from_jax
from partsbaseddetector_tpu_torch.ops import distance_transform as tdt
from partsbaseddetector_tpu_torch.ops.dt_cuda import dt1d_window

RTOL, ATOL = 1e-6, 1e-5  # the interpreter's FMA against separate roundings


def _port_rows(src, a, b, sh, dlen, out_valid, aux=None):
    """The port's window DT on (B, N) rows: the rows become (B, N, 1)
    maps, so the DT runs along axis -2."""
    out, ptr = dt1d_window(
        torch.from_numpy(src)[..., None], torch.from_numpy(a),
        torch.from_numpy(b), torch.from_numpy(sh), dlen,
        torch.as_tensor(out_valid)[..., None],
        aux=None if aux is None else torch.from_numpy(aux)[..., None],
    )
    return out[..., 0].numpy(), ptr[..., 0].numpy()


def _assert_matches_jax(got_v, got_p, want_v, want_p, out_valid):
    want_v, want_p = np.asarray(want_v), np.asarray(want_p)
    i = np.arange(want_v.shape[1])[None, :]
    inside = i < np.asarray(out_valid).reshape(-1, 1)
    live = inside & (want_v > 0.5 * NEG)
    np.testing.assert_array_equal(np.isfinite(got_v), live)
    np.testing.assert_allclose(got_v[live], want_v[live], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got_p[live], want_p[live])
    # don't-care outputs: JAX (float32 min, 0), the port (-inf, 0)
    assert (want_v[~inside] == NEG).all() and (want_p[~inside] == 0).all()
    assert (got_v[~inside] == -np.inf).all() and (got_p[~inside] == 0).all()


@pytest.mark.parametrize("dlen,n", [(128, 100), (80, 150), (200, 200)])
def test_window_per_row_shifts_match_jax(dlen, n, monkeypatch):
    """tests/test_pallas_dt.py::test_window_kernel_per_row_shifts."""
    monkeypatch.setenv("PBD_DT_WINDOW", "1")
    rng = np.random.RandomState(3)
    bsz = 7
    src = (rng.randn(bsz, n) * 2).astype(np.float32)
    vw = np.array([n, n, 60, 60, 25, n, 5])
    for i in range(bsz):
        src[i, vw[i]:] = -np.inf
    a = -(0.01 + 0.04 * rng.rand(bsz)).astype(np.float32)
    b = (0.02 * rng.randn(bsz)).astype(np.float32)
    sh = rng.randint(-6, 7, size=bsz).astype(np.float32)
    want_v, want_p = dt1d_pallas(src, a, b, sh, dlen, 1, interpret=True)
    ov = np.full(bsz, dlen, np.int32)
    got_v, got_p = _port_rows(src, a, b, sh, dlen, ov)
    _assert_matches_jax(got_v, got_p, want_v, want_p, ov)


def test_window_out_valid_matches_jax(monkeypatch):
    """tests/test_pallas_dt.py::test_window_kernel_out_valid_masks_dont_care_lanes."""
    monkeypatch.setenv("PBD_DT_WINDOW", "1")
    rng = np.random.RandomState(4)
    bsz, n, dlen = 4, 120, 120
    src = (rng.randn(bsz, n) * 2).astype(np.float32)
    a = np.full(bsz, -0.02, np.float32)
    b = np.zeros(bsz, np.float32)
    sh = np.zeros(bsz, np.float32)
    ov = np.array([120, 80, 40, 0], np.int32)
    want_v, want_p = dt1d_pallas(src, a, b, sh, dlen, 1, interpret=True, out_valid=ov)
    got_v, got_p = _port_rows(src, a, b, sh, dlen, ov)
    _assert_matches_jax(got_v, got_p, want_v, want_p, ov)


def test_window_aux_matches_jax(monkeypatch):
    """tests/test_pallas_dt.py::test_window_kernel_aux_packing."""
    import jax.numpy as jnp

    monkeypatch.setenv("PBD_DT_WINDOW", "1")
    rng = np.random.RandomState(5)
    bsz, n, dlen = 3, 90, 100
    src = (rng.randn(bsz, n) * 2).astype(np.float32)
    aux = rng.randint(0, 4095, size=(bsz, n)).astype(np.int32)
    a = -(0.01 + 0.03 * rng.rand(bsz)).astype(np.float32)
    b = (0.02 * rng.randn(bsz)).astype(np.float32)
    sh = np.full(bsz, -2.0, np.float32)
    want_v, want_p = dt1d_pallas(
        src, a, b, sh, dlen, 1, interpret=True, aux=jnp.asarray(aux)
    )
    ov = np.full(bsz, dlen, np.int32)
    got_v, got_p = _port_rows(src, a, b, sh, dlen, ov, aux)
    _assert_matches_jax(got_v, got_p, want_v, want_p, ov)
    np.testing.assert_array_equal(got_p >> 12, np.take_along_axis(aux, got_p & 0xFFF, 1))


def _dt2d_case(seed):
    rng = np.random.RandomState(seed)
    G, S, M, H, W, hp, wp = 2, 3, 2, 14, 11, 12, 10
    score = (rng.randn(G, S, M, H, W) * 4).astype(np.float32)
    vh = rng.randint(6, H + 1, (G, S, M)).astype(np.int32)
    vw = rng.randint(5, W + 1, (G, S, M)).astype(np.int32)
    rows = np.arange(H)[:, None] < vh[..., None, None]
    cols = np.arange(W)[None, :] < vw[..., None, None]
    score = np.where(rows & cols, score, -np.inf).astype(np.float32)
    wdef = (np.abs(rng.randn(G, 1, M, 4)) * 0.05 + 0.01).astype(np.float32)
    sx = rng.randint(-2, 3, (G, 1, M)).astype(np.float32)
    sy = rng.randint(-2, 3, (G, 1, M)).astype(np.float32)
    # consumer extents as the DP builds them: a parent extent per (g, s)
    vh_par = rng.randint(0, hp + 1, (G, S))
    vw_par = rng.randint(0, wp + 1, (G, S))
    ovy = np.where(np.arange(W) < vw[..., None], vh_par[:, :, None, None], 0)
    ovx = np.where(np.arange(hp) < vh_par[..., None], vw_par[..., None], 0)[:, :, None]
    args = [torch.from_numpy(x) for x in (score, wdef, sx, sy)]
    return args, (hp, wp), (vh, vw), (ovy, ovx), (vh_par, vw_par)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_dt2d_with_out_valid_equals_without_on_the_valid_range(seed, monkeypatch):
    args, (hp, wp), (vh, vw), (ovy, ovx), (vh_par, vw_par) = _dt2d_case(seed)
    kw = dict(valid_h=torch.from_numpy(vh), valid_w=torch.from_numpy(vw))
    want_m, want_p = tdt.shift_distance_transform_2d_packed(*args, wp, hp, **kw)
    monkeypatch.setenv("PBD_DT_WINDOW", "1")
    got_m, got_p = tdt.shift_distance_transform_2d_packed(
        *args, wp, hp, out_valid_h=ovy, out_valid_w=ovx, **kw
    )
    rows = np.arange(hp)[:, None] < vh_par[:, :, None, None, None]
    cols = np.arange(wp)[None, :] < vw_par[:, :, None, None, None]
    inside = torch.from_numpy(rows & cols).expand_as(want_m)
    assert bool(inside.any()) and not bool(inside.all())
    assert torch.equal(got_m[inside], want_m[inside])
    assert torch.equal(got_p[inside], want_p[inside])


@pytest.mark.parametrize(
    "env,step,differentiable,with_ov,window",
    [
        ("1", 1, False, True, True),
        ("0", 1, False, True, False),
        ("1", 2, False, True, False),
        ("1", 1, True, True, False),
        ("1", 1, False, False, False),
    ],
)
def test_window_selection(env, step, differentiable, with_ov, window, monkeypatch):
    """K5 runs both passes exactly when PBD_DT_WINDOW=1, the consumer
    extents are given, the step is 1 and no gradient is asked for; every
    other call runs K1 (dt1d) for both passes."""
    monkeypatch.setenv("PBD_DT_WINDOW", env)
    calls = {"window": 0, "k1": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    # a pass without a gradient runs on the flattened maps (dt_maps),
    # one with a gradient through dt1d
    monkeypatch.setattr(tdt, "dt1d_window_flat", counting("window", tdt.dt1d_window_flat))
    monkeypatch.setattr(tdt, "dt1d_flat", counting("k1", tdt.dt1d_flat))
    monkeypatch.setattr(tdt, "dt1d", counting("k1", tdt.dt1d))
    args, (hp, wp), _, (ovy, ovx), _ = _dt2d_case(4)
    ov = dict(out_valid_h=ovy, out_valid_w=ovx) if with_ov else {}
    tdt.shift_distance_transform_2d_packed(
        *args, wp, hp, step=step, differentiable=differentiable, **ov
    )
    assert calls == ({"window": 2, "k1": 0} if window else {"window": 0, "k1": 2})


@pytest.mark.parametrize("bpo,border", [(1, "matlab"), (2, "matlab"), (1, "cpp")])
def test_window_root_maps_equal_default(bpo, border, monkeypatch):
    """Every root score and root mixture of every bucket, not only the
    top candidates: a consumer extent that is too small shows here."""
    from partsbaseddetector_tpu_torch.models import pack_model, to_device
    from partsbaseddetector_tpu_torch.pipeline import make_plan, root_scores

    # filters of unequal heights: a child taller than its parent has a
    # smaller valid extent than the rows the parent reads
    jm = make_synthetic_model(
        nparts=6, nmix=3, sbin=4, interval=4, seed=9,
        fsizes=[(2, 3), (5, 4), (3, 2)],
    )
    packed = pack_model(model_from_jax(jm), border=border)
    dmodel = to_device(packed, "cpu")
    im = torch.from_numpy(
        (np.random.RandomState(bpo).rand(70, 90, 3) * 255).astype(np.float32)
    )
    plan = make_plan(packed, (70, 90), bpo)
    want = root_scores(im, packed, dmodel, plan)
    monkeypatch.setenv("PBD_DT_WINDOW", "1")
    got = root_scores(im, packed, dmodel, plan)
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert torch.isfinite(w.rootv).any()
        assert torch.equal(g.rootv, w.rootv)
        assert torch.equal(g.rooti, w.rooti)


def _dense_equal(a, b):
    np.testing.assert_array_equal(a.valid, b.valid)
    v = a.valid
    for f in ("boxes", "scores", "components", "mixtures"):
        np.testing.assert_array_equal(getattr(a, f)[v], getattr(b, f)[v], err_msg=f)


@pytest.mark.parametrize("bpo,border", [(1, "matlab"), (2, "matlab"), (1, "cpp")])
def test_window_detect_equals_default_detect(bpo, border, monkeypatch):
    jm = make_synthetic_model(
        nparts=5, nmix=3, fsize=(3, 3), sbin=4, interval=4, thresh=-1e9, seed=7,
        fsizes=[(3, 3), (2, 3)],
    )
    im = (np.random.RandomState(bpo).rand(90, 110, 3) * 255).astype(np.uint8)
    det = PartsBasedDetector(
        model_from_jax(jm), max_detections=48, buckets_per_octave=bpo,
        border_mode=border, device="cpu",
    )
    want = det.detect_dense(im)
    monkeypatch.setenv("PBD_DT_WINDOW", "1")
    got = det.detect_dense(im)
    assert got.valid.sum() == 48
    _dense_equal(got, want)


def test_window_detect_matches_jax_detector(monkeypatch):
    """The model and image of tests/test_detector.py::
    test_detect_pallas_interpret_window_path: the port with the window
    DT against the JAX detector's default path."""
    jm = make_synthetic_model(
        nparts=3, nmix=2, fsize=(3, 3), sbin=4, interval=2, thresh=1.0, seed=73
    )
    im = (np.random.RandomState(2).rand(310, 290, 3) * 255).astype(np.float32)
    jm.thresh = -1e9
    want = JaxDetector(jm, max_detections=32).detect(im)
    monkeypatch.setenv("PBD_DT_WINDOW", "1")
    got = PartsBasedDetector(
        model_from_jax(jm), max_detections=32, device="cpu"
    ).detect(im)
    assert len(got) == len(want) == 32
    for g, w in zip(got, want):
        assert abs(g.score - w.score) < 2e-3
        np.testing.assert_allclose(g.parts, w.parts, atol=5e-2)
        assert g.component == w.component
        np.testing.assert_array_equal(g.mixtures, w.mixtures)
