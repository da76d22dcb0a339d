"""The port's f32 re-score (`ops/rescore.py`) and its hybrid bf16 +
fp32-rescore profile against the JAX package, on the CPU.

The re-score functions take the same tables, responses, features and
placements in both packages and agree within 2e-5 (sums in other
orders). The f32 re-rank reproduces the f32 DP (detect.m:141-146), in
the port and in the JAX package alike.

The port's bf16 DP follows the JAX package's Pallas route (bf16
responses and weights, distance transforms widened to f32) on the CPU
too. With PBD_DT_IMPL=interpret the JAX package runs that route here
(its Pallas DT kernels in the interpreter), and the port's bf16
candidates equal its own: components, mixtures and boxes, scores within
1e-5 * max(1, |s|). Against the JAX package's default CPU route, the XLA
DT in bf16, they are held to `tests/test_rescore.py`'s tie-tolerant
invariants, against JAX's f32 and bf16 detectors: no score above the f32
optimum, placements shared with another detector scoring alike, and rank
ladders within bf16 plateau resolution.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from partsbaseddetector_tpu import PartsBasedDetector as JaxDetector
from partsbaseddetector_tpu.models.model import make_synthetic_model
from partsbaseddetector_tpu.models.model import pack_model as jpack
from partsbaseddetector_tpu.ops import rescore as jrescore
from partsbaseddetector_tpu.pipeline import make_plan as jmake_plan
from partsbaseddetector_tpu_torch import PartsBasedDetector
from partsbaseddetector_tpu_torch.depth import DepthGate
from partsbaseddetector_tpu_torch.models.convert import model_from_jax
from partsbaseddetector_tpu_torch.models.model import pack_model, to_device
from partsbaseddetector_tpu_torch.ops import rescore
from partsbaseddetector_tpu_torch.ops.pyramid import build_pyramid_features
from partsbaseddetector_tpu_torch.pipeline import make_plan, root_scores

BF16 = torch.bfloat16


def _im(h=120, w=150, seed=0):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


def _model(kind="chain5"):
    """The JAX tests' synthetic models: kind -> (jax model, image)."""
    if kind == "chain5":
        m = make_synthetic_model(thresh=-5.0, seed=3, nparts=5, nmix=2,
                                 interval=3, chain=True)
        return m, _im()
    if kind == "two_comp":
        m = make_synthetic_model(thresh=-5.0, seed=3, nparts=6, nmix=3,
                                 interval=2, ncomponents=2)
        return m, _im()
    if kind == "mixed_sizes":
        m = make_synthetic_model(thresh=-5.0, seed=3, nparts=4, nmix=2,
                                 interval=2, fsizes=[(5, 5), (4, 6), (3, 3)])
        return m, _im()
    if kind == "cpp":
        m = make_synthetic_model(nparts=3, nmix=2, fsize=(3, 3), interval=2,
                                 thresh=-8.0, seed=2, chain=True)
        return m, _im(96, 112, seed=5)
    # octave offset: part 3 one octave below its parent
    m = make_synthetic_model(nparts=4, nmix=2, interval=2, thresh=-8.0,
                             seed=7, chain=True)
    for d in m.defid[0][3]:
        m.anchors[d][2] = 1
        m.anchors[d][:2] *= 2
    return m, _im(130, 160, seed=9)


@pytest.mark.parametrize(
    "kind,border,bpo",
    [("chain5", "matlab", 1), ("two_comp", "matlab", 2), ("cpp", "cpp", 1),
     ("octave", "matlab", 1)],
)
def test_rescore_tables_match_jax(kind, border, bpo):
    jm, im = _model(kind)
    jp = jpack(jm, border=border)
    tp = pack_model(model_from_jax(jm), border=border)
    want = jrescore.build_rescore_tables(jp, jmake_plan(jp, im.shape[:2], bpo), bpo)
    got = rescore.build_rescore_tables(tp, make_plan(tp, im.shape[:2], bpo), bpo)
    assert got._fields == want._fields
    for name in want._fields:
        w, g = getattr(want, name), getattr(got, name)
        if name == "bpo":
            assert g == w
        else:
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)


def _placements(tables, plan, rng, k=40):
    """Random placements inside each bucket's response grid: component,
    root bucket (one that every part's octave offset can reach), scale,
    per-part coordinates and mixtures."""
    nc, pm = tables.parent.shape
    mm = tables.filterid.shape[2]
    comps = rng.randint(0, nc, k)
    lo = tables.ds.max(axis=1)[comps] * tables.bpo
    bid = np.asarray([rng.randint(l, len(plan.buckets)) for l in lo])
    si = np.asarray([rng.randint(0, len(plan.buckets[b].scale_indices)) for b in bid])
    hr = np.asarray([plan.buckets[b].resp_h for b in bid])[:, None]
    wr = np.asarray([plan.buckets[b].resp_w for b in bid])[:, None]
    xs = (rng.rand(k, pm) * wr).astype(np.int32)
    ys = (rng.rand(k, pm) * hr).astype(np.int32)
    ms = rng.randint(0, mm, (k, pm))
    return [a.astype(np.int32) for a in (comps, bid, si, xs, ys, ms)]


@pytest.mark.parametrize(
    "kind,border,bpo", [("chain5", "matlab", 1), ("two_comp", "cpp", 2), ("octave", "matlab", 1)]
)
def test_rescore_functions_match_jax(kind, border, bpo):
    """rescore_from_responses on the port's raw f32 responses and
    rescore_placements on its features give JAX's scores within 2e-5 and
    its boxes within 1e-4 on the same random placements."""
    jm, im = _model(kind)
    tp = pack_model(model_from_jax(jm), border=border)
    plan = make_plan(tp, im.shape[:2], bpo)
    dm = to_device(tp, "cpu")
    frame = torch.as_tensor(im)
    resps = []
    root_scores(frame, tp, dm, plan, collect_responses=resps)
    feats = build_pyramid_features(frame[None].float(), plan, tp.spec)
    tables = rescore.build_rescore_tables(tp, plan, bpo)
    place = _placements(tables, plan, np.random.RandomState(bpo))
    off = (-1, -1) if border == "cpp" else (-tp.spec.padx, -tp.spec.pady)
    tt = rescore.tables_on(tables, "cpu")
    cand = [torch.as_tensor(a)[None] for a in place]
    jcand = [jnp.asarray(a) for a in place]
    got = [
        rescore.rescore_from_responses(resps, tt, *cand, *off),
        rescore.rescore_placements(feats, dm.filters, tt, *cand, *off),
    ]
    want = [
        jrescore.rescore_from_responses(
            [jnp.asarray(r[0].numpy()) for r in resps], tables, *jcand, *off),
        jrescore.rescore_placements(
            [jnp.asarray(f[0].numpy()) for f in feats], jnp.asarray(tp.filters),
            tables, *jcand, *off),
    ]
    for (gs, gb), (ws, wb) in zip(got, want):
        np.testing.assert_allclose(gs[0].numpy(), np.asarray(ws), rtol=0, atol=2e-5)
        np.testing.assert_allclose(gb[0].numpy(), np.asarray(wb), rtol=0, atol=1e-4)
    # the two formulations agree with each other
    np.testing.assert_allclose(got[0][0].numpy(), got[1][0].numpy(), rtol=0, atol=2e-5)


def _same(a, b, score_tol=2e-5, box_tol=1e-4):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.component == y.component
        assert abs(x.score - y.score) < score_tol, (x.score, y.score)
        np.testing.assert_allclose(x.parts, y.parts, rtol=0, atol=box_tol)
        np.testing.assert_array_equal(x.mixtures, y.mixtures)


@pytest.mark.parametrize(
    "kind,border,bpo",
    [("chain5", "matlab", 1), ("cpp", "cpp", 1), ("octave", "matlab", 1),
     ("two_comp", "matlab", 2), ("mixed_sizes", "matlab", 1)],
)
def test_f32_rerank_is_identity(kind, border, bpo):
    """Re-scoring f32 placements in f32 reproduces the port's f32 DP
    scores and boxes, and JAX's re-rank gives the same candidates."""
    jm, im = _model(kind)
    tm = model_from_jax(jm)
    kw = dict(max_detections=64 if kind != "cpp" else 32, border_mode=border,
              buckets_per_octave=bpo)
    base = PartsBasedDetector(tm, device="cpu", **kw).detect(im)
    rr = PartsBasedDetector(tm, device="cpu", rerank_fp32=True, **kw).detect(im)
    _same(rr, base)
    _same(rr, JaxDetector(jm, rerank_fp32=True, **kw).detect(im))


@pytest.fixture(scope="module")
def chain5():
    jm, im = _model("chain5")
    tm = model_from_jax(jm)
    kw = dict(max_detections=64)
    return dict(
        tm=tm, im=im,
        bf16=PartsBasedDetector(tm, device="cpu", dtype=BF16, **kw).detect(im),
        f32=PartsBasedDetector(tm, device="cpu", **kw).detect(im),
        jax_f32=JaxDetector(jm, **kw).detect(im),
        jax_bf16=JaxDetector(jm, dtype=jnp.bfloat16, **kw).detect(im),
    )


def _key(c):
    # a placement: boxes AND mixtures
    return np.round(np.asarray(c.parts), 2).tobytes() + np.asarray(c.mixtures).tobytes()


@pytest.mark.parametrize("other", ["f32", "jax_f32", "jax_bf16"])
def test_bf16_scores_are_fp32_reconstructions(chain5, other):
    """No bf16 score beats the f32 optimum; a placement the other
    detector also found scores the same within 2e-4."""
    b, ref = chain5["bf16"], chain5[other]
    assert len(b) > 0
    assert b[0].score <= chain5["jax_f32"][0].score + 1e-4
    assert ref[0].score <= chain5["jax_f32"][0].score + 1e-4
    by_key = {_key(x): x.score for x in ref}
    matched = [abs(y.score - by_key[_key(y)]) for y in b if _key(y) in by_key]
    assert matched, "expected placements shared with " + other
    assert max(matched) < 2e-4
    for y in b[:10]:
        p = np.asarray(y.parts, np.float64)
        assert np.all(p[:, 2] - p[:, 0] + 1 > 0)


@pytest.mark.parametrize("other", ["f32", "jax_f32", "jax_bf16"])
def test_rerank_mismatches_are_ties(chain5, other):
    """Rank ladders agree within bf16 plateau resolution at every rank,
    and no bf16 candidate beats the f32 ladder at its rank."""
    a, b = chain5[other], chain5["bf16"]
    n = min(len(a), len(b))
    assert n >= 5
    sa = np.asarray([c.score for c in a[:n]], np.float64)
    sb = np.asarray([c.score for c in b[:n]], np.float64)
    assert np.all(np.abs(sa - sb) <= 0.02 * np.maximum(1.0, np.abs(sa)))
    f32 = np.asarray([c.score for c in chain5["jax_f32"][:n]], np.float64)
    assert np.all(sb <= f32 + 1e-3)


@pytest.mark.parametrize("kind", ["chain5", "octave"])
def test_bf16_equals_jax_pallas_route(monkeypatch, kind):
    """The route the port copies, run by the JAX package itself: its
    bf16 detector with the Pallas DT kernels in the interpreter (bf16
    sources widened to f32 in the wrapper) gives the port's bf16
    candidates, rank by rank. An f32 DP under the re-rank would differ
    at a near-tie in the selection."""
    monkeypatch.setenv("PBD_DT_IMPL", "interpret")
    jm, im = _model(kind)
    kw = dict(max_detections=64)
    want = JaxDetector(jm, dtype=jnp.bfloat16, **kw).detect(im)
    got = PartsBasedDetector(model_from_jax(jm), device="cpu", dtype=BF16,
                             **kw).detect(im)
    assert len(got) == len(want) == 64
    for x, y in zip(got, want):
        assert x.component == y.component
        np.testing.assert_array_equal(x.mixtures, y.mixtures)
        np.testing.assert_allclose(x.parts, y.parts, rtol=0, atol=1e-4)
        assert abs(x.score - y.score) <= 1e-5 * max(1.0, abs(y.score))


def test_bf16_rerank_composes_with_nms(chain5):
    det = PartsBasedDetector(chain5["tm"], max_detections=64, device="cpu",
                             dtype=BF16, nms_overlap=0.3)
    cands = det.detect(chain5["im"])
    assert 0 < len(cands) < len(chain5["bf16"])
    scores = [c.score for c in cands]
    assert scores == sorted(scores, reverse=True)


def test_bf16_serving_apis_equal_detect(chain5):
    """detect_batch and the batched program (detect_many, microbatch 2
    with padding) carry the re-rank: each frame's candidates equal the
    per-frame bf16 detect's."""
    det = PartsBasedDetector(chain5["tm"], max_detections=32, device="cpu",
                             dtype=BF16)
    ims = [np.clip(chain5["im"].astype(np.int32) + 7 * i, 0, 255).astype(np.uint8)
           for i in range(3)]
    singles = [det.detect(x) for x in ims]
    for got in (det.detect_batch(ims), det.detect_many(ims, microbatch=2)):
        assert len(got) == 3
        for g, s in zip(got, singles):
            _same(g, s, score_tol=1e-5 * max(1.0, abs(s[0].score)))


def test_bf16_depth_gated_detect_runs(chain5):
    """The gate, the device keep mask and the host filter with bf16
    depth maps."""
    im = chain5["im"]
    depth = ((1.0 + np.random.RandomState(2).rand(*im.shape[:2])) * 1000).astype(np.uint16)
    gate = DepthGate(object_width_m=0.6, fx=10.0, tolerance=0.5)
    for kw in (dict(depth_gate=gate, device_depth_filter=True), dict(depth_gate=gate), {}):
        det = PartsBasedDetector(chain5["tm"], max_detections=32, device="cpu",
                                 dtype=BF16, **kw)
        dense = det.detect_dense(im, depth)
        assert np.isfinite(dense.scores[dense.valid]).all()
        assert (dense.depth_keep is not None) == bool(kw.get("device_depth_filter"))
        cands = det.detect(im, depth)
        assert all(np.isfinite(c.score) for c in cands)


def test_root_scores_collects_raw_f32_responses():
    """collect_responses gathers the conv's raw responses before the cast
    and the masking; the DP's responses are bf16 and its root scores f32
    (bf16 responses plus f32 messages)."""
    jm, im = _model("chain5")
    tp = pack_model(model_from_jax(jm))
    plan = make_plan(tp, im.shape[:2])
    dm = to_device(tp, "cpu")
    frame = torch.as_tensor(im)
    r32, rbf = [], []
    sc32 = root_scores(frame, tp, dm, plan, collect_responses=r32)
    scbf = root_scores(frame, tp, dm, plan, dtype=BF16, collect_responses=rbf)
    assert len(r32) == len(plan.buckets)
    for a, b in zip(r32, rbf):
        assert a.dtype == b.dtype == torch.float32 and torch.isfinite(a).all()
        assert torch.equal(a, b)
    for a, b in zip(sc32, scbf):
        assert b.rootv.dtype == torch.float32
        live = torch.isfinite(a.rootv)
        assert torch.equal(live, torch.isfinite(b.rootv))
        assert (a.rootv[live] - b.rootv[live]).abs().max() < 0.05
    with pytest.raises(NotImplementedError):
        root_scores(frame, tp, dm, plan, dtype=torch.float16)
