"""The plain bf16 profile (bf16 without the f32 re-rank) and the bf16
miner against the JAX package, on the CPU.

`PartsBasedDetector(dtype=bfloat16, rerank_fp32=False)` follows the JAX
package's route: float frames travel in bf16, the pyramid and HOG run in
bf16 (the resize and tent maps as bf16 matrix products: weights rounded
to bf16, f32 sums, each pass rounded to bf16), the conv is the library's
bf16 conv2d (the JAX package's lax.conv), and the DP runs in bf16 with
its distance transforms widened to f32; no re-score. Placements are
matched by box (boxes rounded to 0.01 and mixtures), as
tests/test_torch_rescore.py matches the hybrid profile:

  - against the JAX package's default CPU route (its XLA DT in bf16):
    at least 13 of the top 16 candidates match (13 measured), and
    matched scores differ by at most 0.05 (about three bf16 spacings at
    the scores' magnitude; 0.033 measured);
  - against its Pallas route (PBD_DT_IMPL=interpret: the DT widened to
    f32, as the port's): all 16 match, scores within 2**-8 * max(1, |s|)
    (0.0078 measured).

The bf16 miner (`TPUMiner(dtype=bfloat16)`) runs the JAX miner's call,
root_scores with the f32 pools as params and -1e10 masking in bf16:
at least 13 of its 16 placements (level, component, mixtures, part
coordinates) are the JAX bf16 miner's (13 measured), scores within 0.05,
and its latent-positive placement is the JAX one.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from partsbaseddetector_tpu import PartsBasedDetector as JaxDetector
from partsbaseddetector_tpu.models.model import make_synthetic_model
from partsbaseddetector_tpu.train.detect_tpu import TPUMiner as JaxMiner
from partsbaseddetector_tpu_torch import PartsBasedDetector
from partsbaseddetector_tpu_torch.models.convert import model_from_jax
from partsbaseddetector_tpu_torch.models.model import pack_model, to_device
from partsbaseddetector_tpu_torch.ops.pyramid import build_pyramid_features
from partsbaseddetector_tpu_torch.pipeline import make_plan, root_scores
from partsbaseddetector_tpu_torch.train.detect_tpu import TPUMiner
from partsbaseddetector_tpu_torch.train.sgd import model_params

BF16 = torch.bfloat16
TOP = 16
MIN_MATCHED = 13
SCORE_TOL = 0.05


def _jmodel():
    return make_synthetic_model(thresh=-5.0, seed=3, nparts=5, nmix=2,
                                interval=3, chain=True)


def _im(seed=0, h=120, w=150):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


def _plain(model, **kw):
    return PartsBasedDetector(model, max_detections=TOP, dtype=BF16,
                              rerank_fp32=False, device="cpu", **kw)


def _key(c):
    return np.round(np.asarray(c.parts), 2).tobytes() + np.asarray(c.mixtures).tobytes()


def _matched(got, want):
    by_key = {_key(c): c.score for c in want}
    return [abs(c.score - by_key[_key(c)]) for c in got if _key(c) in by_key]


@pytest.fixture(scope="module")
def plain():
    jm = _jmodel()
    return jm, _plain(model_from_jax(jm)).detect(_im())


def test_bf16_plain_matches_the_jax_default_route(plain):
    jm, got = plain
    want = JaxDetector(jm, max_detections=TOP, dtype=jnp.bfloat16,
                       rerank_fp32=False).detect(_im())
    assert len(got) == len(want) == TOP
    d = _matched(got, want)
    assert len(d) >= MIN_MATCHED, len(d)
    assert max(d) <= SCORE_TOL


def test_bf16_plain_equals_the_jax_pallas_route(plain, monkeypatch):
    monkeypatch.setenv("PBD_DT_IMPL", "interpret")
    jm, got = plain
    want = JaxDetector(jm, max_detections=TOP, dtype=jnp.bfloat16,
                       rerank_fp32=False).detect(_im())
    d = _matched(got, want)
    assert len(d) == len(got) == len(want) == TOP
    by_key = {_key(c): c.score for c in want}
    for c in got:
        assert abs(c.score - by_key[_key(c)]) <= 2.0**-8 * max(1.0, abs(c.score))


def test_bf16_plain_is_not_the_hybrid(plain):
    """No re-score: the scores are the DP's, not the hybrid's f32
    reconstructions, and float frames travel in bf16."""
    jm, got = plain
    tm = model_from_jax(jm)
    hybrid = PartsBasedDetector(tm, max_detections=TOP, dtype=BF16, device="cpu")
    assert hybrid.rerank_fp32 and hybrid.wire_dtype == torch.float32
    det = _plain(tm)
    assert not det.rerank_fp32 and det.wire_dtype == BF16
    assert det._upload(np.zeros((8, 8, 3), np.float32)).tensor.dtype == BF16
    assert det._upload(np.zeros((8, 8, 3), np.uint8)).tensor.dtype == torch.uint8
    assert [c.score for c in got] != [c.score for c in hybrid.detect(_im())]
    f = _im().astype(np.float32)
    assert [c.score for c in det.detect(f)] == [c.score for c in got]


@pytest.mark.parametrize("bpo", [1, 3])
def test_bf16_pyramid_is_batch_invariant(bpo):
    """Each frame's bf16 features are the same bits alone (B=1) and in
    a batch of 8."""
    tp = pack_model(model_from_jax(_jmodel()))
    plan = make_plan(tp, (120, 150), bpo)
    frames = torch.from_numpy(np.stack([_im(s) for s in range(8)])).to(BF16)
    batch = build_pyramid_features(frames, plan, tp.spec)
    for i in (0, 5):
        alone = build_pyramid_features(frames[i : i + 1], plan, tp.spec)
        for a, b in zip(alone, batch):
            assert a.dtype == BF16
            assert torch.equal(a[0], b[i])


def test_bf16_plain_serving_apis_equal_detect():
    det = _plain(model_from_jax(_jmodel()))
    ims = [_im(s, 96, 112) for s in range(3)]
    singles = [det.detect(x) for x in ims]
    for got in (det.detect_batch(ims), det.detect_many(ims, microbatch=2)):
        assert len(got) == 3
        for g, s in zip(got, singles):
            assert len(g) == len(s) > 0
            for a, b in zip(g, s):
                assert a.score == b.score and a.component == b.component
                np.testing.assert_array_equal(a.parts, b.parts)


def _mkey(d):
    return (d["component"], d["level"], tuple(d["mixtures"]), tuple(d["xs"]),
            tuple(d["ys"]))


def test_bf16_miner_matches_the_jax_bf16_miner():
    jm = _jmodel()
    miner = TPUMiner(model_from_jax(jm), max_det=TOP, dtype=BF16, device="cpu")
    jminer = JaxMiner(jm, max_det=TOP, dtype=jnp.bfloat16)
    got = miner.detect(_im(), thresh=-10.0)
    want = jminer.detect(_im(), thresh=-10.0)
    assert len(got) == len(want) == TOP
    by_key = {_mkey(d): d["score"] for d in want}
    d = [abs(g["score"] - by_key[_mkey(g)]) for g in got if _mkey(g) in by_key]
    assert len(d) >= MIN_MATCHED, len(d)
    assert max(d) <= SCORE_TOL
    boxes = np.tile([30.0, 30.0, 60.0, 80.0], (5, 1))
    kw = dict(thresh=-10.0, part_boxes=boxes, overlap=0.3)
    (g,), (w,) = miner.detect(_im(), **kw), jminer.detect(_im(), **kw)
    assert _mkey(g) == _mkey(w)
    assert abs(g["score"] - w["score"]) <= SCORE_TOL


def test_bf16_miner_set_model_rebuilds_its_pools():
    jm = _jmodel()
    model = model_from_jax(jm)
    miner = TPUMiner(model, max_det=TOP, dtype=BF16, device="cpu")
    first = miner.detect(_im(), thresh=-10.0)
    model.biases = model.biases + 1.0
    miner.set_model(model)
    assert miner._params is None
    again = miner.detect(_im(), thresh=-10.0)
    fresh = TPUMiner(model, max_det=TOP, dtype=BF16, device="cpu").detect(_im(), thresh=-10.0)
    assert [d["score"] for d in again] == [d["score"] for d in fresh]
    assert [d["score"] for d in again] != [d["score"] for d in first]


def test_other_miner_dtypes_raise():
    with pytest.raises(NotImplementedError):
        TPUMiner(model_from_jax(_jmodel()), dtype=torch.float16, device="cpu")


def test_bf16_with_params_needs_no_grad():
    """bf16 with params is the miner's call only: with a graph recorded
    (training) it raises; under no_grad it runs."""
    tm = model_from_jax(_jmodel())
    tp = pack_model(tm)
    plan = make_plan(tp, (120, 150))
    args = (torch.from_numpy(_im()), tp, to_device(tp, "cpu"), plan)
    params = model_params(tm, device="cpu")
    with pytest.raises(NotImplementedError):
        root_scores(*args, params=params, dtype=BF16, conv_dtype=BF16)
    with pytest.raises(NotImplementedError):
        root_scores(*args, dtype=torch.float32, conv_dtype=BF16)
    with torch.no_grad():
        out = root_scores(*args, params=params, dtype=BF16, conv_dtype=BF16)
    assert all(torch.isfinite(o.rootv).any() for o in out)
