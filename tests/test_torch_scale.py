"""The torch port at the face configuration's part counts against the JAX
package, on the CPU (the port's plain kernel versions).

BASELINE config 1's face model (`make_face_like_model`: 39 parts x 3
mixtures, 5x5 filters, sbin 4, interval 5, so F = 117 filters and one
bucket per octave) and a 68-part model of the same shape (the
frontal-face landmark count: F = 204). On the card these are the counts
where K2's detect launch first takes a partial last n8 tile (117) and
two blocks along N (204); here they exercise the plan, the packing, the
DP over trees of 39 and 68 parts and the backtrack. Tolerances are
tests/test_torch_detector.py's: scores 1e-4, parts 1e-3, components
and mixtures exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partsbaseddetector_tpu import PartsBasedDetector as JaxDetector
from partsbaseddetector_tpu.models.model import make_face_like_model, make_synthetic_model
from partsbaseddetector_tpu.models.model import pack_model as jpack
from partsbaseddetector_tpu.pipeline import make_plan as jplan
from partsbaseddetector_tpu.pipeline import max_root_score as jmax_root_score
from partsbaseddetector_tpu.pipeline import root_scores as jroot_scores
from partsbaseddetector_tpu.train.sgd import model_params as jmodel_params
from partsbaseddetector_tpu_torch import PartsBasedDetector
from partsbaseddetector_tpu_torch.models.convert import model_from_jax, params_from_jax
from partsbaseddetector_tpu_torch.models.model import pack_model, to_device
from partsbaseddetector_tpu_torch.pipeline import make_plan, max_root_score, root_scores


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes on
    the host's cores, and torch's spinning thread pool then slows each
    detect by two orders of magnitude."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _face68():
    return make_synthetic_model(name="face68", nparts=68, nmix=3, fsize=(5, 5),
                                sbin=4, interval=5, thresh=0.25, seed=0)


MODELS = {"face": make_face_like_model, "face68": _face68}
FILTERS = {"face": 117, "face68": 204}


def _frame(shape, seed=0):
    return (np.random.RandomState(seed).rand(*shape, 3) * 255).astype(np.uint8)


def _assert_same(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert abs(g.score - w.score) < 1e-4, (g.score, w.score)
        np.testing.assert_allclose(g.parts, w.parts, atol=1e-3)
        assert g.component == w.component
        np.testing.assert_array_equal(g.mixtures, w.mixtures)


@pytest.mark.parametrize("name", ["face", "face68"])
def test_packed_bank_has_the_face_filter_counts(name):
    jm = MODELS[name]()
    packed = pack_model(model_from_jax(jm))
    assert packed.filters.shape[0] == FILTERS[name] == jpack(jm).filters.shape[0]
    assert len(jm.parentid[0]) == FILTERS[name] // 3


@pytest.mark.parametrize(
    "name,shape",
    [("face", (64, 80)), ("face", (96, 128)), ("face68", (64, 80))],
)
def test_detect_matches_jax(name, shape):
    """The whole detect at thresh -1e9: the same candidates, best first."""
    jm = MODELS[name]()
    jm.thresh = -1e9
    im = _frame(shape)
    kw = dict(max_detections=48)
    want = JaxDetector(jm, **kw).detect(im)
    got = PartsBasedDetector(model_from_jax(jm), device="cpu", **kw).detect(im)
    assert got[0].parts.shape == (FILTERS[name] // 3, 4)
    _assert_same(got, want)


def test_face_one_bucket_per_octave_matches_jax():
    """Config 1's set-up: buckets_per_octave=1 (interval 5 is odd): the
    same buckets as the JAX plan, and the same candidates."""
    jm = make_face_like_model()
    jm.thresh = -1e9
    im = _frame((80, 96), seed=1)
    tp, jp = pack_model(model_from_jax(jm)), jpack(jm)
    plan, want_plan = make_plan(tp, im.shape[:2], 1), jplan(jp, im.shape[:2], 1)
    assert len(plan.buckets) == len(want_plan.buckets) > 1
    for b, w in zip(plan.buckets, want_plan.buckets):
        assert list(b.scale_indices) == list(w.scale_indices)
        assert (b.resp_h, b.resp_w) == (w.resp_h, w.resp_w)
    kw = dict(max_detections=32, buckets_per_octave=1)
    want = JaxDetector(jm, **kw).detect(im)
    got = PartsBasedDetector(model_from_jax(jm), device="cpu", **kw).detect(im)
    _assert_same(got, want)


@pytest.fixture(scope="module")
def face_params():
    jm = make_face_like_model()
    im = _frame((64, 80), seed=2).astype(np.float32)
    jp, tp = jpack(jm), pack_model(model_from_jax(jm))
    jparams = jmodel_params(jm)
    return jm, im, jp, tp, jparams


def test_root_scores_with_params_at_117_filters_match_jax(face_params):
    """The trainable route (params dict, -1e10 masking) at F = 117: root
    values per (bucket, component) within 1e-5 relative of the JAX
    route's (jitted: XLA:CPU's FMA in the DT moves values by rounding
    only; the gradient test below runs op by op, where an argmax counts)."""
    jm, im, jp, tp, jparams = face_params
    assert tp.filters.shape[0] == 117
    plan, jpl = make_plan(tp, im.shape[:2]), jplan(jp, im.shape[:2])
    tparams = params_from_jax(jparams, device="cpu")
    got = root_scores(torch.from_numpy(im), tp, to_device(tp, "cpu"), plan,
                      params=tparams, with_tables=False)
    want = jax.jit(lambda im_, p: [s.rootv for s in jroot_scores(
        im_, jp, jpl, params=p, with_tables=False)])(jnp.asarray(im), jparams)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        gv, wv = g.rootv.detach().numpy(), np.asarray(w)
        live = wv > -1e9
        assert live.any()
        np.testing.assert_array_equal(gv > -1e9, live)
        np.testing.assert_allclose(gv[live], wv[live], rtol=1e-5, atol=1e-4)


def test_max_root_score_gradient_at_117_filters_matches_jax(face_params):
    """max_root_score and its gradient in every pool at F = 117 against
    jax.grad, rtol 1e-4, atol 1e-5 as tests/test_torch_train.py. Op by op
    (under jit XLA:CPU's FMA moves an argmax here), so on a 40x48 frame:
    one bucket of five scales, half the ops of 64x80."""
    jm, _, jp, tp, jparams = face_params
    im = _frame((40, 48), seed=3).astype(np.float32)
    plan, jpl = make_plan(tp, im.shape[:2]), jplan(jp, im.shape[:2])
    tparams = params_from_jax(jparams, device="cpu")
    got = max_root_score(torch.from_numpy(im), tp, to_device(tp, "cpu"), plan, tparams)
    got.backward()
    with jax.disable_jit():
        want, grads = jax.value_and_grad(
            lambda p: jmax_root_score(jnp.asarray(im), jp, jpl, params=p))(jparams)
    assert abs(float(got.detach()) - float(want)) <= 1e-4 * max(1.0, abs(float(want)))
    for k, g in grads.items():
        np.testing.assert_allclose(tparams[k].grad.numpy(), np.asarray(g),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
