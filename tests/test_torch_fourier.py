"""The torch port's Fourier engine against the JAX package on the CPU.

The filters' conjugate spectra are host NumPy in both packages and must
be equal bit for bit. Responses go through torch.fft (pocketfft on the
CPU, cuFFT on the card) instead of jnp.fft, so they agree with the JAX
engine and with the float64 reference to rtol 1e-4, atol 1e-4, and with
the spatial engine to 2e-4 (the bounds of tests/test_conv.py). Detection
with the Fourier engine agrees with the JAX Fourier detector to
|dscore| < 2e-3 and with the port's spatial engine to 5e-3
(tests/test_detector.py::test_fourier_engine_parity).

Training with the Fourier engine (params) transforms the traced filters
on the device: the best root score and its gradients agree with the JAX
package's under jax.grad within rtol 1e-4, atol 1e-4, and two SGD steps
agree with the spatial engine's within 5e-3.
"""

import numpy as np
import pytest
import torch

from partsbaseddetector_tpu import PartsBasedDetector as JaxDetector
from partsbaseddetector_tpu.models.model import make_synthetic_model
from partsbaseddetector_tpu.ops import conv as jconv
from partsbaseddetector_tpu.ops import reference
from partsbaseddetector_tpu_torch import PartsBasedDetector
from partsbaseddetector_tpu_torch.models.convert import model_from_jax
from partsbaseddetector_tpu_torch.ops import conv as tconv


def _bank(rng, sizes, c=32):
    fh = max(s[0] for s in sizes)
    fw = max(s[1] for s in sizes)
    bank = np.zeros((len(sizes), fh, fw, c), dtype=np.float32)
    raw = []
    for i, (h, w) in enumerate(sizes):
        f = rng.randn(h, w, c).astype(np.float32) * 0.1
        bank[i, :h, :w] = f
        raw.append(f)
    return bank, raw


@pytest.mark.parametrize("h,w", [(18, 22), (25, 31), (9, 8)])
def test_spectra_equal_jax_bit_for_bit(h, w):
    bank, _ = _bank(np.random.RandomState(h), [(5, 5), (3, 4), (2, 2)])
    got = tconv.fft_filter_spectra(bank, h, w)
    want = jconv.fft_filter_spectra(bank, h, w)
    assert got.dtype == np.float32 and got.shape == (2, h, w // 2 + 1, 32, 3)
    np.testing.assert_array_equal(got, want)
    assert tconv.fft_filter_spectra(bank, h, w) is got  # memoized


@pytest.mark.parametrize("with_spectra", [False, True])
def test_fft_responses_match_jax_and_reference(with_spectra):
    rng = np.random.RandomState(0)
    feat = rng.randn(2, 18, 22, 32).astype(np.float32)
    sizes = [(5, 5), (3, 4), (5, 5), (2, 2)]
    bank, raw = _bank(rng, sizes)
    sp = tconv.fft_filter_spectra(bank, 18, 22) if with_spectra else None
    got = tconv.filter_responses_fft(
        torch.from_numpy(feat), torch.from_numpy(bank),
        None if sp is None else torch.from_numpy(sp),
    ).numpy()
    want = np.asarray(jconv.filter_responses_fft(feat, bank, sp))
    assert got.shape == want.shape == (2, 14, 18, 4)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    for s in range(2):
        for i, f in enumerate(raw):
            ref = reference.fconv_valid(feat[s].astype(np.float64), f)
            np.testing.assert_allclose(
                got[s, :, :, i], ref[:14, :18], rtol=1e-4, atol=1e-4
            )


def test_fft_and_spatial_engines_agree():
    rng = np.random.RandomState(1)
    feat = torch.from_numpy(rng.randn(3, 25, 31, 32).astype(np.float32))
    bank = torch.from_numpy(_bank(rng, [(6, 6), (4, 5)])[0])
    a = tconv.filter_responses(feat, bank)
    b = tconv.filter_responses_fft(feat, bank)
    torch.testing.assert_close(b, a, rtol=2e-4, atol=2e-4)


def _model():
    """The model of tests/test_detector.py::test_fourier_engine_parity."""
    return make_synthetic_model(
        nparts=4, nmix=2, fsize=(4, 4), sbin=8, interval=3, thresh=-1e9, seed=10
    )


def _image():
    return (np.random.RandomState(0).rand(170, 190, 3) * 255).astype(np.float32)


def test_fourier_detect_matches_jax_fourier_detector():
    jm = _model()
    want = JaxDetector(jm, max_detections=64, conv_engine="fourier").detect(_image())
    got = PartsBasedDetector(
        model_from_jax(jm), max_detections=64, conv_engine="fourier",
        device="cpu",
    ).detect(_image())
    assert len(got) == len(want) == 64
    for g, w in zip(got, want):
        assert abs(g.score - w.score) < 2e-3
        np.testing.assert_allclose(g.parts, w.parts, atol=5e-2)
        assert g.component == w.component
        np.testing.assert_array_equal(g.mixtures, w.mixtures)


def test_fourier_detect_matches_spatial_detect():
    model = model_from_jax(_model())
    kw = dict(max_detections=64, buckets_per_octave=3, device="cpu")
    fourier = PartsBasedDetector(model, conv_engine="fourier", **kw)
    a = fourier.detect_dense(_image())
    b = PartsBasedDetector(model, **kw).detect_dense(_image())
    np.testing.assert_array_equal(a.valid, b.valid)
    assert np.abs(a.scores - b.scores)[a.valid].max() < 5e-3
    # the spectra are uploaded once per image size, with the plan
    assert list(fourier._spectra) == [(170, 190)]
    sp = fourier._spectra[(170, 190)]
    fourier.detect_dense(_image())
    assert fourier._spectra[(170, 190)] is sp


def _train_setup(seed):
    from partsbaseddetector_tpu.models.model import pack_model as jpack
    from partsbaseddetector_tpu.train import sgd as jsgd
    from partsbaseddetector_tpu_torch.models.model import pack_model

    jm = make_synthetic_model(nparts=3, nmix=2, fsize=(3, 3), sbin=8,
                              interval=2, thresh=0.0, seed=seed)
    im = (np.random.RandomState(seed).rand(80, 80, 3) * 255).astype(np.float32)
    return jm, jpack(jm), pack_model(model_from_jax(jm)), jsgd.model_params(jm), im


def _port_max_score(tp, params, im, engine):
    from partsbaseddetector_tpu_torch.models.model import to_device
    from partsbaseddetector_tpu_torch.pipeline import make_plan, max_of_scores, root_scores

    scores = root_scores(
        torch.from_numpy(im), tp, to_device(tp, "cpu"), make_plan(tp, (80, 80)),
        params=params, engine=engine, with_tables=False,
    )
    return max_of_scores(scores)


@pytest.mark.parametrize("seed", [0, 5])
def test_fourier_training_values_and_grads_match_jax(seed):
    """root_scores(params, engine="fourier"): the spectra come from the
    traced filters (torch.fft in f32 under autograd; jnp.fft under
    jax.grad, op by op, in the JAX package). The best root score and its
    gradients in every pool agree within rtol 1e-4, atol 1e-4 (the FFTs
    round differently; tests/test_conv.py's bound for the responses)."""
    import jax

    from partsbaseddetector_tpu.pipeline import make_plan as jmake_plan
    from partsbaseddetector_tpu.pipeline import max_root_score
    from partsbaseddetector_tpu_torch.models.convert import params_from_jax

    jm, jp, tp, jparams, im = _train_setup(seed)
    plan = jmake_plan(jp, (80, 80))
    want, wgrads = jax.value_and_grad(
        lambda p: max_root_score(im, jp, plan, params=p, engine="fourier")
    )(jparams)
    params = params_from_jax(jparams, "cpu")
    got = _port_max_score(tp, params, im, "fourier")
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4, atol=1e-4)
    for k in ("filters", "defs", "biases"):
        g = params[k].grad.numpy()
        assert np.abs(g).sum() > 0, k
        np.testing.assert_allclose(g, np.asarray(wgrads[k]), rtol=1e-4, atol=1e-4)


def test_fourier_training_step_agrees_with_spatial():
    """Two SGD steps on the Fourier engine against the spatial one from
    the same weights: losses and updated pools within 5e-3 (the
    engines' response bound, tests/test_detector.py)."""
    from partsbaseddetector_tpu_torch.train import sgd as tsgd

    jm, _, tp, _, _ = _train_setup(0)
    model = model_from_jax(jm)
    rng = np.random.RandomState(2)
    images = torch.from_numpy(rng.rand(2, 80, 80, 3).astype(np.float32) * 255)
    labels = np.array([1.0, -1.0], np.float32)
    out = {}
    for engine in ("spatial", "fourier"):
        loss_fn = tsgd.LatentHingeLoss(tp, (80, 80), 1e-4, 1.0, latent=False,
                                       engine=engine)
        params = tsgd.model_params(model, device="cpu")
        opt = tsgd.sgd_momentum(params.values())
        losses = []
        for _ in range(2):
            loss, _ = loss_fn.value_and_grad(params, images, labels)
            opt.step()
            tsgd.project_defs(params)
            losses.append(float(loss))
        out[engine] = (losses, {k: v.detach().numpy() for k, v in params.items()})
    np.testing.assert_allclose(out["fourier"][0], out["spatial"][0], atol=5e-3)
    for k in ("filters", "defs", "biases"):
        np.testing.assert_allclose(out["fourier"][1][k], out["spatial"][1][k], atol=5e-3)


def test_fourier_training_refuses_the_serving_spectra():
    """The host spectra are a serving cache of the packed bank: passing
    them with params would detach the filters' gradients (the JAX
    package asserts the same)."""
    from partsbaseddetector_tpu_torch.models import pack_model, to_device
    from partsbaseddetector_tpu_torch.pipeline import (
        fourier_spectra_args, make_plan, root_scores,
    )
    from partsbaseddetector_tpu_torch.train.sgd import model_params

    model = model_from_jax(_model())
    packed = pack_model(model)
    plan = make_plan(packed, (64, 64))
    spectra = [torch.from_numpy(s) for s in fourier_spectra_args(packed, plan)]
    with pytest.raises(ValueError):
        root_scores(
            torch.zeros((64, 64, 3)), packed, to_device(packed, "cpu"), plan,
            params=model_params(model, device="cpu"), engine="fourier",
            fft_spectra=spectra,
        )
