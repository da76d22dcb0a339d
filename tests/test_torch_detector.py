"""The torch port's detector against the golden fixture and the JAX
package's detector, on the CPU (the port's plain kernel versions).

Features differ from the JAX package's by float rounding (1e-5), so
scores agree to 1e-4 and boxes to 1e-3; mixtures and components are
argmaxes and must be identical.
"""

import os

import numpy as np
import pytest
import torch

from partsbaseddetector_tpu import PartsBasedDetector as JaxDetector
from partsbaseddetector_tpu.models.model import make_synthetic_model, pack_model
from partsbaseddetector_tpu_torch import PartsBasedDetector, load_model
from partsbaseddetector_tpu_torch.models.convert import model_from_jax
from partsbaseddetector_tpu_torch.models.model import pack_model as tpack

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


def test_golden_fixture_on_cpu():
    model = load_model(os.path.join(FIX, "golden_model.npz"))
    g = np.load(os.path.join(FIX, "golden_detections.npz"))
    got = PartsBasedDetector(model, max_detections=64, device="cpu").detect(g["image"])
    assert len(got) == len(g["scores"]) == 15
    for c, boxes, score, mix in zip(got, g["boxes"], g["scores"], g["mixtures"]):
        assert abs(c.score - score) < 2e-3
        np.testing.assert_allclose(c.parts, boxes, atol=5e-2)
        np.testing.assert_array_equal(c.mixtures, mix)


def _assert_same(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert abs(g.score - w.score) < 1e-4, (g.score, w.score)
        np.testing.assert_allclose(g.parts, w.parts, atol=1e-3)
        assert g.component == w.component
        np.testing.assert_array_equal(g.mixtures, w.mixtures)


# buckets_per_octave=2 needs an even interval, so that case uses 4
@pytest.mark.parametrize(
    "interval,bpo,border,fsizes,ncomp",
    [
        (5, 1, "matlab", None, 1),
        (4, 2, "matlab", None, 1),
        (5, 1, "matlab", [(5, 5), (3, 4), (4, 2)], 1),
        (5, 1, "cpp", [(5, 5), (3, 3)], 1),
        (4, 2, "matlab", [(4, 4), (3, 5)], 2),
    ],
)
def test_detector_matches_jax(interval, bpo, border, fsizes, ncomp):
    jm = make_synthetic_model(
        nparts=6, nmix=2, sbin=8, interval=interval, fsizes=fsizes,
        ncomponents=ncomp, seed=interval + len(fsizes or ()),
    )
    jm.thresh = -1e9
    im = (np.random.RandomState(interval).rand(64, 80, 3) * 255).astype(np.uint8)
    kw = dict(max_detections=48, border_mode=border, buckets_per_octave=bpo)
    want = JaxDetector(jm, **kw).detect(im)
    got = PartsBasedDetector(model_from_jax(jm), device="cpu", **kw).detect(im)
    _assert_same(got, want)


def test_uint8_and_float32_frames_give_identical_candidates():
    model = model_from_jax(make_synthetic_model(nparts=4, nmix=2, sbin=8, seed=2))
    model.thresh = -1e9
    im = (np.random.RandomState(3).rand(61, 77, 3) * 255).astype(np.uint8)
    det = PartsBasedDetector(model, max_detections=32, device="cpu")
    a = det.detect(im)
    b = det.detect(im.astype(np.float32))
    assert len(a) == len(b) == 32
    for x, y in zip(a, b):
        assert x.score == y.score
        np.testing.assert_array_equal(x.parts, y.parts)
        np.testing.assert_array_equal(x.mixtures, y.mixtures)


def test_model_from_jax_gives_identical_packed_arrays():
    jm = make_synthetic_model(
        nparts=5, nmix=3, sbin=8, fsizes=[(5, 5), (3, 4)], ncomponents=2, seed=4
    )
    for border in ("matlab", "cpp"):
        want = pack_model(jm, border=border)
        got = tpack(model_from_jax(jm), border=border)
        assert got.spec == type(got.spec)(**vars(want.spec))
        np.testing.assert_array_equal(got.filters, want.filters)
        np.testing.assert_array_equal(got.filter_sizes, want.filter_sizes)
        for gc, wc in zip(got.components, want.components):
            for field in vars(wc):
                np.testing.assert_array_equal(
                    getattr(gc, field), getattr(wc, field), err_msg=field
                )


def test_npz_round_trip(tmp_path):
    from partsbaseddetector_tpu_torch import save_model

    model = model_from_jax(make_synthetic_model(nparts=3, nmix=2, seed=6))
    path = str(tmp_path / "m.npz")
    save_model(model, path)
    back = load_model(path)
    a, b = tpack(model), tpack(back)
    np.testing.assert_array_equal(a.filters, b.filters)
    np.testing.assert_array_equal(a.components[0].bias, b.components[0].bias)
    assert back.maxsize == model.maxsize and back.name == model.name


@pytest.mark.parametrize(
    "kwargs,error",
    [
        (dict(conv_engine="winograd"), ValueError),
        # bf16 without the re-rank runs HOG and the conv in bf16: not ported
        (dict(dtype=torch.bfloat16, rerank_fp32=False), NotImplementedError),
        (dict(dtype=torch.float64), NotImplementedError),
        (dict(border_mode="same"), ValueError),
        (dict(dtype=torch.float16), NotImplementedError),
        (dict(conv_engine="fourier", dtype=torch.bfloat16, rerank_fp32=False),
         NotImplementedError),
    ],
)
def test_options_outside_the_slice_raise(kwargs, error):
    with pytest.raises(error):
        PartsBasedDetector(**kwargs)


def test_depth_input_raises_and_tf32_is_off():
    """A depth map must be (H, W); the RGB-D options turn TF32 off like
    every detector."""
    model = model_from_jax(make_synthetic_model(nparts=3, nmix=2, seed=1))
    det = PartsBasedDetector(model, device_depth_filter=True, device="cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    im = np.zeros((48, 48, 3), np.uint8)
    with pytest.raises(ValueError):
        det.detect(im, depth=np.ones((48, 48, 3), np.float32))


def test_entry_points_default_to_the_card(monkeypatch):
    """Every entry point runs on CUDA unless the caller asks for the
    CPU: without a CUDA device the default raises at once, and
    device="cpu" works."""
    from partsbaseddetector_tpu_torch.models.convert import params_from_jax
    from partsbaseddetector_tpu_torch.train import batch_root_masks, fit, model_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = model_from_jax(make_synthetic_model(nparts=3, nmix=1, sbin=8, seed=1))
    im = np.zeros((48, 48, 3), np.uint8)
    for call in (
        lambda: PartsBasedDetector(model),
        lambda: model_params(model),
        lambda: params_from_jax({"filters": 0, "defs": 0, "biases": 0}),
        lambda: batch_root_masks(tpack(model), (48, 48), [[0, 0, 47, 47]]),
        lambda: fit(model, [im], [1.0], epochs=1, batch_size=1),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device; pass device='cpu'"):
            call()
    det = PartsBasedDetector(model, device="cpu")
    assert det.device == torch.device("cpu")
    assert isinstance(det.detect(im), list)
    assert model_params(model, device="cpu")["filters"].device.type == "cpu"
