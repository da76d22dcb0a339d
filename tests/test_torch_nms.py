"""The torch port's NMS (ops/nms.py) and the detector's nms_overlap
option against the JAX package on the CPU.

The keep masks are boolean decisions on the same f32 boxes and must be
identical; the detector's candidates agree with the JAX detector's to
1e-6 in score and 1e-4 in part boxes (tests/test_torch_serving.py).
"""

import numpy as np
import pytest
import torch

from partsbaseddetector_tpu import PartsBasedDetector as JaxDetector
from partsbaseddetector_tpu.models.model import make_synthetic_model
from partsbaseddetector_tpu.ops import nms as jnms
from partsbaseddetector_tpu_torch import PartsBasedDetector
from partsbaseddetector_tpu_torch.models.convert import model_from_jax
from partsbaseddetector_tpu_torch.ops import nms as tnms


def _boxes(seed, n=40, p=3):
    """Sorted candidates with ties (duplicated boxes and scores) and
    invalid rows."""
    rng = np.random.RandomState(seed)
    x1 = rng.randint(0, 60, (n, p)).astype(np.float32)
    y1 = rng.randint(0, 60, (n, p)).astype(np.float32)
    w = rng.randint(4, 30, (n, p)).astype(np.float32)
    h = rng.randint(4, 30, (n, p)).astype(np.float32)
    boxes = np.stack([x1, y1, x1 + w, y1 + h], -1)
    boxes[5] = boxes[4]  # an identical pair
    scores = np.sort(rng.randn(n).astype(np.float32))[::-1].copy()
    scores[10:13] = scores[10]  # tied scores
    valid = rng.rand(n) > 0.2
    return boxes, scores, valid


@pytest.mark.parametrize("overlap", [0.3, 0.5, 0.8])
def test_part_nms_device_matches_jax_and_host(overlap):
    cases = [_boxes(s) for s in (1, 2)]
    want = [
        np.asarray(jnms.part_nms_device(b, s, v, overlap)) for b, s, v in cases
    ]
    # one image at a time, and both as a batch (the detector's layout)
    for (b, s, v), w in zip(cases, want):
        got = tnms.part_nms_device(
            torch.from_numpy(b), torch.from_numpy(s), torch.from_numpy(v), overlap
        )
        np.testing.assert_array_equal(got.numpy(), w)
        # the host NMS over the valid rows keeps the same candidates
        idx = np.flatnonzero(v)
        host = idx[tnms.part_nms(b[idx], s[idx], overlap)]
        np.testing.assert_array_equal(np.sort(host), np.flatnonzero(w))
        np.testing.assert_array_equal(
            tnms.part_nms(b[idx], s[idx], overlap), jnms.part_nms(b[idx], s[idx], overlap)
        )
    got = tnms.part_nms_device(
        *(torch.from_numpy(np.stack(x)) for x in zip(*cases)), overlap
    )
    np.testing.assert_array_equal(got.numpy(), np.stack(want))
    assert 0 < got.sum() < sum(v.sum() for _, _, v in cases)


@pytest.mark.parametrize("sz", [1, 2])
def test_pixel_nms_device_matches_jax(sz):
    rng = np.random.RandomState(sz)
    src = rng.randint(0, 6, (23, 31)).astype(np.float32)  # plateaus: ties
    src[3, 4] = 9.0
    got = tnms.pixel_nms_device(torch.from_numpy(src), sz).numpy()
    want = np.asarray(jnms.pixel_nms_device(src, sz))
    np.testing.assert_array_equal(got, want)
    assert got.any()
    np.testing.assert_array_equal(tnms.pixel_nms(src, sz), jnms.pixel_nms(src, sz))


def _nms_model():
    return make_synthetic_model(
        nparts=3, nmix=1, fsize=(4, 4), sbin=8, interval=2, thresh=-5.0, seed=70
    )


@pytest.mark.parametrize("overlap", [0.3, 0.4])
def test_detector_nms_matches_jax(overlap):
    jm = _nms_model()
    im = (np.random.RandomState(1).rand(90, 100, 3) * 255).astype(np.float32)
    kw = dict(max_detections=64, nms_overlap=overlap)
    want = JaxDetector(jm, **kw).detect(im)
    got = PartsBasedDetector(model_from_jax(jm), device="cpu", **kw).detect(im)
    plain = PartsBasedDetector(model_from_jax(jm), device="cpu", max_detections=64)
    assert 1 < len(got) < len(plain.detect(im))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert abs(a.score - b.score) < 1e-6
        np.testing.assert_allclose(a.parts, b.parts, rtol=0, atol=1e-4)
        assert a.component == b.component
        np.testing.assert_array_equal(a.mixtures, b.mixtures)


def test_detect_many_readback_top_with_device_nms():
    """Mirrors tests/test_detector.py::
    test_detect_many_readback_top_with_device_nms: NMS clears rows in
    place, so the top-K cut must put valid rows first; the cut list is
    a prefix of detect()'s post-NMS candidates."""
    rng = np.random.RandomState(1)
    ims = [(rng.rand(90, 100, 3) * 255).astype(np.float32) for _ in range(3)]
    det = PartsBasedDetector(model_from_jax(_nms_model()), max_detections=64,
                             nms_overlap=0.3, device="cpu")
    singles = [det.detect(im) for im in ims]
    assert any(len(s) > 2 for s in singles)
    dense = det.detect_dense(ims[0])
    assert not dense.valid[: len(singles[0])].all()  # suppressed rows interleave
    got = det.detect_many(ims, readback_top=2, prefetch=2)
    for g, s in zip(got, singles):
        assert len(g) == min(2, len(s))
        for a, b in zip(g, s[:2]):
            assert a.score == b.score
            np.testing.assert_array_equal(a.parts, b.parts)
