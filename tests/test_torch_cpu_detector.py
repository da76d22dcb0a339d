"""The torch port's CPUPartsBasedDetector (cpu_detector.py over its own
copy of the native C++ kernels, native/) against the JAX package's, on
the cases of tests/test_cpu_detector.py, and the port's native kernels
against its NumPy reference kernels, on the cases of
tests/test_native.py.

The detectors run the same Python code over the same kernels, so their
candidates are equal exactly: with the NumPy kernels, and with the
native ones (the port's library, handed to both: the C++ source is the
JAX package's, byte for byte, and the JAX package's own build of it is
left alone here). The port's native build is safe to start from several
processes at once."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from partsbaseddetector_tpu.cpu_detector import CPUPartsBasedDetector as JaxCPU
from partsbaseddetector_tpu.models.model import make_synthetic_model
from partsbaseddetector_tpu_torch import CPUPartsBasedDetector, native
from partsbaseddetector_tpu_torch.depth import _batch_medians
from partsbaseddetector_tpu_torch.models.convert import model_from_jax
from partsbaseddetector_tpu_torch.ops import reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = {
    # tests/test_cpu_detector.py's two models and images
    "4parts": (dict(nparts=4, nmix=2, fsize=(4, 4), sbin=8, interval=2,
                    thresh=1.0, seed=40), (140, 150), 0),
    "3parts": (dict(nparts=3, nmix=1, fsize=(3, 3), sbin=8, interval=2,
                    thresh=0.5, seed=41), (100, 100), 1),
}


def _case(name):
    kw, shape, seed = CASES[name]
    im = (np.random.RandomState(seed).rand(*shape, 3) * 255).astype(np.float32)
    return make_synthetic_model(**kw), im


def _jax_cpu(jmodel, use_native):
    det = JaxCPU(jmodel, use_native=False)
    if use_native:
        det._kernels = native
    return det


def assert_equal_candidates(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.score == w.score
        np.testing.assert_array_equal(g.parts, w.parts)
        np.testing.assert_array_equal(g.confidence, w.confidence)
        assert g.component == w.component


def test_native_source_is_the_reference_copy():
    ours = os.path.join(ROOT, "partsbaseddetector_tpu_torch", "native", "pbd_kernels.cc")
    with open(ours, "rb") as a, open(os.path.join(ROOT, "native", "pbd_kernels.cc"), "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("name", sorted(CASES))
def test_cpu_detector_equals_the_jax_one(name, use_native):
    jmodel, im = _case(name)
    port = CPUPartsBasedDetector(model_from_jax(jmodel), use_native=use_native)
    assert (port._kernels is native) == use_native  # g++ is present here
    assert_equal_candidates(port.detect(im), _jax_cpu(jmodel, use_native).detect(im))


def test_cpu_detector_depth_filter_and_name():
    jmodel, im = _case("4parts")
    rng = np.random.RandomState(2)
    depth = (1.0 + rng.rand(*im.shape[:2])).astype(np.float32)
    depth[40:80, 50:90] = 5.0
    port = CPUPartsBasedDetector(model_from_jax(jmodel))
    assert port.name == jmodel.name
    got = port.detect(im, depth)
    assert_equal_candidates(got, _jax_cpu(jmodel, True).detect(im, depth))
    assert len(got) < len(port.detect(im))
    with pytest.raises(RuntimeError, match="distribute_model"):
        CPUPartsBasedDetector().detect(im)


# --- the port's native kernels against its NumPy reference kernels, with
# tests/test_native.py's inputs and tolerances


def test_native_hog():
    im = np.random.RandomState(0).rand(41, 50, 3) * 255
    np.testing.assert_allclose(native.hog(im, 8), reference.hog(im, 8),
                               rtol=1e-4, atol=1e-4)


def test_native_resize_reduce():
    im = np.random.RandomState(1).rand(37, 45, 3) * 255
    np.testing.assert_allclose(native.resize(im, 0.777), reference.resize(im, 0.777),
                               rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(native.reduce(im), reference.reduce(im),
                               rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("sx,sy,dlx,dly,step",
                         [(0, 0, 19, 15, 1), (2, -1, 12, 9, 1), (1, 1, 8, 6, 2)])
def test_native_shiftdt(sx, sy, dlx, dly, step):
    score = np.random.RandomState(2).randn(15, 19)
    w = np.array([0.03, -0.01, 0.02, 0.015])
    want = reference.shift_dt_2d(score, w, sx, sy, dlx, dly, step)
    got = native.shiftdt(score, w, sx, sy, dlx, dly, step)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-10, atol=1e-10)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def test_native_fconv():
    rng = np.random.RandomState(3)
    feat = rng.rand(20, 24, 32).astype(np.float32)
    filt = rng.rand(5, 4, 32).astype(np.float32)
    want = reference.fconv_valid(feat.astype(np.float64), filt.astype(np.float64))
    np.testing.assert_allclose(native.fconv_valid(feat, filt), want, rtol=1e-4, atol=1e-4)


def test_native_paint_nms_and_box_medians():
    boxes = np.array([[10, 10, 30, 30], [12, 12, 32, 32], [100, 100, 130, 130]],
                     dtype=np.float64)
    np.testing.assert_array_equal(native.paint_nms(boxes, (200, 200), overlap=0.2),
                                  [True, False, True])
    depth = np.random.RandomState(4).rand(60, 70).astype(np.float32)
    depth[depth < 0.1] = np.nan
    small = [[1, 2, 30, 40], [10.5, 3.2, 20.7, 9.9], [0, 0, 69, 59]]
    np.testing.assert_array_equal(native.box_medians(depth, np.array(small)),
                                  _batch_medians(depth, small))


BUILD = textwrap.dedent(
    """
    import ctypes, sys
    sys.path.insert(0, sys.argv[2])
    from partsbaseddetector_tpu_torch import native

    path = native.build(sys.argv[1])
    ctypes.CDLL(str(path)).pbd_version()
    print(path)
    """
)


def test_concurrent_builds_all_load(tmp_path):
    """Four processes start the native build into one fresh directory at
    once: each gets the same library and loads it; one compile left one
    file and no temporary ones."""
    procs = [
        subprocess.Popen([sys.executable, "-c", BUILD, str(tmp_path), ROOT],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(4)
    ]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    paths = {out.strip() for out, _ in outs}
    assert paths == {str(native.library_path(tmp_path))}
    assert sorted(f.name for f in tmp_path.iterdir() if f.name != ".lock") == [
        native.library_path(tmp_path).name]
