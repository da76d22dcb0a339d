"""The torch port's apps (apps/sync.py, messages.py, stream.py,
pipeline.py, demo.py), visualization (visualize.py, visualize_model.py)
and profiling (utils/profiling.py) against the JAX package's, on the
CPU.

Host code is equal exactly. The stream's candidates come from the
port's detector, held to the JAX detector within |dscore| < 2e-3 and
parts within 5e-2 (the tolerance of tests/test_torch_detector.py); given
the same candidates, the post stages give equal masks, canvases, 3-D
boxes, clusters and poses."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from partsbaseddetector_tpu import PartsBasedDetector as JaxDetector
from partsbaseddetector_tpu import visualize as jvis
from partsbaseddetector_tpu import visualize_model as jvm
from partsbaseddetector_tpu.apps import messages as jmsg
from partsbaseddetector_tpu.apps import pipeline as jpipe
from partsbaseddetector_tpu.apps import stream as jstream
from partsbaseddetector_tpu.apps.sync import ApproximateTimeSynchronizer as JaxSync
from partsbaseddetector_tpu.depth import Rect3 as JRect3
from partsbaseddetector_tpu.depth import StereoCameraModel as JCamera
from partsbaseddetector_tpu.models.model import make_synthetic_model
from partsbaseddetector_tpu.types import Candidate as JCandidate
from partsbaseddetector_tpu_torch import PartsBasedDetector, Visualize, save_model
from partsbaseddetector_tpu_torch import visualize_model as vm
from partsbaseddetector_tpu_torch.apps import messages as msg
from partsbaseddetector_tpu_torch.apps import pipeline as pipe
from partsbaseddetector_tpu_torch.apps import stream
from partsbaseddetector_tpu_torch.apps.sync import ApproximateTimeSynchronizer
from partsbaseddetector_tpu_torch.depth import Rect3, StereoCameraModel
from partsbaseddetector_tpu_torch.models.convert import model_from_jax
from partsbaseddetector_tpu_torch.types import Candidate
from partsbaseddetector_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAMERA = dict(fx=90.0, fy=90.0, cx=39.5, cy=29.5)


def assert_same(a, b, path="msg"):
    """Deep equality of two messages: dicts, sequences, arrays, numbers;
    a Rect3 of either package compares by its fields."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif hasattr(a, "centroid"):
        assert_same(dataclasses.astuple(a), dataclasses.astuple(b), path)
    else:
        assert a == b or (a != a and b != b), (path, a, b)


def _jmodel(seed=30, thresh=-0.5):
    return make_synthetic_model(
        nparts=3, nmix=2, fsize=(3, 3), sbin=8, interval=2, thresh=thresh, seed=seed
    )


def _frames(n=3, h=60, w=80):
    rng = np.random.RandomState(0)
    out = []
    for i in range(n):
        rgb = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        depth = ((1.0 + rng.rand(h, w)) * 1000.0).astype(np.uint16)
        depth[rng.rand(h, w) < 0.05] = 0
        out.append((rgb, depth))
    return out


def _pair(boxes, conf):
    return Candidate(boxes, conf), JCandidate(boxes, conf)


def _candidates(n=3, nparts=3, seed=1):
    rng = np.random.RandomState(seed)
    x1 = rng.rand(n, nparts) * 50
    y1 = rng.rand(n, nparts) * 35
    wh = 5 + rng.rand(n, nparts, 2) * 15
    boxes = np.stack([x1, y1, x1 + wh[..., 0], y1 + wh[..., 1]], axis=-1)
    conf = np.zeros((n, nparts))
    conf[:, 0] = np.sort(rng.randn(n))[::-1]
    pairs = [_pair(b, c) for b, c in zip(boxes, conf)]
    return [p for p, _ in pairs], [j for _, j in pairs]


def assert_close_candidates(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert abs(g.score - w.score) < 2e-3
        np.testing.assert_allclose(g.parts, w.parts, atol=5e-2)
        assert g.component == w.component


# --- sync and messages ----------------------------------------------------


def test_synchronizer_matches_the_jax_one():
    got, want = [], []
    syncs = (ApproximateTimeSynchronizer(["rgb", "depth", "cloud"],
                                         lambda *m: got.append(m), queue_size=4, slop=0.05),
             JaxSync(["rgb", "depth", "cloud"], lambda *m: want.append(m),
                     queue_size=4, slop=0.05))
    rng = np.random.RandomState(3)
    for i in range(60):
        ch = ("rgb", "depth", "cloud")[rng.randint(3)]
        stamp = i * 0.02 + rng.randn() * 0.03
        fired = [s.push(ch, stamp, f"{ch}{i}") for s in syncs]
        assert fired[0] == fired[1]
    assert got == want and len(got) > 3


MESSAGES = {
    "hash_string_to_color": lambda m, c, r, cam: m.hash_string_to_color("person"),
    "message_bounding_boxes": lambda m, c, r, cam: m.message_bounding_boxes(
        r, object_name="person", frame_id="rgb"),
    "message_image_rgb": lambda m, c, r, cam: m.message_image_rgb(
        _frames(1)[0][0].astype(np.float32) * 1.1, c, name="p"),
    "message_mask": lambda m, c, r, cam: m.message_mask((60, 80), c),
    "message_clusters": lambda m, c, r, cam: m.message_clusters(
        [np.ones((3, 3)), np.zeros((0, 3)), np.arange(6.0).reshape(2, 3)]),
    "message_poses": lambda m, c, r, cam: m.message_poses(
        [np.ones(3), np.zeros(3)],
        [np.random.RandomState(4).randn(5, 3), np.random.RandomState(5).randn(2, 3)]),
    "message_frustum": lambda m, c, r, cam: m.message_frustum(
        fx=525.0, fy=520.0, cx=319.5, cy=239.5, width=640, height=480,
        near=0.4, far=3.0),
}


@pytest.mark.parametrize("name", sorted(MESSAGES))
def test_message_matches_the_jax_one(name):
    cands, jcands = _candidates()
    rects = [(0.1, 0.2, 1.0, 0.5, 0.6, 0.3), (np.nan, 0.0, 2.0, 0.1, 0.1, 0.1)]
    got = MESSAGES[name](msg, cands, [Rect3(*r) for r in rects],
                         StereoCameraModel(**CAMERA))
    want = MESSAGES[name](jmsg, jcands, [JRect3(*r) for r in rects], JCamera(**CAMERA))
    assert_same(got, want)


# --- the stream node ------------------------------------------------------


def _streams(jmodel, **kw):
    port = stream.DetectionStream(
        PartsBasedDetector(model_from_jax(jmodel), max_detections=32, device="cpu"),
        camera=StereoCameraModel(**CAMERA), **kw)
    jax = jstream.DetectionStream(
        JaxDetector(jmodel, max_detections=32), camera=JCamera(**CAMERA), **kw)
    for s in (port, jax):
        for topic in ("candidates", "image", "mask", "bbox3d", "clusters", "poses"):
            s.subscribe(topic, lambda payload: None)
    return port, jax


def _assert_same_post(got, want):
    for key in ("image_rgb", "mask", "boxes3d", "clusters", "poses"):
        assert_same(getattr(got, key), getattr(want, key), key)


@pytest.mark.parametrize("workers", [None, 1, 2])
def test_stream_candidates_match_the_jax_stream(workers):
    """process (workers None) and process_stream at workers 1 and 2:
    frames stay in order, candidates within the detector tolerance."""
    port, jax = _streams(_jmodel())
    frames = _frames(3)
    if workers is None:
        got = [port.process(rgb, d) for rgb, d in frames]
        want = [jax.process(rgb, d) for rgb, d in frames]
    else:
        got = list(port.process_stream(frames, lookahead=2, workers=workers))
        want = list(jax.process_stream(frames, lookahead=2, workers=workers))
    assert len(got) == len(want) == 3
    assert sum(len(r.candidates) for r in want) > 0
    for g, w, (rgb, d) in zip(got, want, frames):
        assert_close_candidates(g.candidates, w.candidates)
        alone = port.detector.detect(rgb, d)
        want_nms = Candidate.non_maxima_suppression(
            rgb.shape[:2], Candidate.sort(alone), port.max_overlap)
        assert len(want_nms) == len(g.candidates)
        for x, y in zip(g.candidates, want_nms):
            assert x.score == y.score
            np.testing.assert_array_equal(x.parts, y.parts)


@pytest.mark.parametrize("remove_planes", [False, True])
def test_post_stages_match_the_jax_ones(remove_planes):
    """Given the same candidates, the node's post stages (paint NMS,
    visualize, mask, 3-D boxes, the cloud with and without plane
    removal, clusters, poses) give the JAX node's outputs exactly."""
    port, jax = _streams(_jmodel(), remove_planes_first=remove_planes)
    rgb, depth16 = _frames(1)[0]
    depth = depth16.astype(np.float32) / 1000.0
    cands, jcands = _candidates(n=5, seed=8)
    got = port._post(rgb, depth, None, cands)
    want = jax._post(rgb, depth, None, jcands)
    assert len(got.candidates) == len(want.candidates) > 0
    for x, y in zip(got.candidates, want.candidates):
        np.testing.assert_array_equal(x.parts, y.parts)
    _assert_same_post(got, want)
    assert got.clusters and any(len(c) for c in got.clusters)
    assert_same(got.pose_results("person"), want.pose_results("person"))
    # a uint16 frame is millimetres: the port's 3-D stages see metres,
    # as the JAX node does given the frame in metres
    _assert_same_post(port._post(rgb, depth16, None, cands), want)


def _write_config(tmp_path, model_path):
    """The config of tests/test_apps_misc.py."""
    cfg = f"""
source1:
  type: ImageSource
  module: partsbaseddetector_tpu

sink1:
  type: Publisher
  module: partsbaseddetector_tpu

pipeline1:
  type: PartsBasedDetector
  module: partsbaseddetector_tpu
  inputs: [source1]
  outputs: [sink1]
  parameters:
    visualize: true
    max_overlap: 0.15
    model_file: "{model_path}"
    camera: {{fx: 100.0, fy: 100.0, cx: 40.0, cy: 40.0}}
"""
    path = str(tmp_path / "config.by_parts")
    with open(path, "w") as fh:
        fh.write(cfg)
    return path


@pytest.mark.parametrize("name", ["config_person", "config_face", "written"])
def test_parse_config_matches_the_jax_one(tmp_path, name):
    if name == "written":
        path = _write_config(tmp_path, str(tmp_path / "m.npz"))
    else:
        path = os.path.join(ROOT, "examples", "conf", f"{name}.by_parts")
    got, want = pipe.parse_config(path), jpipe.parse_config(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    text = open(path).read()
    assert dataclasses.asdict(pipe.parse_config(text)) == dataclasses.asdict(want)


def test_build_constructs_a_node_on_the_chosen_device(tmp_path):
    mpath = str(tmp_path / "m.npz")
    save_model(model_from_jax(_jmodel(thresh=0.0)), mpath)
    cpath = _write_config(tmp_path, mpath)
    node = pipe.build_from_file(cpath, device="cpu", buckets_per_octave=2)
    assert node.detector.device == torch.device("cpu")
    assert node.detector.buckets_per_octave == 2
    assert node.camera.fx == 100.0 and node.max_overlap == 0.15
    assert node._subs["image"]  # visualize: true subscribes an image sink
    result = node.process(_frames(1)[0][0])
    assert result.image_rgb is not None and result.image_rgb.shape == (60, 80, 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pipe.build(pipe.parse_config(cpath))
    with pytest.raises(ValueError, match="no PartsBasedDetector"):
        pipe.parse_config("source1:\n  type: RosKinect\n")


def test_demo_end_to_end_on_the_cpu(tmp_path, capsys):
    from PIL import Image

    from partsbaseddetector_tpu_torch.apps.demo import main as demo_main

    jmodel = _jmodel(seed=33, thresh=-3.0)
    mpath = str(tmp_path / "m.npz")
    save_model(model_from_jax(jmodel), mpath)
    rgb, depth16 = _frames(1, 90, 90)[0]
    ipath, dpath = str(tmp_path / "im.png"), str(tmp_path / "d.png")
    Image.fromarray(rgb).save(ipath)
    Image.fromarray(depth16).save(dpath)
    out = str(tmp_path / "out.png")
    assert demo_main([mpath, ipath, dpath, "--out", out, "--nms", "0.3",
                      "--max-detections", "16", "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    canvas = np.asarray(Image.open(out))
    assert canvas.shape == (90, 90, 3) and (canvas != rgb).any()
    det = PartsBasedDetector(model_from_jax(jmodel), max_detections=16, device="cpu")
    im = rgb.astype(np.float32)
    want = Candidate.non_maxima_suppression(
        im.shape[:2], Candidate.sort(det.detect(im, depth16.astype(np.float32) / 1000.0)),
        0.3)
    assert printed.startswith(f"{len(want)} candidates")


# --- visualization --------------------------------------------------------


def _cand(pkg_candidate):
    return pkg_candidate(
        np.array([[5, 5, 20, 20], [22, 8, 35, 21], [8, 25, 21, 38]], dtype=float),
        np.array([1.2345, 0, 0]),
    )


VIS = {
    "candidates": lambda m, C, model: (
        Visualize if m is vm else jvis.Visualize)("v").candidates(
            _frames(1)[0][0], _candidates(seed=2)[0 if m is vm else 1], n=2),
    "visualize_model": lambda m, C, model: m.visualize_model(model, mixture=1),
    "hog_picture": lambda m, C, model: m.hog_picture(model.filters[2], glyph_size=12),
    "show_boxes": lambda m, C, model: m.show_boxes(np.zeros((50, 60, 3), np.uint8), _cand(C)),
    "show_skeleton": lambda m, C, model: m.show_skeleton(
        np.zeros((50, 60, 3), np.uint8), _cand(C), np.array([0, 0, 1])),
    "show_part_clusters": lambda m, C, model: m.show_part_clusters(
        [np.random.RandomState(3).randn(20, 2) for _ in range(3)],
        [np.zeros(20, dtype=int), np.arange(20) % 2, np.arange(20) % 3], size=64),
    "visualize_hog": lambda m, C, model: m.visualize_hog(model.filters[0]),
}


@pytest.mark.parametrize("name", sorted(VIS))
def test_visualization_matches_the_jax_one(name):
    jmodel = make_synthetic_model(nparts=4, nmix=2, fsize=(4, 4), seed=31)
    got = VIS[name](vm, Candidate, model_from_jax(jmodel))
    want = VIS[name](jvm, JCandidate, jmodel)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert got.size and got.max() > 0


def test_chip_smokes_picture_shapes_are_the_jax_packages():
    """chip_smoke.py checks person26's pictures on the card machine, which
    has no JAX, against these shapes."""
    import sys

    from partsbaseddetector_tpu.models.model import make_person_like_model

    sys.path.insert(0, ROOT)
    import chip_smoke

    jmodel = make_person_like_model()
    assert jvm.visualize_model(jmodel).shape == chip_smoke.PERSON26_MOSAIC_SHAPE
    assert jvm.hog_picture(jmodel.filters[0]).shape == chip_smoke.HOG_GLYPH_SHAPE


def test_visualize_saves_an_image(tmp_path):
    from PIL import Image

    rgb = _frames(1)[0][0]
    path = str(tmp_path / "v.png")
    Visualize("v").image(Visualize("v").candidate(rgb, _cand(Candidate)), path)
    np.testing.assert_array_equal(
        np.asarray(Image.open(path)),
        jvis.Visualize("v").candidate(rgb, _cand(JCandidate)))


# --- profiling ------------------------------------------------------------


def test_timer_and_time_fn():
    t = profiling.Timer()
    x = torch.ones(8)
    with t.stage("a", result=[x, {"k": x}]):
        x = x * 2
    with t.stage("a"):
        pass
    t.record("b", 0.5)
    assert set(t.summary()) == {"a", "b"} and len(t.times["a"]) == 2
    assert "b: 500.00 ms" in t.report()
    assert profiling.time_fn(lambda v: v * 2, torch.ones(16), iters=3) >= 0


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as prof:
        torch.ones(64).cumsum(0)
    assert prof is not None
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0


def test_checked_raises_on_a_new_nan_only():
    f = profiling.checked(lambda a, b: (a / b).sum() + 1)
    assert f(torch.ones(3), torch.full((3,), 2.0)).item() == 2.5
    with pytest.raises(FloatingPointError, match="div"):
        f(torch.zeros(3), torch.zeros(3))
    held = torch.tensor([1.0, float("nan")])
    out = profiling.checked(lambda a: a * 2 + 1)(held)
    assert torch.isnan(out[1]) and out[0].item() == 3.0
    with pytest.raises(FloatingPointError, match="sqrt"):
        profiling.checked(torch.sqrt)(torch.tensor([-1.0]))
