"""The torch port's evaluation (eval/metrics.py) and point-cloud stages
(cloud.py) against the JAX package's, on the CPU, on seeded inputs.

Both are NumPy (and scipy) code in both packages, so the results are
equal exactly; test_model gives the same PCK through the port's
detectors as through the JAX package's."""

import numpy as np
import pytest

from partsbaseddetector_tpu import cloud as jcloud
from partsbaseddetector_tpu.cpu_detector import CPUPartsBasedDetector as JaxCPU
from partsbaseddetector_tpu.depth import Rect3 as JRect3
from partsbaseddetector_tpu.depth import StereoCameraModel as JCamera
from partsbaseddetector_tpu.detector import PartsBasedDetector as JaxDetector
from partsbaseddetector_tpu.eval import metrics as jm
from partsbaseddetector_tpu.models.model import make_synthetic_model
from partsbaseddetector_tpu.types import Candidate as JCandidate
from partsbaseddetector_tpu_torch import cloud
from partsbaseddetector_tpu_torch import CPUPartsBasedDetector, PartsBasedDetector
from partsbaseddetector_tpu_torch.depth import Rect3, StereoCameraModel
from partsbaseddetector_tpu_torch.eval import metrics as tm
from partsbaseddetector_tpu_torch.models.convert import model_from_jax
from partsbaseddetector_tpu_torch.types import Candidate


def _keypoint_sets(rng):
    gt = rng.rand(6, 5, 2) * 100
    pred = gt + rng.randn(6, 5, 2) * 6
    return pred, gt


def _apk_inputs(rng):
    gts = [rng.rand(rng.randint(0, 3), 4, 2) * 80 for _ in range(5)]
    preds = [
        np.concatenate([g + rng.randn(*g.shape) * 3, rng.rand(2, 4, 2) * 80])
        for g in gts
    ]
    scores = [rng.randn(len(p)) for p in preds]
    return preds, scores, gts


def _part_boxes(rng, n, nparts=4, h=60, w=80):
    x1 = rng.rand(n, nparts) * (w - 20)
    y1 = rng.rand(n, nparts) * (h - 20)
    size = 4 + rng.rand(n, nparts, 2) * 14
    return np.stack([x1, y1, x1 + size[..., 0], y1 + size[..., 1]], axis=-1)


METRICS = {
    "eval_pck": lambda m, rng: m.eval_pck(*_keypoint_sets(rng), thresh=0.1),
    "voc_ap": lambda m, rng: m.voc_ap(np.sort(rng.rand(12)), rng.rand(12)),
    "eval_apk": lambda m, rng: m.eval_apk(*_apk_inputs(rng), thresh=0.15),
    "best_overlap": lambda m, rng: m.best_overlap(
        _part_boxes(rng, 7), _part_boxes(rng, 1)[0]),
    "boxes_to_keypoints": lambda m, rng: m.boxes_to_keypoints(_part_boxes(rng, 3)),
}


@pytest.mark.parametrize("name", sorted(METRICS))
def test_metric_equals_jax(name):
    for seed in range(3):
        got = METRICS[name](tm, np.random.RandomState(seed))
        want = METRICS[name](jm, np.random.RandomState(seed))
        np.testing.assert_array_equal(got, want)


# --- cloud ---------------------------------------------------------------


def _scene(seed=0, h=60, w=80):
    """A depth map in metres (a near object on a far wall, NaN and zero
    holes) and candidates of both packages with the same boxes."""
    rng = np.random.RandomState(seed)
    depth = np.full((h, w), 3.0) + rng.randn(h, w) * 0.01
    depth[15:45, 20:50] = 1.5 + rng.randn(30, 30) * 0.005
    depth[rng.rand(h, w) < 0.05] = np.nan
    depth[rng.rand(h, w) < 0.03] = 0.0
    boxes = _part_boxes(rng, 3, h=h, w=w)
    boxes[0] = [[20, 15, 35, 30], [30, 20, 48, 40], [22, 30, 40, 44], [25, 18, 30, 25]]
    conf = np.zeros((3, 4))
    conf[:, 0] = [2.0, 1.0, 0.5]
    cams = (StereoCameraModel(fx=90.0, fy=95.0, cx=39.5, cy=29.5),
            JCamera(fx=90.0, fy=95.0, cx=39.5, cy=29.5))
    cands = ([Candidate(b, c) for b, c in zip(boxes, conf)],
             [JCandidate(b, c) for b, c in zip(boxes, conf)])
    return depth.astype(np.float32), cams, cands


def _rect(r):
    return (r.x, r.y, r.z, r.width, r.height, r.depth)


def _assert_arrays_equal(xs, ys):
    assert len(xs) == len(ys)
    for x, y in zip(xs, ys):
        np.testing.assert_array_equal(x, y)


def test_compute_bounding_boxes_equals_jax():
    depth, (cam, jcam), (cands, jcands) = _scene()
    boxes, centers = cloud.compute_bounding_boxes(cands, depth.shape, depth, cam)
    jboxes, jcenters = jcloud.compute_bounding_boxes(jcands, depth.shape, depth, jcam)
    assert [_rect(b) for b in boxes] == [_rect(b) for b in jboxes]
    _assert_arrays_equal(centers, jcenters)
    assert np.isfinite(_rect(boxes[0])).all()


def test_depth_to_cloud_equals_jax():
    depth, (cam, jcam), _ = _scene(1)
    got = cloud.depth_to_cloud(depth, cam)
    np.testing.assert_array_equal(got, jcloud.depth_to_cloud(depth, jcam))
    assert got.shape == (depth.size, 3)


def test_euclidean_clusters_same_index_sets():
    rng = np.random.RandomState(2)
    pts = np.concatenate([rng.randn(60, 3) * 0.004 + c
                          for c in ([0, 0, 1], [0.2, 0, 1], [0, 0.3, 1.2])])
    pts = np.concatenate([pts, rng.rand(30, 3)])
    got = cloud.euclidean_clusters(pts, tolerance=0.01, min_size=2)
    _assert_arrays_equal(got, jcloud.euclidean_clusters(pts, tolerance=0.01, min_size=2))
    assert len(got) >= 3 and len(got[0]) >= len(got[-1])


def test_cluster_objects_equals_jax():
    depth, (cam, jcam), _ = _scene(3)
    pc = cloud.depth_to_cloud(depth, cam)
    boxes = [Rect3(-0.4, -0.3, 1.4, 0.6, 0.5, 0.2), Rect3(np.nan, 0, 0, 1, 1, 1),
             Rect3(5.0, 5.0, 5.0, 0.1, 0.1, 0.1)]
    jboxes = [JRect3(*_rect(b)) for b in boxes]
    clusters, centroids = cloud.cluster_objects(pc, boxes, tolerance=0.05)
    jclusters, jcentroids = jcloud.cluster_objects(pc, jboxes, tolerance=0.05)
    _assert_arrays_equal(clusters, jclusters)
    _assert_arrays_equal(centroids, jcentroids)
    assert len(clusters[0]) > 0 and np.isfinite(centroids[0]).all()


def test_remove_planes_equals_jax():
    rng = np.random.RandomState(4)
    xs, ys = rng.rand(2, 1500) * 2
    plane = np.stack([xs, ys, 0.01 * rng.randn(1500)], axis=1)
    obj = rng.randn(200, 3) * 0.05 + [1, 1, 0.5]
    pc = np.concatenate([plane, obj, np.full((5, 3), np.nan)])
    got = cloud.remove_planes(pc, distance_threshold=0.03, min_inliers=300, seed=3)
    np.testing.assert_array_equal(
        got, jcloud.remove_planes(pc, distance_threshold=0.03, min_inliers=300, seed=3))
    assert 0 < len(got) < 400


def test_estimate_poses_equals_jax():
    rng = np.random.RandomState(5)
    centroids = [rng.randn(3), rng.randn(3), np.full(3, np.nan)]
    centers = [rng.randn(6, 3), rng.randn(2, 3), rng.randn(4, 3)]
    centers[0][2] = np.nan
    got = cloud.estimate_poses(centroids, centers)
    _assert_arrays_equal(got, jcloud.estimate_poses(centroids, centers))
    r = got[0][:3, :3]
    np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-12)


# --- test_model through both packages' detectors --------------------------


def test_test_model_gives_the_jax_pck():
    jmodel = make_synthetic_model(
        nparts=4, nmix=2, fsize=(4, 4), sbin=8, interval=2, thresh=0.0, seed=40
    )
    model = model_from_jax(jmodel)
    rng = np.random.RandomState(7)
    images = [(rng.rand(72, 96, 3) * 255).astype(np.float32) for _ in range(3)]
    # ground truth: the JAX CPU detector's best candidate's keypoints,
    # moved by a few pixels
    jcpu = JaxCPU(jmodel)
    gts = []
    for im in images:
        best = jcpu.detect(im)[0]
        kp = jm.boxes_to_keypoints(best.parts)
        gts.append((kp + rng.randn(*kp.shape) * 2.5)[None])
    want = jm.test_model(jcpu, images, gts, thresh=0.1)
    got = tm.test_model(CPUPartsBasedDetector(model), images, gts, thresh=0.1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tm.test_model(PartsBasedDetector(model, max_detections=64, device="cpu"),
                      images, gts, thresh=0.1),
        jm.test_model(JaxDetector(jmodel, max_detections=64), images, gts, thresh=0.1))
    assert 0.0 < want.mean() <= 1.0
    gt_boxes = [jcpu.detect(im)[0].parts for im in images]
    np.testing.assert_array_equal(
        tm.test_model_gtbox(CPUPartsBasedDetector(model), images, gt_boxes),
        jm.test_model_gtbox(jcpu, images, gt_boxes))
