"""The plain reference (benchmark/reference/pbd_tree.py) against the
NumPy loop semantics of the reference code (the port's frozen copy of
ops/reference.py, used here as an independent oracle), its DP of each
component of a several-tree model against the one-tree DP on that
component alone, and the program's CPU path against the reference
through a whole run of each cell."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.lib import inputs, spec
from benchmark.reference import pbd_tree as ref
from benchmark.tests import _small
from partsbaseddetector_tpu_torch.ops import reference as loops


def test_resize_and_reduce_follow_the_weights():
    rng = np.random.RandomState(0)
    im = rng.randint(0, 256, (37, 45, 3)).astype(np.float32)
    got = ref.resize(torch.as_tensor(im), 0.8).numpy()
    want = loops.resize(im, 0.8).astype(np.float32)
    np.testing.assert_array_equal(got, want)
    got = ref.reduce(torch.as_tensor(im)).numpy()
    np.testing.assert_array_equal(got, loops.reduce(im).astype(np.float32))


@pytest.mark.parametrize("shape", [(24, 32), (29, 38)])
def test_hog_equals_the_loop_hog(shape):
    rng = np.random.RandomState(1)
    im = rng.randint(0, 256, (*shape, 3)).astype(np.float32)
    got = ref.hog(torch.as_tensor(im), 4).numpy()
    want = loops.hog(im, 4)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_distance_transform_equals_the_envelope_scan():
    rng = np.random.RandomState(2)
    src = rng.randn(2, 9, 11)
    defs = np.array([[0.03, 0.01, 0.02, -0.02], [0.05, -0.01, 0.01, 0.0]])
    shift = np.array([[3, 1], [0, 4]])
    got = ref.distance_transform(torch.as_tensor(src), torch.as_tensor(defs),
                                 torch.as_tensor(shift), 7, 10).numpy()
    for k in range(2):
        want, _, _ = loops.shift_dt_2d(src[k], defs[k], shift[k, 0], shift[k, 1], 10, 7)
        np.testing.assert_allclose(got[k], want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("config", ["person26", "trees3"])
def test_each_components_dp_is_the_one_tree_dp_on_it_alone(config):
    """Every component's root scores of each level, from the pool's
    responses, are the bits of root_scores on that component alone (its
    tree over the responses its parts index, in part order); detections
    are every component's cells at or above the threshold, best first."""
    torch.set_num_threads(4)
    cfg = _small.trees3_config() if config == "trees3" else spec.load().config("person26")
    cfg = {**cfg, "frame_h": 48, "frame_w": 64}
    g = inputs.generator(2**31 + 5, "cpu")
    model = ref.model_from_arrays(inputs.model_arrays(cfg, g, "cpu"), cfg["interval"],
                                  cfg["sbin"], cfg["thresh"])
    frame = torch.as_tensor(inputs.frames(cfg, 1, g, "cpu")[0])
    det = ref.detect(frame, model)
    feats, _ = ref.pyramid(frame, model)
    ntrees = len(model.trees)
    kept = []
    for level, f in enumerate(feats):
        resp = ref.responses(f, model.filters)
        h, w = det.grid[level].tolist()
        off = int(det.root_off[level])
        both = det.root[off : off + ntrees * h * w].reshape(ntrees, h, w)
        for c, tree in enumerate(model.trees):
            own = torch.arange(tree.filterid.numel()).reshape(tree.filterid.shape)
            alone = ref.Tree(tree.parent, own, tree.defs, tree.anchors, tree.bias)
            assert torch.equal(both[c], ref.root_scores(resp[tree.filterid.reshape(-1)], alone))
        kept.append(both[both >= model.thresh])
    assert torch.equal(det.scores, torch.cat(kept).sort(descending=True).values)
    assert det.scores.numel() > 0 and (ntrees == 1 or not torch.equal(both[0], both[1]))


@pytest.mark.parametrize("name", ["person26.frame", "person26.batch"])
def test_the_program_is_correct_against_the_reference(name):
    out = _small.run(name)
    assert out["failed"] == 0 and out["seconds"]["answers_compared"] >= 1
    assert out["correct"], out["compared"]
