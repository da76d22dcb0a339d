"""A whole run of each cell on the CPU, with the timed path broken
underneath, must come out not correct: an answer altered where the
program produces it (a score, a part's mixture, a part's box), and half
of a batch left out (its answers repeated from the other half)."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark.lib import spec
from benchmark.tests import _small
from partsbaseddetector_tpu_torch import detector, types

K = spec.load().config("person26")["mixtures"]


def _alter(kind: str):
    orig = types.DetectionResult.to_candidates

    def to_candidates(self):
        cands = orig(self)
        if cands:
            c = cands[len(cands) // 2]
            if kind == "score":
                c.confidence[0] += 0.05
            elif kind == "mixture":
                c.mixtures[1] = (c.mixtures[1] + 1) % K
            elif kind == "box":
                c.parts[2] = c.parts[2] + np.array([4.0, 0.0, 4.0, 0.0])
        return cands

    return to_candidates


@pytest.mark.parametrize("name", ["person26.frame", "person26.batch"])
@pytest.mark.parametrize("kind", ["score", "mixture", "box"])
def test_an_altered_answer_is_not_correct(monkeypatch, name, kind):
    monkeypatch.setattr(types.DetectionResult, "to_candidates", _alter(kind))
    out = _small.run(name)
    assert not out["correct"], out["compared"]


def test_half_of_the_batch_left_out_is_not_correct(monkeypatch):
    orig = detector.PartsBasedDetector.detect_many

    def detect_many(self, images, **kw):
        half = orig(self, images[: len(images) // 2], **kw)
        return half + half

    monkeypatch.setattr(detector.PartsBasedDetector, "detect_many", detect_many)
    out = _small.run("person26.batch")
    assert not out["correct"], out["compared"]
