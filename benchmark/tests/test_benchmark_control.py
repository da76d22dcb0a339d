"""The control: the reference's comparison must fail the program's plain
bf16 profile, the nearest precision below the configuration's float32.
On the CPU at a small size; on the card at the cell's own size (marked
cuda, skipped without a card)."""

from __future__ import annotations

import pytest
import torch

from benchmark import calibrate
from benchmark.lib import compare, spec as spec_mod
from benchmark.tests import _small


@pytest.mark.parametrize("name", ["person26.frame", "person26.batch"])
def test_the_bf16_control_is_not_correct(name):
    out = _small.run(name, overrides=calibrate.control())
    assert out["failed"] == 0 and out["seconds"]["answers_compared"] >= 1
    assert not out["correct"], out["compared"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["person26.frame", "person26.batch"])
def test_the_control_fails_at_the_cells_size_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    seeds = [2**31 + 101, 2**31 + 102, 2**31 + 103]
    program, control = calibrate.collect(name, seeds, seeds, 3.0, emit=lambda line: None)
    limits = spec_mod.load().limits(name)
    assert all(compare.verdict(r, limits) for r in program), program
    assert not any(compare.verdict(r, limits) for r in control), control
