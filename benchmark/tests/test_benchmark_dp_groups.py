"""The reader of the tree DP's level groups (`dp_groups_per_image.frame`,
the program's `utils.tree_counts()["dp_groups"]`), beside the other
counter readers of `test_benchmark_face146.py`: both frame cells list it;
on the CPU at a small size a face146 detect reads its trees' depth, 14,
a bucket; and a program that counts no groups, with or without the tree
counters, reads nothing and raises nothing."""

from __future__ import annotations

import sys
import types

from benchmark.lib import spec, work
from benchmark.tests import _small
from benchmark.tests.test_benchmark_face146 import SMALL, _cfg
from partsbaseddetector_tpu_torch.utils import profiling

NAME = "dp_groups_per_image.frame"


def _reading():
    metric = {m.name: m for m in spec.load().metrics}[NAME]
    return spec.load_module(metric.reader_path(), f"metric_{NAME}").read(None)


def test_both_frame_cells_list_the_reader():
    s = spec.load()
    for cell in ("person26.frame", "face146.frame"):
        assert NAME in {m.name for m in s.metrics_for(cell, "per_layer")}
    assert NAME not in {m.name for m in s.metrics_for("person26.batch", "per_layer")}


def test_the_reader_reads_a_detects_groups(monkeypatch):
    for key in profiling.tree_work:
        monkeypatch.setitem(profiling.tree_work, key, 0)
    assert _reading() is None
    out = _small.run("face146.frame", frame=SMALL)
    assert out["correct"], out["compared"]
    buckets = -(-len(work.levels({**_cfg(), **SMALL})) // 5)
    assert buckets == 2
    assert _reading() == 14.0 * buckets


def test_a_program_without_the_group_count_reads_nothing(monkeypatch):
    # the tree counters as the program had them before the level groups
    utils = types.ModuleType("partsbaseddetector_tpu_torch.utils")
    utils.tree_counts = lambda: {"images": 3, "dp_pairs": 39, "walks": 39, "tail_rows": 0}
    monkeypatch.setitem(sys.modules, "partsbaseddetector_tpu_torch.utils", utils)
    assert _reading() is None
    # and without any tree counters
    monkeypatch.setitem(sys.modules, "partsbaseddetector_tpu_torch.utils",
                        types.ModuleType("partsbaseddetector_tpu_torch.utils"))
    assert _reading() is None
