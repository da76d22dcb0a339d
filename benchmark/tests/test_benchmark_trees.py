"""A model of several trees over a shared filter pool (the component form
of a configuration's file, lib/spec.py::trees), added to a copy of the
benchmark as new files only: it is found, generated, built into the
program, run by the reference and compared per candidate's component;
candidates moved to another tree are caught; malformed trees are
refused. And the one-tree form draws the bits it drew before the
component form existed."""

from __future__ import annotations

import hashlib

import pytest

from benchmark.lib import compare, inputs, spec
from benchmark.tests import _small
from partsbaseddetector_tpu_torch import types

# sha256 of person26's arrays (filters, defs, anchors, bias, parent) on
# the CPU, as the one-tree harness drew them before the component form
PERSON26_DIGESTS = {
    2**31 + 12345: "ff219cb0dfd65e5172a57a9322b564ef2ea31a614f6df3dd6ee9ee5cecaef6d0",
    4700000001: "ba4947adae7f3c8cfb707720da010b7713edea97c88d5e2b9b132e79038f2bc2",
}


def _digest(arrays) -> str:
    (tree,) = arrays["trees"]
    h = hashlib.sha256()
    for x in (arrays["filters"], tree["defs"], tree["anchors"], tree["bias"], tree["parent"]):
        h.update(x.contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("seed", sorted(PERSON26_DIGESTS))
def test_person26s_arrays_are_the_one_tree_harness_bits(seed):
    cfg = spec.load().config("person26")
    assert _digest(inputs.model_arrays(cfg, inputs.generator(seed, "cpu"), "cpu")) == \
        PERSON26_DIGESTS[seed]


def test_the_one_tree_form_is_the_one_component_case():
    """person26 written as one tree over a pool of 156 draws the same
    arrays as its one-tree file."""
    one = spec.load().config("person26")
    k = one["mixtures"]
    comp = {key: v for key, v in one.items() if key not in ("parts", "parents", "components")}
    comp.update(pool=26 * k, trees=[{"parents": one["parents"],
                                     "filters": [[p * k + m for m in range(k)]
                                                 for p in range(26)]}])
    seed = 2**31 + 12345
    assert _digest(inputs.model_arrays(comp, inputs.generator(seed, "cpu"), "cpu")) == \
        PERSON26_DIGESTS[seed]


def test_the_component_form_draws_the_pool_then_each_tree():
    cfg = _small.trees3_config()
    arrays = inputs.model_arrays(cfg, inputs.generator(5, "cpu"), "cpu")
    assert tuple(arrays["filters"].shape) == (9, 5, 5, 32)
    assert [tuple(t["defs"].shape) for t in arrays["trees"]] == [(6, 1, 4), (6, 1, 4), (3, 1, 4)]
    assert arrays["trees"][1]["filterid"][:, 0].tolist() == [6, 1, 2, 7, 4, 8]
    # view-specific springs over shared templates: each tree draws its own
    assert not (arrays["trees"][0]["defs"][:3] == arrays["trees"][1]["defs"][:3]).all()


def test_a_model_of_several_trees_is_added_without_edits(tmp_path):
    before = {p.relative_to(_small.ROOT): p.read_bytes()
              for p in (_small.ROOT / "benchmark").rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    s = _small.add_trees3(tmp_path)
    for rel, b in before.items():
        assert (tmp_path / rel).read_bytes() == b, rel
    assert spec.trees(s.config("trees3"))[0] == 9
    assert {m.name for m in s.metrics_for("trees3.frame", "end_to_end")} == \
        {m.name for m in s.metrics_for("person26.frame", "end_to_end")}


def _components_compared(monkeypatch) -> set:
    seen = set()
    orig = compare.answer_readings

    def answer_readings(cands, *a, **kw):
        seen.update(c.component for c in cands)
        return orig(cands, *a, **kw)

    monkeypatch.setattr(compare, "answer_readings", answer_readings)
    return seen


@pytest.mark.parametrize("traffic", ["frame", "batch"])
def test_a_model_of_several_trees_is_correct(tmp_path, monkeypatch, traffic):
    seen = _components_compared(monkeypatch)
    out = _small.run_in(_small.add_trees3(tmp_path), f"trees3.{traffic}")
    assert out["failed"] == 0 and out["seconds"]["answers_compared"] >= 1
    assert out["correct"], out["compared"]
    assert seen - {0}, seen


def _move(kind: str):
    """A candidate of a 6-part tree relabelled to the other 6-part tree,
    or trimmed to the 3-part tree's count."""
    orig = types.DetectionResult.to_candidates

    def to_candidates(self):
        cands = orig(self)
        c = next(c for c in cands if c.component in (0, 1))
        if kind == "relabel":
            c.component = 1 - c.component
        else:
            c.parts, c.confidence, c.mixtures = c.parts[:3], c.confidence[:3], c.mixtures[:3]
        return cands

    return to_candidates


@pytest.mark.parametrize("traffic", ["frame", "batch"])
@pytest.mark.parametrize("kind", ["relabel", "trim"])
def test_a_candidate_in_another_tree_is_not_correct(tmp_path, monkeypatch, traffic, kind):
    s = _small.add_trees3(tmp_path)
    monkeypatch.setattr(types.DetectionResult, "to_candidates", _move(kind))
    out = _small.run_in(s, f"trees3.{traffic}")
    assert out["seconds"]["answers_compared"] >= 1
    assert not out["correct"], out["compared"]


def _bad(change: str) -> dict:
    cfg = _small.trees3_config()
    trees = cfg["trees"]
    if change == "parent_after_child":
        trees[1]["parents"][2] = 3
    elif change == "parent_is_itself":
        trees[0]["parents"][4] = 4
    elif change == "root_has_a_parent":
        trees[2]["parents"][0] = 1
    elif change == "index_out_of_range":
        trees[2]["filters"][1] = [9]
    elif change == "negative_index":
        trees[0]["filters"][0] = [-1]
    elif change == "row_of_two":
        trees[1]["filters"][3] = [7, 8]
    elif change == "empty_row":
        trees[0]["filters"][5] = []
    elif change == "rows_not_parts":
        trees[2]["filters"].pop()
    elif change == "unknown_tree_key":
        trees[0]["anchors"] = []
    elif change == "no_trees":
        cfg["trees"] = []
    elif change == "one_tree_keys_beside":
        cfg["parts"] = 6
    elif change == "components_not_trees":
        cfg["components"] = 2
    elif change == "no_pool":
        del cfg["pool"]
    return cfg


@pytest.mark.parametrize("change", [
    "parent_after_child", "parent_is_itself", "root_has_a_parent", "index_out_of_range",
    "negative_index", "row_of_two", "empty_row", "rows_not_parts", "unknown_tree_key",
    "no_trees", "one_tree_keys_beside", "components_not_trees", "no_pool"])
def test_a_malformed_tree_is_refused(tmp_path, change):
    with pytest.raises(spec.SpecError):
        _small.add_trees3(tmp_path, _bad(change))


@pytest.mark.parametrize("change", [{"parts": 25}, {"components": 2},
                                    {"parents": [0, 0, 1, 3]}])
def test_a_malformed_one_tree_file_is_refused(change):
    cfg = {**spec.load().config("person26"), **change}
    with pytest.raises(spec.SpecError):
        spec.trees(cfg)


def test_the_components_count_as_written():
    cfg = {**_small.trees3_config(), "components": 3}
    pool, trees = spec.trees(cfg)
    # every part on its parent's level where a tree gives no ds
    assert pool == 9 and trees == [{**t, "ds": [0] * len(t["parents"])}
                                   for t in _small.TREES3["trees"]]
