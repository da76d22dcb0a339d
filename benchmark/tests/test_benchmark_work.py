"""The work arithmetic of the roofline shares and step_mfu: the
correlation counted at every level's own size, and, as the
implementation's figure, over the bucket stacks, which reproduces the
counts PERF.md carried before the benchmark (chip_smoke.py's, from the
detect's captured bucket stacks) at the shapes they were taken at; a
model of several trees counted by its pool and its trees' parts; and
person26's figures pinned to those of the one-tree arithmetic."""

from __future__ import annotations

import pytest

from benchmark.lib import spec, work
from benchmark.tests import _small


def _person26(**change):
    return {**spec.load().config("person26"), **change}


# the shapes of PRs 7-15's counts: 26 parts x 4 mixtures, and a 68-part,
# 3-mixture model at interval 5 with one bucket per octave
PR7_PERSON = dict(mixtures=4)
PR14_FACE68 = dict(parts=68, mixtures=3, interval=5, buckets_per_octave=1,
                   parents=[0] + list(range(67)))


def test_the_padded_stacks_reproduce_the_kernel_tables_counts():
    flops, nbytes = work.conv_work_padded(_person26(**PR7_PERSON))
    assert round(flops / 1e9, 2) == 36.82
    assert round(nbytes / 1e6, 1) == 123.4
    assert work.conv_bound_s(_person26(**PR7_PERSON), work=work.conv_work_padded) * 1e3 == \
        pytest.approx(0.2231, abs=1e-4)
    flops, _ = work.conv_work_padded(_person26(**PR14_FACE68))
    assert round(flops / 1e9, 2) == 47.21


def test_the_roofline_counts_each_level_at_its_own_size():
    cfg = _person26()
    assert len(work.levels(cfg)) == 46
    flops, nbytes = work.conv_work(cfg)
    cells = sum(work.response_cells(cfg))
    assert flops == 2.0 * cells * 800 * 26 * cfg["mixtures"]
    assert flops < work.conv_work_padded(cfg)[0]
    assert nbytes < work.conv_work_padded(cfg)[1]
    assert work.conv_bound_s(cfg) == pytest.approx(3.0 * flops / work.TF32_FLOPS)
    # the padding is the implementation's: the work does not move with it
    assert work.conv_work(_person26(buckets_per_octave=1)) == (flops, nbytes)


def test_dt_bytes_match_the_kernel_table_shape():
    """The K1 row's bound, 0.0140 ms for y + x over (80, 126, 166)."""
    cells = 126 * 166
    assert 28.0 * 80 * cells / work.HBM_BYTES_PER_S * 1e3 == pytest.approx(0.0140, abs=1e-4)
    cfg = _person26()
    assert work.dt_bytes(cfg, 8) == \
        8 * 28.0 * 25 * cfg["mixtures"] * sum(work.response_cells(cfg))


def test_model_flops_count_the_exact_pyramid():
    cfg = _person26(**PR7_PERSON)
    conv_exact = 2.0 * sum(work.response_cells(cfg)) * 800 * 104
    assert conv_exact / 1e9 == pytest.approx(26.10, abs=0.01)
    assert work.model_flops(cfg) > conv_exact
    assert work.F32_PROFILE_FLOPS == 165e12


def test_person26s_figures_are_the_one_tree_arithmetics():
    """The figures of a frame and of a microbatch of 8 as the one-tree
    arithmetic (parts x mixtures x components) gave them."""
    cfg = _person26()
    assert work.n_filters(cfg) == 156 and work.dt_children(cfg) == 150
    assert work.conv_work(cfg) == (39143520000.0, 120680816.0)
    assert work.conv_work(cfg, 8) == (313148160000.0, 961952128.0)
    assert work.conv_work_padded(cfg) == (55224249600.0, 169608400.0)
    assert work.dt_bytes(cfg) == 658665000.0
    assert work.dt_bytes(cfg, 8) == 5269320000.0
    assert work.model_flops(cfg) == 39849232500.0
    assert work.conv_bound_s(cfg) == 0.00023723345454545455
    assert work.dt_bound_s(cfg) == 0.00019661641791044777
    face68 = _person26(**PR14_FACE68)
    assert work.conv_work(face68) == (27305644800.0, 80785200.0)
    assert work.model_flops(face68) == 27810096510.0
    assert work.dt_bytes(face68) == 470821596.0


def test_several_trees_count_the_pool_and_every_trees_children():
    cfg = _small.trees3_config()
    cells = sum(work.response_cells(cfg))
    assert work.n_filters(cfg) == 9 and work.dt_children(cfg) == 5 + 5 + 2
    assert work.conv_work(cfg)[0] == 2.0 * cells * 800 * 9
    assert work.dt_bytes(cfg) == 28.0 * 12 * cells
    assert work.model_flops(cfg) == 2.0 * cells * 800 * 9 + 2.0 * 15.0 * cells * 12
    # Share-146's shape: 7 views of 68 parts and 6 of 39 over 146 filters
    share = {**cfg, "pool": 146, "trees": [
        {"parents": [0] + list(range(n - 1)), "filters": [[p % 146] for p in range(n)]}
        for n in [39] * 3 + [68] * 7 + [39] * 3]}
    assert work.n_filters(share) == 146
    assert work.dt_children(share) == 7 * 67 + 6 * 38


def test_a_two_resolution_stars_figures_by_hand():
    """STAR2 (two roots of 6x4 and 4x6, each with four 3x3 parts one
    octave finer and a 3x3 grandchild on its parent's finer level) at
    480x640: the levels pad by maxsize (6, 6); K2 takes each filter once
    a level at its own size; the DTs run at root levels 10 and up, where
    a level an octave finer exists, each child map on its own level's
    grid and its parent's."""
    cfg = _small.star2_config()
    lv = work.levels(cfg)
    n, i = len(lv), cfg["interval"]
    assert n == 46 and lv[0] == (120 - 2 + 2 * 5, 160 - 2 + 2 * 5)
    grid = lambda level, fh, fw: (lv[level][0] - fh + 1, lv[level][1] - fw + 1)
    cells = lambda fh, fw: sum(h * w for h, w in (grid(level, fh, fw) for level in range(n)))
    k2 = 2 * 32 * (6 * 4 * cells(6, 4) + 4 * 6 * cells(4, 6) + 10 * 3 * 3 * cells(3, 3))
    assert work.conv_work(cfg)[0] == k2
    assert work.dt_children(cfg) == 10

    def tree(rh, rw):
        """(sources, y-pass outputs, x-pass outputs) of one tree's maps."""
        src = mid = out = 0
        for level in range(i, n):
            hc, wc = grid(level - i, 3, 3)  # every child's map, an octave finer
            hr, wr = grid(level, rh, rw)  # the root's map
            src += 4 * hc * wc + hc * wc
            mid += 4 * hr * wc + hc * wc
            out += 4 * hr * wr + hc * wc
        return src, mid, out

    src, mid, out = (a + b for a, b in zip(tree(6, 4), tree(4, 6)))
    assert work.dt_bytes(cfg) == 4 * src + 16 * mid + 8 * out
    assert work.dt_bytes(cfg, 8) == 8 * (4 * src + 16 * mid + 8 * out)
    assert work.model_flops(cfg) == k2 + 10 * (src + mid) + 5 * (mid + out)
