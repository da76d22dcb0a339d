"""Backtracks a detect walks (backtrack_merged and backtrack calls, one
a tree on the merged path): the program's tree_counts()
(lib/counters.py)."""

from benchmark.lib import counters


def read(ctx):
    return counters.per_image("walks")
