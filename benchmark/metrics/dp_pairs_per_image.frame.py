"""(bucket, tree) DPs a detect schedules, one tree_min_sum each, whether
its CUDA graph captures, replays or runs them eagerly: the program's
tree_counts() (lib/counters.py)."""

from benchmark.lib import counters


def read(ctx):
    return counters.per_image("dp_pairs")
