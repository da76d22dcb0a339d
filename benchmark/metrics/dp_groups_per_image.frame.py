"""Level groups a detect's tree DP runs, one batched DT each across every
tree a bucket scores, whether its CUDA graph captures, replays or runs
them eagerly: the program's tree_counts() (lib/counters.py). A program
whose tree_counts() has no `dp_groups` reads nothing."""

from benchmark.lib import counters


def read(ctx):
    try:
        return counters.per_image("dp_groups")
    except KeyError:
        return None
