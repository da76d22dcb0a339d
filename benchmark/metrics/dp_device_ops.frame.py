"""Device ops of one profiled detect issued inside the tree DPs' spans:
each device event by the CUDA runtime call that issued it
(lib/spans.py)."""

from benchmark.lib import spans


def read(ctx):
    return spans.reading(ctx, "layer_ops", "dp")
