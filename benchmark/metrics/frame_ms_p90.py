"""90th-percentile ms of a detect request over the window."""

from benchmark.lib import readers


def read(ctx):
    return readers.frame_ms(ctx, 90)
