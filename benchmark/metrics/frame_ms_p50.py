"""Median ms of a detect request, host uint8 frame to candidates, over the window."""

from benchmark.lib import readers


def read(ctx):
    return readers.frame_ms(ctx, 50)
