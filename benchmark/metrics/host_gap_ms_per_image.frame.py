"""ms a frame with no device op running: the window's wall ms a frame
less the profiled detect's device-busy ms."""

from benchmark.lib import readers


def read(ctx):
    return readers.host_gap_ms_per_image(ctx)
