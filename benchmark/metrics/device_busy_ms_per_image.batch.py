"""Device-busy ms an image of one profiled microbatch group."""

from benchmark.lib import readers


def read(ctx):
    return readers.device_busy_ms_per_image(ctx)
