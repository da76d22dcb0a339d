"""Percent of the window's wall time an image with the device idle, by
the profiled microbatch group's device-busy time an image."""

from benchmark.lib import readers


def read(ctx):
    return readers.device_idle_share(ctx)
