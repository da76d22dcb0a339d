"""Percent of the window's wall time a frame with the device idle, by
the profiled detect's device-busy time."""

from benchmark.lib import readers


def read(ctx):
    return readers.device_idle_share(ctx)
