"""Device-busy ms of one profiled detect: the device's side of a frame,
steadier from run to run than the host-clock metrics it sits beside."""

from benchmark.lib import readers


def read(ctx):
    return readers.device_busy_ms_per_image(ctx)
