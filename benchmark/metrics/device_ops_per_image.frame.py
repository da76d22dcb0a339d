"""Device ops (kernels, copies, memsets) of one profiled detect."""

from benchmark.lib import readers


def read(ctx):
    return readers.device_ops_per_image(ctx)
