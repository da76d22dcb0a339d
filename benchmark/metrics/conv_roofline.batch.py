"""K2 (the conv family) against its roofline in one profiled microbatch
group: the least time of the group's correlation work (bytes at
3.35 TB/s or 3xTF32 products at 495 TFLOP/s) over its device time."""

from benchmark.lib import readers, work


def read(ctx):
    return readers.roofline(ctx, "conv", work.conv_bound_s)
