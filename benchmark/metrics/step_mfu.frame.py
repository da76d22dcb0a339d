"""Percent of 165 TFLOP/s (f32 as 3xTF32) that the window's model FLOPs take."""

from benchmark.lib import readers


def read(ctx):
    return readers.step_mfu(ctx)
