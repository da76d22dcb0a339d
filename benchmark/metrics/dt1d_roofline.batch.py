"""K1 (the dt1d family, y and x passes) against its roofline in one
profiled microbatch group: every DT pass's bytes at 3.35 TB/s over the
family's device time."""

from benchmark.lib import readers, work


def read(ctx):
    return readers.roofline(ctx, "dt1d", work.dt_bound_s)
