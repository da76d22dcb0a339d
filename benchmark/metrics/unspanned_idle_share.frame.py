"""Percent of one profiled detect's idle time, between its first and
its last device op, with the host in no span below the detect
(lib/spans.py)."""

from benchmark.lib import spans


def read(ctx):
    return spans.reading(ctx, "unspanned_idle_share")
