"""Median over the spanned requests of the ms in the pack, readback and
assemble spans in a detect (lib/spans.py)."""

from benchmark.lib import spans


def read(ctx):
    return spans.reading(ctx, "span_ms", "readback")
