"""Median over the spanned requests of the ms in the tree DPs' spans in a
detect (lib/spans.py)."""

from benchmark.lib import spans


def read(ctx):
    return spans.reading(ctx, "span_ms", "dp")
