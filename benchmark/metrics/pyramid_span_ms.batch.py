"""Median over the spanned requests of the ms in the HOG pyramid's span in
a microbatch group, per image (lib/spans.py)."""

from benchmark.lib import spans


def read(ctx):
    return spans.reading(ctx, "span_ms", "pyramid")
