"""Median over the spanned requests of the ms in the backtrack and select
spans (backtracks, top-k, re-score, NMS, final gathers) in a detect
(lib/spans.py)."""

from benchmark.lib import spans


def read(ctx):
    return spans.reading(ctx, "span_ms", "backtrack")
