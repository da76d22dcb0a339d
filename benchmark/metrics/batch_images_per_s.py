"""Images completed over the whole window (its last request finished)."""

from benchmark.lib import readers


def read(ctx):
    return readers.images_per_s(ctx)
