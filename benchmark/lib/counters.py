"""The program's own counters of its tree work (a program_counter
source): `utils.tree_counts()` of the port, cumulative host integers
that every detect adds to. A program without them reads nothing here.

A reading is a per-image ratio over every detect the process has run
(warm-up, window, traced and spanned requests). In a `frame` cell every
one of them is one frame of the cell's size on the cell's model, so the
ratio is one detect's."""

from __future__ import annotations

from typing import Optional


def per_image(key: str) -> Optional[float]:
    """tree_counts()[key] over its images; None where the program has
    no tree_counts or has run no image."""
    try:
        from partsbaseddetector_tpu_torch.utils import tree_counts
    except ImportError:
        return None
    counts = tree_counts()
    return counts[key] / counts["images"] if counts["images"] else None
