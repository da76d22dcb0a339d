"""C-semantics rounding.

The reference's size arithmetic uses C round() / MATLAB round(), which
round halves AWAY from zero; Python's round() is banker's rounding.
Sizes like round(37 * 0.5) diverge (C: 19, Python: 18), which would
silently shift every pyramid shape. Every size computation in the
framework routes through cround().
"""

from __future__ import annotations

import math


def cround(x: float) -> int:
    """round-half-away-from-zero, as C round()/MATLAB round()."""
    return int(math.floor(x + 0.5)) if x >= 0 else -int(math.floor(-x + 0.5))
