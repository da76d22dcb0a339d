"""Candidate visualization (ref: src/Visualize.cpp).

Draws per-part boxes in HSV-spread colors plus the root confidence as
text. Pure NumPy rasterization (no OpenCV dependency); returns the
annotated image so app layers decide how to display or save it.

A copy of `partsbaseddetector_tpu/visualize.py`, so that the port
never imports the JAX package. PIL and matplotlib are imported only
when `Visualize.image` saves or shows an image.
"""

from __future__ import annotations

import colorsys
from typing import Optional, Sequence

import numpy as np

from .types import Candidate

# 3x5 bitmap digits for confidence text ('0'-'9', '.', '-')
_GLYPHS = {
    "0": ["111", "101", "101", "101", "111"],
    "1": ["010", "110", "010", "010", "111"],
    "2": ["111", "001", "111", "100", "111"],
    "3": ["111", "001", "111", "001", "111"],
    "4": ["101", "101", "111", "001", "001"],
    "5": ["111", "100", "111", "001", "111"],
    "6": ["111", "100", "111", "101", "111"],
    "7": ["111", "001", "010", "010", "010"],
    "8": ["111", "101", "111", "101", "111"],
    "9": ["111", "101", "111", "001", "111"],
    ".": ["000", "000", "000", "000", "010"],
    "-": ["000", "000", "111", "000", "000"],
}


def part_colors(nparts: int) -> np.ndarray:
    """HSV hue sweep -> (P, 3) uint8 RGB, one color per part
    (ref: Visualize.cpp:54-66 spreads hue over 0..255)."""
    cols = []
    for p in range(nparts):
        h = p / max(nparts, 1)
        r, g, b = colorsys.hsv_to_rgb(h, 1.0, 1.0)
        cols.append((int(r * 255), int(g * 255), int(b * 255)))
    return np.asarray(cols, dtype=np.uint8)


def _draw_rect(im: np.ndarray, box, color, thickness: int = 2) -> None:
    h, w = im.shape[:2]
    x1, y1, x2, y2 = [int(round(v)) for v in box]
    x1c, x2c = max(x1, 0), min(x2 + 1, w)
    y1c, y2c = max(y1, 0), min(y2 + 1, h)
    if x2c <= x1c or y2c <= y1c:
        return
    t = thickness
    im[y1c : min(y1c + t, y2c), x1c:x2c] = color
    im[max(y2c - t, y1c) : y2c, x1c:x2c] = color
    im[y1c:y2c, x1c : min(x1c + t, x2c)] = color
    im[y1c:y2c, max(x2c - t, x1c) : x2c] = color


def _draw_text(im: np.ndarray, text: str, x: int, y: int, color, scale: int = 2):
    h, w = im.shape[:2]
    cx = x
    for ch in text:
        g = _GLYPHS.get(ch)
        if g is None:
            cx += 4 * scale
            continue
        for gy, row in enumerate(g):
            for gx, bit in enumerate(row):
                if bit == "1":
                    yy, xx = y + gy * scale, cx + gx * scale
                    if 0 <= yy < h - scale and 0 <= xx < w - scale:
                        im[yy : yy + scale, xx : xx + scale] = color
        cx += 4 * scale


class Visualize:
    """Mirror of the reference Visualize class (src/Visualize.cpp)."""

    def __init__(self, name: str = ""):
        self.name = name

    def candidates(
        self,
        im: np.ndarray,
        candidates: Sequence[Candidate],
        n: Optional[int] = None,
        with_confidence: bool = True,
    ) -> np.ndarray:
        """Render the top-n candidates; returns an (H, W, 3) uint8 copy."""
        canvas = np.ascontiguousarray(im).astype(np.uint8).copy()
        if canvas.ndim == 2:
            canvas = np.stack([canvas] * 3, axis=-1)
        take = candidates if n is None else candidates[: int(n)]
        for cand in take:
            cols = part_colors(len(cand.parts))
            for p, box in enumerate(cand.parts):
                _draw_rect(canvas, box, cols[p])
            if with_confidence and len(cand.parts):
                x1, y1 = cand.parts[0][0], cand.parts[0][1]
                _draw_text(
                    canvas,
                    f"{cand.score:.2f}",
                    int(max(x1, 0)),
                    int(max(y1 - 12, 0)),
                    np.array([255, 255, 255], dtype=np.uint8),
                )
        return canvas

    def candidate(self, im: np.ndarray, candidate: Candidate) -> np.ndarray:
        return self.candidates(im, [candidate])

    def image(self, im: np.ndarray, path: Optional[str] = None) -> None:
        """Show or save the image (headless environments save)."""
        if path is not None:
            from PIL import Image

            Image.fromarray(np.asarray(im, dtype=np.uint8)).save(path)
            return
        try:  # pragma: no cover - interactive only
            import matplotlib.pyplot as plt

            plt.imshow(im)
            plt.title(self.name)
            plt.show()
        except Exception:
            pass
