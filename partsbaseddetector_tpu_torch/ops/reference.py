"""NumPy semantic reference: the pieces the port's pyramid needs.

Copied from `partsbaseddetector_tpu/ops/reference.py`: the exact
resampling weights (resize.cc, reduce.cc) and the HOG orientation
constants (features.cc). Both packages build their matrices from the
same float64 values, so the port and the JAX package start from
identical weights.
"""

from __future__ import annotations

import numpy as np

from ..utils.rounding import cround


def resize_weights(src_len: int, dst_len: int) -> np.ndarray:
    """Area-averaging resampling weights as a dense (dst_len, src_len) matrix.

    For each output index d the source interval [d*inv, (d+1)*inv)
    (inv = src/dst) is integrated: fractional head/tail plus full interior
    samples, all scaled by dst/src. Fractions below 1e-3 are dropped, as
    in the reference (ref: matlab/mex/resize.cc:38-65).
    """
    w = np.zeros((dst_len, src_len), dtype=np.float64)
    scale = dst_len / src_len
    inv = src_len / dst_len
    for d in range(dst_len):
        f1 = d * inv
        f2 = f1 + inv
        s1 = int(np.ceil(f1))
        s2 = int(np.floor(f2))
        if s1 - f1 > 1e-3:
            w[d, s1 - 1] += (s1 - f1) * scale
        for s in range(s1, s2):
            w[d, s] += scale
        if f2 - s2 > 1e-3 and s2 < src_len:
            w[d, s2] += (f2 - s2) * scale
    return w


def reduce_weights(src_len: int) -> np.ndarray:
    """Half-size 5-tap binomial downsample weights, (dst_len, src_len).

    Interior rows use [.0625 .25 .375 .25 .0625] centered at 2*d; the
    first, second-to-last and last rows use renormalized boundary stencils
    (ref: matlab/mex/reduce.cc:22-42).
    """
    dst_len = cround(src_len * 0.5)
    w = np.zeros((dst_len, src_len), dtype=np.float64)
    # first output row reads src[0..2]
    w[0, 0:3] = [0.6875, 0.25, 0.0625]
    for d in range(1, dst_len - 2):
        w[d, 2 * d - 2 : 2 * d + 3] = [0.0625, 0.25, 0.375, 0.25, 0.0625]
    if dst_len >= 3:
        d = dst_len - 2
        if dst_len * 2 <= src_len:
            w[d, 2 * d - 2 : 2 * d + 3] = [0.0625, 0.25, 0.375, 0.25, 0.0625]
        else:
            w[d, 2 * d - 2 : 2 * d + 2] = [0.0625, 0.25, 0.375, 0.3125]
    if dst_len >= 2:
        d = dst_len - 1
        w[d, 2 * d - 2 : 2 * d + 1] = [0.0625, 0.25, 0.6875]
    return w


# 9 orientation half-circle unit vectors (ref: matlab/mex/features.cc:8-25)
HOG_UU = np.array(
    [1.0000, 0.9397, 0.7660, 0.5000, 0.1736, -0.1736, -0.5000, -0.7660, -0.9397]
)
HOG_VV = np.array(
    [0.0000, 0.3420, 0.6428, 0.8660, 0.9848, 0.9848, 0.8660, 0.6428, 0.3420]
)
HOG_EPS = 0.0001
