"""NumPy semantic reference for every core op.

These are slow, loop-level NumPy implementations that pin down the exact
numerical semantics of the reference detector's kernels:

- area-averaging image resize        (ref: matlab/mex/resize.cc)
- 5-tap binomial half-size reduce    (ref: matlab/mex/reduce.cc)
- 32-channel Felzenszwalb HOG        (ref: matlab/mex/features.cc,
                                          src/HOGFeatures.cpp:167-341)
- generalized quadratic distance transform with lower-envelope scan,
  including the shifted/subsampled output grid ("shiftdt" superset)
                                     (ref: matlab/mex/shiftdt.cc,
                                          include/DistanceTransform.hpp)
- multi-channel valid correlation    (ref: matlab/mex/fconv.cc)

They serve three purposes: golden values for unit tests of the TPU ops,
a CPU fallback path, and executable documentation. The TPU ops in the
sibling modules are *re-designs* (matmul resampling, conv-based
histograms, batched max-plus passes) verified against these.

All functions use planar (H, W, C) float64 layouts.

A NumPy copy of `partsbaseddetector_tpu/ops/reference.py`,
kept verbatim so that the port never imports the JAX package.
"""

from __future__ import annotations

import numpy as np

from ..utils.rounding import cround

# ---------------------------------------------------------------------------
# Pyramid resampling
# ---------------------------------------------------------------------------


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


def resize(im: np.ndarray, scale: float) -> np.ndarray:
    """Anti-aliased area resize of an (H, W, C) image by scale <= 1."""
    h, w = im.shape[:2]
    dh, dw = cround(h * scale), cround(w * scale)
    wh = resize_weights(h, dh)
    ww = resize_weights(w, dw)
    return np.einsum("ij,jkc,lk->ilc", wh, im.astype(np.float64), ww)


def reduce(im: np.ndarray) -> np.ndarray:
    """Half-size binomial pyramid reduce of an (H, W, C) image."""
    h, w = im.shape[:2]
    wh = reduce_weights(h)
    ww = reduce_weights(w)
    return np.einsum("ij,jkc,lk->ilc", wh, im.astype(np.float64), ww)


# ---------------------------------------------------------------------------
# HOG features
# ---------------------------------------------------------------------------

# 9 orientation half-circle unit vectors (ref: matlab/mex/features.cc:8-25)
HOG_UU = np.array(
    [1.0000, 0.9397, 0.7660, 0.5000, 0.1736, -0.1736, -0.5000, -0.7660, -0.9397]
)
HOG_VV = np.array(
    [0.0000, 0.3420, 0.6428, 0.8660, 0.9848, 0.9848, 0.8660, 0.6428, 0.3420]
)
HOG_EPS = 0.0001
HOG_NCHAN = 32  # 18 sensitive + 9 insensitive + 4 texture + 1 occlusion


def hog(im: np.ndarray, sbin: int) -> np.ndarray:
    """32-channel HOG of an (H, W, 3) image; returns (bh-2, bw-2, 32).

    Loop-level port of the semantics of matlab/mex/features.cc (which is
    the twin of src/HOGFeatures.cpp:167-341): strongest-channel central
    gradient, 18-way orientation snapping with interleaved dot/-dot
    first-max tie-breaking, trilinear cell binning, 4-neighborhood
    block-energy normalization with 0.2 clamping, 0.2357-weighted texture
    channels and a zero occlusion channel.
    """
    im = im.astype(np.float64)
    h, w = im.shape[:2]
    bh = cround(h / sbin)
    bw = cround(w / sbin)
    oh, ow = max(bh - 2, 0), max(bw - 2, 0)
    vh, vw = bh * sbin, bw * sbin

    hist = np.zeros((bh, bw, 18))
    for y in range(1, vh - 1):
        for x in range(1, vw - 1):
            yc = min(y, h - 2)
            xc = min(x, w - 2)
            dys = im[yc + 1, xc, :] - im[yc - 1, xc, :]
            dxs = im[yc, xc + 1, :] - im[yc, xc - 1, :]
            vs = dxs * dxs + dys * dys
            # channel with the strongest gradient; ties keep the lowest
            # channel index (strict > comparisons in the reference)
            ci = 0
            for c in (1, 2):
                if vs[c] > vs[ci]:
                    ci = c
            dx, dy, v = dxs[ci], dys[ci], vs[ci]

            best_dot, best_o = 0.0, 0
            for o in range(9):
                dot = HOG_UU[o] * dx + HOG_VV[o] * dy
                if dot > best_dot:
                    best_dot, best_o = dot, o
                elif -dot > best_dot:
                    best_dot, best_o = -dot, o + 9

            xp = (x + 0.5) / sbin - 0.5
            yp = (y + 0.5) / sbin - 0.5
            ixp, iyp = int(np.floor(xp)), int(np.floor(yp))
            vx0, vy0 = xp - ixp, yp - iyp
            vx1, vy1 = 1.0 - vx0, 1.0 - vy0
            v = np.sqrt(v)
            if ixp >= 0 and iyp >= 0:
                hist[iyp, ixp, best_o] += vx1 * vy1 * v
            if ixp + 1 < bw and iyp >= 0:
                hist[iyp, ixp + 1, best_o] += vx0 * vy1 * v
            if ixp >= 0 and iyp + 1 < bh:
                hist[iyp + 1, ixp, best_o] += vx1 * vy0 * v
            if ixp + 1 < bw and iyp + 1 < bh:
                hist[iyp + 1, ixp + 1, best_o] += vx0 * vy0 * v

    # block energy
    norm = ((hist[:, :, :9] + hist[:, :, 9:18]) ** 2).sum(axis=2)

    feat = np.zeros((oh, ow, HOG_NCHAN))
    for y in range(oh):
        for x in range(ow):
            n1 = 1.0 / np.sqrt(
                norm[y + 1 : y + 3, x + 1 : x + 3].sum() + HOG_EPS
            )
            n2 = 1.0 / np.sqrt(norm[y : y + 2, x + 1 : x + 3].sum() + HOG_EPS)
            n3 = 1.0 / np.sqrt(norm[y + 1 : y + 3, x : x + 2].sum() + HOG_EPS)
            n4 = 1.0 / np.sqrt(norm[y : y + 2, x : x + 2].sum() + HOG_EPS)
            src = hist[y + 1, x + 1]
            t1 = t2 = t3 = t4 = 0.0
            for o in range(18):
                h1 = min(src[o] * n1, 0.2)
                h2 = min(src[o] * n2, 0.2)
                h3 = min(src[o] * n3, 0.2)
                h4 = min(src[o] * n4, 0.2)
                feat[y, x, o] = 0.5 * (h1 + h2 + h3 + h4)
                t1, t2, t3, t4 = t1 + h1, t2 + h2, t3 + h3, t4 + h4
            for o in range(9):
                s = src[o] + src[o + 9]
                feat[y, x, 18 + o] = 0.5 * (
                    min(s * n1, 0.2)
                    + min(s * n2, 0.2)
                    + min(s * n3, 0.2)
                    + min(s * n4, 0.2)
                )
            feat[y, x, 27] = 0.2357 * t1
            feat[y, x, 28] = 0.2357 * t2
            feat[y, x, 29] = 0.2357 * t3
            feat[y, x, 30] = 0.2357 * t4
            # channel 31 (occlusion) stays zero
    return feat


# ---------------------------------------------------------------------------
# Generalized distance transform (max-plus, quadratic penalty)
# ---------------------------------------------------------------------------


def dt1d_envelope(
    src: np.ndarray,
    a: float,
    b: float,
    shift: int = 0,
    dlen: int | None = None,
    dstep: int = 1,
):
    """Sequential lower-envelope scan for one row, shiftdt-style.

    Computes dst[i] = a*(q-v)^2 + b*(q-v) + src[v] maximized over v for
    q = shift + i*dstep, where (a, b) is the *negated* deformation cost
    (a < 0 so the parabolas open downward and the scan tracks the upper
    envelope). Returns (dst, argmax v per output).

    This is the exact sequential algorithm of matlab/mex/shiftdt.cc:17-51
    (and include/DistanceTransform.hpp:152-182 for shift-only grids),
    kept as the tie-breaking authority for the parallel TPU version.
    """
    n = len(src)
    if dlen is None:
        dlen = n
    v = np.zeros(n, dtype=np.int64)
    z = np.full(n + 1, np.inf)
    z[0] = -np.inf
    k = 0
    for q in range(1, n):
        s = ((src[q] - src[v[k]]) - b * (q - v[k]) + a * (q * q - v[k] * v[k])) / (
            2 * a * (q - v[k])
        )
        while s <= z[k] and k > 0:
            k -= 1
            s = (
                (src[q] - src[v[k]]) - b * (q - v[k]) + a * (q * q - v[k] * v[k])
            ) / (2 * a * (q - v[k]))
        k += 1
        v[k] = q
        z[k] = s
        z[k + 1] = np.inf

    dst = np.zeros(dlen)
    ptr = np.zeros(dlen, dtype=np.int64)
    k = 0
    q = float(shift)
    for i in range(dlen):
        while z[k + 1] < q:
            k += 1
        d = q - v[k]
        dst[i] = a * d * d + b * d + src[v[k]]
        ptr[i] = v[k]
        q += dstep
    return dst, ptr


def shift_dt_2d(
    score: np.ndarray,
    w: np.ndarray,
    shift_x: int,
    shift_y: int,
    dlen_x: int,
    dlen_y: int,
    step: int = 1,
):
    """2-D shifted/subsampled generalized DT (max-plus), MATLAB composition.

    score: (H, W); w = [wx2, wx1, wy2, wy1] deformation weights as stored
    in the model (positive costs); internally negated. Output grid:
    q_x = shift_x + i*step (i < dlen_x), same for y. Pass order is y then
    x, pointer composition Iy = tmpIy[Ix] — the authoritative semantics
    of matlab/mex/shiftdt.cc:95-108 / detect_fast.m's passmsg. shift_*
    are 0-based here (the MEX subtracts 1 from its 1-based inputs).

    Returns (msg (dlen_y, dlen_x), Ix, Iy) with 0-based argmax indices.
    """
    h, wd = score.shape
    ax, bx, ay, by = -w[0], -w[1], -w[2], -w[3]
    tmp = np.zeros((dlen_y, wd))
    tmp_iy = np.zeros((dlen_y, wd), dtype=np.int64)
    for x in range(wd):
        tmp[:, x], tmp_iy[:, x] = dt1d_envelope(
            score[:, x], ay, by, shift_y, dlen_y, step
        )
    msg = np.zeros((dlen_y, dlen_x))
    ix = np.zeros((dlen_y, dlen_x), dtype=np.int64)
    for y in range(dlen_y):
        msg[y, :], ix[y, :] = dt1d_envelope(tmp[y, :], ax, bx, shift_x, dlen_x, step)
    iy = np.take_along_axis(tmp_iy, ix, axis=1)
    return msg, ix, iy


def dt_argmax_bruteforce(
    src: np.ndarray,
    a: float,
    b: float,
    shift: int = 0,
    dlen: int | None = None,
    dstep: int = 1,
):
    """O(N^2) direct evaluation of the same 1-D transform, first-max wins."""
    n = len(src)
    if dlen is None:
        dlen = n
    q = shift + dstep * np.arange(dlen)[:, None]
    v = np.arange(n)[None, :]
    d = q - v
    vals = a * d * d + b * d + src[None, :]
    ptr = np.argmax(vals, axis=1)
    return vals[np.arange(dlen), ptr], ptr


# ---------------------------------------------------------------------------
# Multi-channel valid correlation
# ---------------------------------------------------------------------------


def fconv_valid(feat: np.ndarray, filt: np.ndarray) -> np.ndarray:
    """Valid-size correlation of (H, W, C) feature with (fh, fw, C) filter.

    out[y, x] = sum_{i,j,c} feat[y+i, x+j, c] * filt[i, j, c]
    (ref: matlab/mex/fconv.cc).
    """
    h, w, c = feat.shape
    fh, fw, fc = filt.shape
    assert c == fc
    oh, ow = h - fh + 1, w - fw + 1
    out = np.zeros((oh, ow))
    for i in range(fh):
        for j in range(fw):
            patch = feat[i : i + oh, j : j + ow, :]
            out += patch @ filt[i, j, :]
    return out
