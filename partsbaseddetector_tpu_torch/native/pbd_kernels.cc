// pbd_kernels: native host-side kernels for partsbaseddetector_tpu.
//
// The TPU compute path is JAX/XLA/Pallas; this library is the native
// runtime counterpart: an exact, fast CPU implementation of the hot
// kernels (HOG features, generalized distance transform with the
// shifted/subsampled grid, area resampling, binomial reduce,
// multi-channel valid correlation, greedy NMS). It serves as
//   - the CPU fallback/serving path (no accelerator required),
//   - an independent golden implementation for cross-checking the
//     TPU kernels in tests,
//   - the data-loader/preprocessing stage for training pipelines.
//
// Layout conventions: row-major, planar-last (H, W, C) float arrays —
// deliberately different from both the reference's OpenCV interleaved
// 2-D mats and MATLAB's column-major storage; these kernels were
// written fresh against the semantics documented in
// partsbaseddetector_tpu/ops/reference.py.
//
// All entry points use a plain C ABI for ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// Area-averaging resize (exact resize.cc weights) and binomial reduce
// ---------------------------------------------------------------------------

// Resample one axis: build the head/interior/tail weights per output
// index and accumulate. src (n_outer, src_len, n_inner) -> dst
// (n_outer, dst_len, n_inner); axis is the middle dimension.
static void resample_axis(const float* src, float* dst, int64_t n_outer,
                          int64_t src_len, int64_t dst_len, int64_t n_inner) {
  const double scale = (double)dst_len / (double)src_len;
  const double inv = (double)src_len / (double)dst_len;
  std::memset(dst, 0, sizeof(float) * n_outer * dst_len * n_inner);
#pragma omp parallel for
  for (int64_t o = 0; o < n_outer; ++o) {
    const float* s = src + o * src_len * n_inner;
    float* d = dst + o * dst_len * n_inner;
    for (int64_t i = 0; i < dst_len; ++i) {
      const double f1 = i * inv;
      const double f2 = f1 + inv;
      const int64_t s1 = (int64_t)std::ceil(f1);
      const int64_t s2 = (int64_t)std::floor(f2);
      float* drow = d + i * n_inner;
      if (s1 - f1 > 1e-3 && s1 >= 1) {
        const double w = (s1 - f1) * scale;
        const float* srow = s + (s1 - 1) * n_inner;
        for (int64_t c = 0; c < n_inner; ++c) drow[c] += (float)(w * srow[c]);
      }
      for (int64_t j = s1; j < s2; ++j) {
        const float* srow = s + j * n_inner;
        for (int64_t c = 0; c < n_inner; ++c)
          drow[c] += (float)(scale * srow[c]);
      }
      if (f2 - s2 > 1e-3 && s2 < src_len) {
        const double w = (f2 - s2) * scale;
        const float* srow = s + s2 * n_inner;
        for (int64_t c = 0; c < n_inner; ++c) drow[c] += (float)(w * srow[c]);
      }
    }
  }
}

// im (h, w, c) -> out (round(h*sc), round(w*sc), c); tmp caller-sized.
void pbd_resize(const float* im, int64_t h, int64_t w, int64_t c,
                double scale_factor, float* out, float* tmp) {
  const int64_t dh = (int64_t)std::llround(h * scale_factor);
  const int64_t dw = (int64_t)std::llround(w * scale_factor);
  // rows first: treat as (1, h, w*c)
  resample_axis(im, tmp, 1, h, dh, w * c);
  // cols: outer = dh, axis = w, inner = c
  resample_axis(tmp, out, dh, w, dw, c);
}

static void reduce_axis(const float* src, float* dst, int64_t n_outer,
                        int64_t src_len, int64_t n_inner) {
  const int64_t dst_len = (int64_t)std::llround(src_len * 0.5);
#pragma omp parallel for
  for (int64_t o = 0; o < n_outer; ++o) {
    const float* s = src + o * src_len * n_inner;
    float* d = dst + o * dst_len * n_inner;
    auto row = [&](int64_t j) { return s + j * n_inner; };
    for (int64_t i = 0; i < dst_len; ++i) {
      float* drow = d + i * n_inner;
      const float* r0;
      double w0, w1, w2, w3, w4;
      int64_t j0;
      if (i == 0) {
        j0 = 0; w0 = .6875; w1 = .25; w2 = .0625; w3 = w4 = 0;
      } else if (i == dst_len - 1 && dst_len >= 2) {
        j0 = 2 * i - 2; w0 = .0625; w1 = .25; w2 = .6875; w3 = w4 = 0;
      } else if (i == dst_len - 2 && dst_len >= 3 && dst_len * 2 > src_len) {
        j0 = 2 * i - 2; w0 = .0625; w1 = .25; w2 = .375; w3 = .3125; w4 = 0;
      } else {
        j0 = 2 * i - 2; w0 = .0625; w1 = .25; w2 = .375; w3 = .25; w4 = .0625;
      }
      for (int64_t cix = 0; cix < n_inner; ++cix) {
        double acc = w0 * row(j0)[cix];
        if (w1 != 0) acc += w1 * row(j0 + 1)[cix];
        if (w2 != 0) acc += w2 * row(j0 + 2)[cix];
        if (w3 != 0) acc += w3 * row(j0 + 3)[cix];
        if (w4 != 0) acc += w4 * row(j0 + 4)[cix];
        drow[cix] = (float)acc;
      }
    }
  }
}

void pbd_reduce(const float* im, int64_t h, int64_t w, int64_t c, float* out,
                float* tmp) {
  const int64_t dh = (int64_t)std::llround(h * 0.5);
  reduce_axis(im, tmp, 1, h, w * c);
  reduce_axis(tmp, out, dh, w, c);
}

// ---------------------------------------------------------------------------
// 32-channel HOG (semantics of ops/reference.py::hog)
// ---------------------------------------------------------------------------

void pbd_hog(const float* im, int64_t h, int64_t w, int64_t sbin, float* out) {
  static const double kU[9] = {1.0000, 0.9397, 0.7660,  0.5000, 0.1736,
                               -0.1736, -0.5000, -0.7660, -0.9397};
  static const double kV[9] = {0.0000, 0.3420, 0.6428, 0.8660, 0.9848,
                               0.9848, 0.8660, 0.6428, 0.3420};
  const int64_t bh = (int64_t)std::llround((double)h / sbin);
  const int64_t bw = (int64_t)std::llround((double)w / sbin);
  const int64_t oh = std::max<int64_t>(bh - 2, 0);
  const int64_t ow = std::max<int64_t>(bw - 2, 0);
  const int64_t vh = bh * sbin, vw = bw * sbin;

  std::vector<double> hist((size_t)bh * bw * 18, 0.0);
  std::vector<double> norm((size_t)bh * bw, 0.0);
  auto px = [&](int64_t y, int64_t x, int64_t ch) {
    return (double)im[(y * w + x) * 3 + ch];
  };

  for (int64_t y = 1; y < vh - 1; ++y) {
    const int64_t yc = std::min(y, h - 2);
    for (int64_t x = 1; x < vw - 1; ++x) {
      const int64_t xc = std::min(x, w - 2);
      double bdx = 0, bdy = 0, bv = -1;
      for (int ch = 0; ch < 3; ++ch) {
        const double dy = px(yc + 1, xc, ch) - px(yc - 1, xc, ch);
        const double dx = px(yc, xc + 1, ch) - px(yc, xc - 1, ch);
        const double v = dx * dx + dy * dy;
        if (v > bv) { bv = v; bdx = dx; bdy = dy; }
      }
      double best_dot = 0;
      int best_o = 0;
      for (int o = 0; o < 9; ++o) {
        const double dot = kU[o] * bdx + kV[o] * bdy;
        if (dot > best_dot) { best_dot = dot; best_o = o; }
        else if (-dot > best_dot) { best_dot = -dot; best_o = o + 9; }
      }
      const double xp = (x + 0.5) / sbin - 0.5;
      const double yp = (y + 0.5) / sbin - 0.5;
      const int64_t ixp = (int64_t)std::floor(xp);
      const int64_t iyp = (int64_t)std::floor(yp);
      const double vx0 = xp - ixp, vy0 = yp - iyp;
      const double vx1 = 1 - vx0, vy1 = 1 - vy0;
      const double mag = std::sqrt(bv);
      auto add = [&](int64_t cy, int64_t cx, double wgt) {
        if (cy >= 0 && cy < bh && cx >= 0 && cx < bw)
          hist[(cy * bw + cx) * 18 + best_o] += wgt * mag;
      };
      add(iyp, ixp, vx1 * vy1);
      if (ixp + 1 < bw) add(iyp, ixp + 1, vx0 * vy1);
      if (iyp + 1 < bh) add(iyp + 1, ixp, vx1 * vy0);
      if (ixp + 1 < bw && iyp + 1 < bh) add(iyp + 1, ixp + 1, vx0 * vy0);
    }
  }
  // note: the scatter guards above follow the reference exactly — a
  // contribution to cell (iyp, ixp) requires iyp >= 0 && ixp >= 0 etc.
  for (int64_t i = 0; i < bh * bw; ++i) {
    double e = 0;
    for (int o = 0; o < 9; ++o) {
      const double s = hist[i * 18 + o] + hist[i * 18 + o + 9];
      e += s * s;
    }
    norm[i] = e;
  }

#pragma omp parallel for
  for (int64_t y = 0; y < oh; ++y) {
    for (int64_t x = 0; x < ow; ++x) {
      auto blk = [&](int64_t by, int64_t bx) {
        return norm[by * bw + bx] + norm[by * bw + bx + 1] +
               norm[(by + 1) * bw + bx] + norm[(by + 1) * bw + bx + 1];
      };
      const double n1 = 1.0 / std::sqrt(blk(y + 1, x + 1) + 1e-4);
      const double n2 = 1.0 / std::sqrt(blk(y, x + 1) + 1e-4);
      const double n3 = 1.0 / std::sqrt(blk(y + 1, x) + 1e-4);
      const double n4 = 1.0 / std::sqrt(blk(y, x) + 1e-4);
      const double* src = &hist[((y + 1) * bw + (x + 1)) * 18];
      float* dst = out + (y * ow + x) * 32;
      double t1 = 0, t2 = 0, t3 = 0, t4 = 0;
      for (int o = 0; o < 18; ++o) {
        const double h1 = std::min(src[o] * n1, 0.2);
        const double h2 = std::min(src[o] * n2, 0.2);
        const double h3 = std::min(src[o] * n3, 0.2);
        const double h4 = std::min(src[o] * n4, 0.2);
        dst[o] = (float)(0.5 * (h1 + h2 + h3 + h4));
        t1 += h1; t2 += h2; t3 += h3; t4 += h4;
      }
      for (int o = 0; o < 9; ++o) {
        const double s = src[o] + src[o + 9];
        dst[18 + o] = (float)(0.5 * (std::min(s * n1, 0.2) + std::min(s * n2, 0.2) +
                                     std::min(s * n3, 0.2) + std::min(s * n4, 0.2)));
      }
      dst[27] = (float)(0.2357 * t1);
      dst[28] = (float)(0.2357 * t2);
      dst[29] = (float)(0.2357 * t3);
      dst[30] = (float)(0.2357 * t4);
      dst[31] = 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// Generalized distance transform (lower-envelope scan, shiftdt grid)
// ---------------------------------------------------------------------------

static void dt_row(const double* src, int64_t stride, int64_t len, double a,
                   double b, int64_t shift, int64_t dlen, int64_t dstep,
                   double* dst, int32_t* ptr, int64_t dst_stride,
                   int64_t* vbuf, double* zbuf) {
  int64_t k = 0;
  vbuf[0] = 0;
  zbuf[0] = -std::numeric_limits<double>::infinity();
  zbuf[1] = std::numeric_limits<double>::infinity();
  for (int64_t q = 1; q < len; ++q) {
    const double sq = src[q * stride];
    double s;
    for (;;) {
      const int64_t vk = vbuf[k];
      s = ((sq - src[vk * stride]) - b * (q - vk) + a * (q * q - vk * vk)) /
          (2 * a * (q - vk));
      if (s <= zbuf[k] && k > 0) { --k; continue; }
      break;
    }
    ++k;
    vbuf[k] = q;
    zbuf[k] = s;
    zbuf[k + 1] = std::numeric_limits<double>::infinity();
  }
  k = 0;
  double q = (double)shift;
  for (int64_t i = 0; i < dlen; ++i) {
    while (zbuf[k + 1] < q) ++k;
    const double d = q - vbuf[k];
    dst[i * dst_stride] = (a * d + b) * d + src[vbuf[k] * stride];
    ptr[i * dst_stride] = (int32_t)vbuf[k];
    q += dstep;
  }
}

// 2-D shifted DT, y pass then x pass (MATLAB pointer composition).
// score (h, w) float64 -> msg (dlen_y, dlen_x), ix, iy int32.
void pbd_shiftdt(const double* score, int64_t h, int64_t w, double wx2,
                 double wx1, double wy2, double wy1, int64_t shift_x,
                 int64_t shift_y, int64_t dlen_x, int64_t dlen_y,
                 int64_t step, double* msg, int32_t* ix, int32_t* iy) {
  const double ax = -wx2, bx = -wx1, ay = -wy2, by = -wy1;
  std::vector<double> tmp((size_t)dlen_y * w);
  std::vector<int32_t> tmp_iy((size_t)dlen_y * w);
#pragma omp parallel
  {
    std::vector<int64_t> vbuf(std::max(h, w));
    std::vector<double> zbuf(std::max(h, w) + 1);
#pragma omp for
    for (int64_t x = 0; x < w; ++x) {
      dt_row(score + x, w, h, ay, by, shift_y, dlen_y, step, tmp.data() + x,
             tmp_iy.data() + x, w, vbuf.data(), zbuf.data());
    }
#pragma omp for
    for (int64_t y = 0; y < dlen_y; ++y) {
      dt_row(tmp.data() + y * w, 1, w, ax, bx, shift_x, dlen_x, step,
             msg + y * dlen_x, ix + y * dlen_x, 1, vbuf.data(), zbuf.data());
    }
  }
#pragma omp parallel for
  for (int64_t y = 0; y < dlen_y; ++y)
    for (int64_t x = 0; x < dlen_x; ++x)
      iy[y * dlen_x + x] = tmp_iy[(size_t)y * w + ix[y * dlen_x + x]];
}

// Batched 2-D shifted DT over K mixture maps of one part: scores
// (K, h, w) contiguous; per-mixture deformation (K, 4) [wx2 wx1 wy2
// wy1], shifts (K, 2) [sx sy]; one shared step. Outputs (K, dy, dx).
// Replaces K Python-driven pbd_shiftdt calls in the serving loop.
void pbd_shiftdt_batch(const double* scores, int64_t K, int64_t h, int64_t w,
                       const double* defs, const int64_t* shifts,
                       int64_t dlen_x, int64_t dlen_y, int64_t step,
                       double* msg, int32_t* ix, int32_t* iy) {
  for (int64_t k = 0; k < K; ++k) {
    pbd_shiftdt(scores + (size_t)k * h * w, h, w, defs[k * 4 + 0],
                defs[k * 4 + 1], defs[k * 4 + 2], defs[k * 4 + 3],
                shifts[k * 2 + 0], shifts[k * 2 + 1], dlen_x, dlen_y, step,
                msg + (size_t)k * dlen_y * dlen_x,
                ix + (size_t)k * dlen_y * dlen_x,
                iy + (size_t)k * dlen_y * dlen_x);
  }
}

// Mixture combine (passmsg, detect_fast.m:118-141): per parent mixture
// l, msg[l] = max_k (dt[k] + bias[l, k]) with first-max argmax; gathers
// the winning (ix, iy) and records ik. dt/ix/iy (K, n); bias (L, K);
// outputs (L, n).
void pbd_mixture_combine(const double* dt, const int32_t* ix,
                         const int32_t* iy, int64_t K, int64_t n,
                         const double* bias, int64_t L, double* msg,
                         int32_t* oix, int32_t* oiy, int32_t* oik) {
#pragma omp parallel for
  for (int64_t l = 0; l < L; ++l) {
    const double* bl = bias + l * K;
    double* ml = msg + (size_t)l * n;
    int32_t* xl = oix + (size_t)l * n;
    int32_t* yl = oiy + (size_t)l * n;
    int32_t* kl = oik + (size_t)l * n;
    for (int64_t i = 0; i < n; ++i) {
      double best = dt[i] + bl[0];
      int64_t bk = 0;
      for (int64_t k = 1; k < K; ++k) {
        const double v = dt[(size_t)k * n + i] + bl[k];
        if (v > best) {
          best = v;
          bk = k;
        }
      }
      ml[i] = best;
      xl[i] = ix[(size_t)bk * n + i];
      yl[i] = iy[(size_t)bk * n + i];
      kl[i] = (int32_t)bk;
    }
  }
}

// ---------------------------------------------------------------------------
// Multi-channel valid correlation: feat (h, w, c) x filt (fh, fw, c)
// ---------------------------------------------------------------------------

void pbd_fconv_valid(const float* feat, int64_t h, int64_t w, int64_t c,
                     const float* filt, int64_t fh, int64_t fw, float* out) {
  const int64_t oh = h - fh + 1, ow = w - fw + 1;
#pragma omp parallel for
  for (int64_t y = 0; y < oh; ++y) {
    for (int64_t x = 0; x < ow; ++x) {
      double acc = 0;
      for (int64_t i = 0; i < fh; ++i) {
        const float* frow = feat + ((y + i) * w + x) * c;
        const float* krow = filt + i * fw * c;
        for (int64_t jc = 0; jc < fw * c; ++jc) acc += (double)frow[jc] * krow[jc];
      }
      out[y * ow + x] = (float)acc;
    }
  }
}

// ---------------------------------------------------------------------------
// Bank correlation: ONE feature map x MANY same-size filters.
//
// The serving-path hot loop (the reference parallelizes convolutions
// across filters with OpenMP, src/SpatialConvolutionEngine.cpp:106-124;
// its MEX twins use pthreads/BLAS, matlab/mex/fconvMT.cc/fconvblas.cc).
// Here the whole bank runs as im2row + a blocked SGEMM so the patch
// extraction is amortized over all filters and the inner loop is a
// contiguous SIMD dot product:
//   patches (oh*ow, K=fh*fw*c) row-major; bank (nf, K); out (nf, oh, ow).
// ---------------------------------------------------------------------------

void pbd_fconv_bank(const float* feat, int64_t h, int64_t w, int64_t c,
                    const float* bank, int64_t nf, int64_t fh, int64_t fw,
                    float* out) {
  const int64_t oh = h - fh + 1, ow = w - fw + 1;
  if (oh <= 0 || ow <= 0 || nf <= 0) return;
  const int64_t K = fh * fw * c;
  const int64_t npix = oh * ow;
  // im2row scratch: each output pixel's receptive field, contiguous.
  std::vector<float> patches((size_t)npix * K);
#ifdef _OPENMP
#pragma omp parallel for
#endif
  for (int64_t y = 0; y < oh; ++y) {
    for (int64_t x = 0; x < ow; ++x) {
      float* dst = patches.data() + ((size_t)(y * ow + x)) * K;
      for (int64_t i = 0; i < fh; ++i) {
        const float* srow = feat + ((y + i) * w + x) * c;
        std::memcpy(dst + i * fw * c, srow, sizeof(float) * fw * c);
      }
    }
  }
  // (nf, K) @ (K, npix)^T — register-friendly: 4 filters per pass share
  // each patch row (the bandwidth-heavy operand streams once per group).
#ifdef _OPENMP
#pragma omp parallel for
#endif
  for (int64_t f0 = 0; f0 < nf; f0 += 4) {
    const int64_t fn = std::min<int64_t>(4, nf - f0);
    const float* b0 = bank + (f0 + 0) * K;
    const float* b1 = bank + (f0 + (fn > 1 ? 1 : 0)) * K;
    const float* b2 = bank + (f0 + (fn > 2 ? 2 : 0)) * K;
    const float* b3 = bank + (f0 + (fn > 3 ? 3 : 0)) * K;
    for (int64_t p = 0; p < npix; ++p) {
      const float* row = patches.data() + (size_t)p * K;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#ifdef _OPENMP
#pragma omp simd reduction(+ : a0, a1, a2, a3)
#endif
      for (int64_t k = 0; k < K; ++k) {
        const float r = row[k];
        a0 += r * b0[k];
        a1 += r * b1[k];
        a2 += r * b2[k];
        a3 += r * b3[k];
      }
      out[(f0 + 0) * npix + p] = a0;
      if (fn > 1) out[(f0 + 1) * npix + p] = a1;
      if (fn > 2) out[(f0 + 2) * npix + p] = a2;
      if (fn > 3) out[(f0 + 3) * npix + p] = a3;
    }
  }
}

// ---------------------------------------------------------------------------
// Greedy paint NMS over candidate bounding boxes
// boxes (n, 4) [x1 y1 x2 y2] sorted by descending score; keep flags out.
// ---------------------------------------------------------------------------

void pbd_paint_nms(const double* boxes, int64_t n, int64_t im_h, int64_t im_w,
                   double overlap, uint8_t* keep) {
  std::vector<uint8_t> scratch((size_t)im_h * im_w, 0);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t x1 = std::max<int64_t>((int64_t)boxes[i * 4 + 0], 0);
    const int64_t y1 = std::max<int64_t>((int64_t)boxes[i * 4 + 1], 0);
    const int64_t x2 = std::min<int64_t>((int64_t)boxes[i * 4 + 2], im_w);
    const int64_t y2 = std::min<int64_t>((int64_t)boxes[i * 4 + 3], im_h);
    keep[i] = 0;
    if (x2 <= x1 || y2 <= y1) continue;
    int64_t painted = 0;
    for (int64_t y = y1; y < y2; ++y)
      for (int64_t x = x1; x < x2; ++x) painted += scratch[y * im_w + x];
    if ((double)painted / ((x2 - x1) * (y2 - y1)) > overlap) continue;
    keep[i] = 1;
    for (int64_t y = y1; y < y2; ++y)
      for (int64_t x = x1; x < x2; ++x) scratch[y * im_w + x] = 1;
  }
}

// ---------------------------------------------------------------------------
// Batched median part depths (ref: include/Math.hpp:62-72 — nth_element
// at n/2, the UPPER middle for even counts, no averaging;
// src/SearchSpacePruning.cpp:73-95 calls it per candidate part box).
// depth (h, w) f32; boxes (n, 4) [x1 y1 x2 y2] inclusive pixel coords.
// out[i] = median of the finite depths inside the clipped box, 0 when
// the clipped box or its finite subset is empty. Clipping matches the
// Python fallback bit for bit: max/min in double, then truncation.
// ---------------------------------------------------------------------------

void pbd_box_medians(const float* depth, int64_t h, int64_t w,
                     const double* boxes, int64_t n, double* out) {
#pragma omp parallel
  {
    std::vector<float> vals;
#pragma omp for
    for (int64_t i = 0; i < n; ++i) {
      const double* b = boxes + 4 * i;
      const int64_t x1 = (int64_t)std::max(b[0], 0.0);
      const int64_t y1 = (int64_t)std::max(b[1], 0.0);
      const int64_t x2 = (int64_t)std::min(b[2] + 1.0, (double)w);
      const int64_t y2 = (int64_t)std::min(b[3] + 1.0, (double)h);
      out[i] = 0.0;
      if (x2 <= x1 || y2 <= y1) continue;
      vals.clear();
      for (int64_t y = y1; y < y2; ++y) {
        const float* row = depth + y * w;
        for (int64_t x = x1; x < x2; ++x) {
          const float v = row[x];
          if (std::isfinite(v)) vals.push_back(v);
        }
      }
      if (vals.empty()) continue;
      const size_t k = vals.size() / 2;
      std::nth_element(vals.begin(), vals.begin() + k, vals.end());
      out[i] = (double)vals[k];
    }
  }
}

int64_t pbd_version(void) { return 1; }

}  // extern "C"
