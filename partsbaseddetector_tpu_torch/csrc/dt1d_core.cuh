// The 1-D generalized distance transform core of K1 (csrc/dt1d.cu, with
// K3's x pass) and K5 (csrc/dt1d_window.cu), along axis -2, f32, for
// sm_90a.
//
// For map b, output row i and column w, with q = shift[b] + step*i:
//   out[b,i,w] = max_{v < nvalid[b]} (a[b]*(q-v) + b[b])*(q-v) + src[b,v,w]
//   ptr[b,i,w] = the smallest v reaching the max (strict > in ascending v);
//                with aux: (aux[b,v*,w] << 12) | v*.
// An output with no live source is -inf (the sentinel of this port and of
// its plain version dt_cuda.py::dt1d_plain) with pointer 0. The window
// form (tag dt1d_window) is exact only at the outputs i < out_valid[b, w],
// the consumer's extent; it writes (-inf, 0) beyond, as
// dt_cuda.py::dt1d_window_plain does.
//
// Rounding: every candidate that is evaluated is built from explicit
// round-to-nearest intrinsics, so nvcc cannot contract (a*d+b)*d + s into
// FMAs. The plain torch version evaluates the same expression in the same
// order, and the two agree bit for bit, argmax included at near-ties. That
// rules out the lower-envelope scan as the answer: it finds the winner in
// real arithmetic, and at a near-tie the rounded max picks another source.
//
// Bounds on the H100: the function needs each source read once and each
// output written once (bytes), but an exact answer compares rounded
// candidates, so the kernel is bound by how many candidates it evaluates and
// by the instructions each one costs (FP32 instruction rate, not memory). The
// design cuts both:
//
//   * Staged sources, register-blocked outputs. A block owns one map's tile
//     of kCols columns and a run of output rows. The tile's live source rows
//     come into shared memory once per block by cp.async (4-byte: a row pitch
//     of 4*W bytes is in general no multiple of 8 or 16), padded with -inf to
//     a whole number of chunks of kV rows. A thread owns kR consecutive output
//     rows of one column: one shared-memory load of src[v, x] feeds kR
//     candidates, best and bestv live in registers, and no candidate pays an
//     int-to-float conversion or a global load. With kCols = 16 a warp holds
//     two row groups of the same 16 columns (its shared-memory loads are
//     broadcasts in pairs), which leaves fewer lanes idle at a map's right
//     edge than 32 columns would (166 columns: 6% against 14%).
//   * Shared penalties. At step 1 with an integral shift every q - v is an
//     exact integer, so the penalty of (row i+1, source v+1) is the penalty of
//     (row i, source v) bit for bit. The thread keeps a sliding window of
//     penalties and computes one new penalty per source instead of kR: a
//     candidate then costs an add, a compare and two selects. Any other step
//     or shift (beyond 2^22 too) takes the general path (five rounded
//     operations a candidate).
//   * Exact pruning by source chunk. A prologue computes per column the
//     maximum of every chunk. Each thread first evaluates a seed window of kV
//     sources centred on its live rows, for the values only; the smallest of
//     its live rows' seed values is a threshold that every one of them has
//     reached. For a chunk [v0, v1] the displacement d of any of the thread's
//     live candidates lies in [q_first - v1, q_last_live - v0], and
//     (a*d + b)*d over an interval is at most the largest of its value at the
//     two ends and at the vertex -b/(2a) clamped into the interval (a < 0,
//     a = 0, a > 0 alike). The chunk is skipped only when
//     chunk_max + that + slack is strictly below the threshold, with a slack
//     of 1e-3 + 1e-3*(|max| + |pen|), so rounding can only keep a chunk,
//     never drop one that could win or tie. A chunk of -inf (dead maps,
//     padding) is skipped for free. A warp evaluates a chunk when any of its
//     lanes keeps it: an extra chunk costs time and cannot change a result,
//     because the scan that sets best and bestv runs in ascending v over
//     whole chunks with a strict >, the seed's sources in their place. The
//     rule is mirrored in float32 by ops/dt_cuda.py::dt1d_chunk_keep_plain
//     (out_valid= for the window form), which the CPU tests hold against the
//     brute-force winners.
//
// A thread's live rows are all its rows inside the map (K1), or (window)
// those before out_valid[b, x]. In the window form only they set the seed
// window's centre, the threshold and the displacement interval, which can
// only tighten the prune; a warp with no live row stages its share of the
// tile and passes the block's barriers but evaluates nothing, and a block
// with no live row stages nothing. Its rows at or beyond out_valid are
// written (-inf, 0).
//
// Maps of more than kPruneMaxRows source rows do not fit a block's shared
// memory at once: they stream through a tile of kStreamRows rows with the
// same scan and no pruning.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace pbd_dt {

constexpr int kCols = 16;       // columns of a block's tile
constexpr int kR = 8;           // consecutive output rows a thread owns
constexpr int kMaxGroups = 16;  // row groups (of kR rows) per block at most
static_assert(32 % kCols == 0 && kMaxGroups % (32 / kCols) == 0,
              "a block is a whole number of warps");
constexpr int kV = 16;          // source rows per chunk, and per seed window
constexpr int kPruneMaxRows = 1024;
constexpr int kStreamRows = 256;
// below this magnitude shift + i and q - v are exact integers in float32
constexpr int kExactInt = 1 << 22;

__device__ __forceinline__ void cp_async4(float* smem_dst,
                                          const float* gmem_src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem_src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float pen_rn(float a, float b, float d) {
  return __fmul_rn(__fadd_rn(__fmul_rn(a, d), b), d);
}

template <bool kArg>
__device__ __forceinline__ void take(float val, int v, float& best,
                                     int& bestv) {
  if (kArg) {
    if (val > best) {
      best = val;
      bestv = v;
    }
  } else {
    best = fmaxf(best, val);
  }
}

// kV sources from v0 on (col points at the first, rows kCols apart) against
// the thread's kR rows, any step and shift.
template <bool kArg>
__device__ __forceinline__ void eval_general(const float* col, int v0,
                                             const float (&q)[kR], float a,
                                             float b, float (&best)[kR],
                                             int (&bestv)[kR]) {
#pragma unroll 4
  for (int u = 0; u < kV; ++u) {
    const float s = col[u * kCols];
    const float vf = static_cast<float>(v0 + u);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float d = __fsub_rn(q[r], vf);
      take<kArg>(__fadd_rn(pen_rn(a, b, d), s), v0 + u, best[r], bestv[r]);
    }
  }
}

// The same at step 1 with an integral shift: candidate (row r, source v0 + u)
// has d = d0 + r - u with d0 = q[0] - v0, all exact, so its penalty is
// win[kR - 1 - r + u] with win[j] = pen(d0 + kR - 1 - j). The first kR - 1
// entries are the previous chunk's last ones when that chunk was evaluated
// (`carried`); each source adds one entry.
template <bool kArg>
__device__ __forceinline__ void eval_diag(const float* col, int v0, float q0,
                                          float a, float b,
                                          float (&win)[kV + kR - 1],
                                          bool carried, float (&best)[kR],
                                          int (&bestv)[kR]) {
  const float d0 = __fsub_rn(q0, static_cast<float>(v0));
  if (!carried) {
#pragma unroll
    for (int j = 0; j < kR - 1; ++j) {
      win[j] = pen_rn(a, b, __fadd_rn(d0, static_cast<float>(kR - 1 - j)));
    }
  }
#pragma unroll
  for (int u = 0; u < kV; ++u) {
    win[kR - 1 + u] = pen_rn(a, b, __fsub_rn(d0, static_cast<float>(u)));
    const float s = col[u * kCols];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      take<kArg>(__fadd_rn(win[kR - 1 - r + u], s), v0 + u, best[r], bestv[r]);
    }
  }
#pragma unroll
  for (int j = 0; j < kR - 1; ++j) win[j] = win[kV + j];
}

// The core's two forms, as template tags (their names tell the kernels
// apart in a profile): exact at every output (K1), or only before
// out_valid (K5).
struct dt1d_exact {
  static constexpr bool kWindow = false;
};
struct dt1d_window {
  static constexpr bool kWindow = true;
};

template <bool kHasAux, bool kPrune, class Form>
__global__ void __launch_bounds__(kCols * kMaxGroups)
dt1d_axis2_kernel(const float* __restrict__ src, const int* __restrict__ aux,
                  const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ shift,
                  const int* __restrict__ nvalid,
                  const int* __restrict__ out_valid, float* __restrict__ out,
                  int* __restrict__ ptr, int h, int w, int dlen, int step,
                  int tile_rows) {
  constexpr bool kWindow = Form::kWindow;
  extern __shared__ float smem[];
  float* tile = smem;                      // [tile_rows][kCols]
  float* cmax = smem + tile_rows * kCols;  // [tile_rows / kV][kCols], kPrune
  const int tx = threadIdx.x % kCols;
  const int g = threadIdx.x / kCols;
  const int groups = blockDim.x / kCols;
  const int x = blockIdx.x * kCols + tx;
  const int i0 = (blockIdx.y * groups + g) * kR;  // the thread's first row
  const int m = blockIdx.z;
  const int nv = min(max(nvalid[m], 0), h);
  const int nrows = min(kR, dlen - i0);  // rows of the run inside the map
  // the rows that must be exact: every row (K1), or those before out_valid
  int nlive = nrows;
  if (kWindow) {
    const int ov = x < w ? out_valid[static_cast<size_t>(m) * w + x] : 0;
    nlive = max(0, min(nrows, ov - i0));
  }
  const bool active = x < w && nlive > 0;
  const float am = a[m];
  const float bm = b[m];
  const float sh = shift[m];
  float q[kR];
  float best[kR];
  int bestv[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    q[r] = __fadd_rn(sh, static_cast<float>(step * (i0 + r)));
    best[r] = -CUDART_INF_F;
    bestv[r] = 0;
  }
  const float q_last =
      __fadd_rn(sh, static_cast<float>(step * (i0 + max(nlive, 1) - 1)));
  const bool diag = step == 1 && sh == truncf(sh) &&
                    fabsf(sh) <= static_cast<float>(kExactInt) &&
                    h <= kExactInt && dlen <= kExactInt;
  const float* srcm = src + static_cast<size_t>(m) * h * w;
  float win[kV + kR - 1];
  // the window form's skips: a block, or a warp, without a live row
  const bool block_live = kWindow ? __syncthreads_or(active) : true;
  const bool warp_live = kWindow ? __any_sync(0xffffffffu, active) : true;

  for (int s0 = 0; block_live && s0 < nv; s0 += tile_rows) {
    const int rows = min(tile_rows, nv - s0);
    const int nchunks = (rows + kV - 1) / kV;
    if (s0 > 0) __syncthreads();  // the tile is read until here
    for (int r = g; r < nchunks * kV; r += groups) {
      if (r < rows && x < w) {
        cp_async4(tile + r * kCols + tx,
                  srcm + static_cast<size_t>(s0 + r) * w + x);
      } else {
        tile[r * kCols + tx] = -CUDART_INF_F;
      }
    }
    cp_async_wait_all();
    __syncthreads();

    float thr = -CUDART_INF_F;
    float dstar = 0.0f;
    if (kPrune) {  // the whole map is resident: s0 == 0
      for (int c = g; c < nchunks; c += groups) {
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int k = 0; k < kV; ++k) {
          mx = fmaxf(mx, tile[(c * kV + k) * kCols + tx]);
        }
        cmax[c * kCols + tx] = mx;
      }
      __syncthreads();
      if (!warp_live) break;  // no barrier follows on the pruned path
      // the seed window: kV sources centred on the live rows, inside [0, nv)
      const int span = step * (max(nlive, 1) - 1);
      float vsf = __fadd_rn(floorf(q[0]), static_cast<float>((span - kV) >> 1));
      vsf = fminf(fmaxf(vsf, 0.0f), static_cast<float>(max(nv - kV, 0)));
      const int vs = static_cast<int>(vsf);
      float seed[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) seed[r] = -CUDART_INF_F;
      if (diag) {
        eval_diag<false>(tile + vs * kCols + tx, vs, q[0], am, bm, win, false,
                         seed, bestv);
      } else {
        eval_general<false>(tile + vs * kCols + tx, vs, q, am, bm, seed, bestv);
      }
      thr = CUDART_INF_F;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (r < nlive) thr = fminf(thr, seed[r]);
      }
      if (am != 0.0f) dstar = __fdiv_rn(-bm, __fmul_rn(2.0f, am));
    }
    if (!warp_live) continue;  // the streamed path: on to the next barrier
    const float q_lo = fminf(q[0], q_last);
    const float q_hi = fmaxf(q[0], q_last);

    bool carried = false;
    for (int c = 0; c < nchunks; ++c) {
      bool keep = active;
      if (kPrune) {
        const float cm = cmax[c * kCols + tx];
        const float d_lo =
            __fsub_rn(q_lo, static_cast<float>(min(c * kV + kV, nv) - 1));
        const float d_hi = __fsub_rn(q_hi, static_cast<float>(c * kV));
        float pm = fmaxf(pen_rn(am, bm, d_lo), pen_rn(am, bm, d_hi));
        if (am != 0.0f) {
          pm = fmaxf(pm, pen_rn(am, bm, fminf(fmaxf(dstar, d_lo), d_hi)));
        }
        const float slack = __fadd_rn(
            1e-3f, __fmul_rn(1e-3f, __fadd_rn(fabsf(cm), fabsf(pm))));
        keep = active && cm != -CUDART_INF_F &&
               !(__fadd_rn(__fadd_rn(cm, pm), slack) < thr);
      }
      if (!__any_sync(0xffffffffu, keep)) {
        carried = false;
        continue;
      }
      const float* col = tile + c * kV * kCols + tx;
      if (diag) {
        eval_diag<true>(col, s0 + c * kV, q[0], am, bm, win, carried, best,
                        bestv);
        carried = true;
      } else {
        eval_general<true>(col, s0 + c * kV, q, am, bm, best, bestv);
      }
    }
  }

  if (x >= w || nrows <= 0) return;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    if (r < nrows) {
      const size_t o = (static_cast<size_t>(m) * dlen + i0 + r) * w + x;
      const bool exact = r < nlive;  // always, unless kWindow
      out[o] = exact ? best[r] : -CUDART_INF_F;
      int p = bestv[r];
      if (kHasAux) {
        p = (best[r] == -CUDART_INF_F)
                ? 0
                : ((aux[(static_cast<size_t>(m) * h + bestv[r]) * w + x]
                    << 12) |
                   bestv[r]);
      }
      ptr[o] = exact ? p : 0;
    }
  }
}

template <bool kHasAux, bool kPrune, class Form>
int launch(const float* src, const int* aux, const float* a, const float* b,
           const float* shift, const int* nvalid, const int* out_valid,
           float* out, int* ptr, int batch, int h, int w, int dlen, int step,
           cudaStream_t stream) {
  const int tile_rows = kPrune ? (h + kV - 1) / kV * kV : kStreamRows;
  const size_t smem = static_cast<size_t>(tile_rows) * kCols * sizeof(float) +
                      (kPrune ? tile_rows / kV * kCols * sizeof(float) : 0);
  auto kernel = dt1d_axis2_kernel<kHasAux, kPrune, Form>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // as few row blocks as kMaxGroups allows, each with the same number of
  // row groups, so that the last block is as full as the others
  // (a whole number of warps, for the kernel's warp votes)
  constexpr int kPerWarp = 32 / kCols;
  const int total = (dlen + kR - 1) / kR;
  const int row_blocks = (total + kMaxGroups - 1) / kMaxGroups;
  const int groups =
      ((total + row_blocks - 1) / row_blocks + kPerWarp - 1) / kPerWarp * kPerWarp;
  if (row_blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((w + kCols - 1) / kCols, row_blocks, batch);
  kernel<<<grid, kCols * groups, smem, stream>>>(
      src, aux, a, b, shift, nvalid, out_valid, out, ptr, h, w, dlen, step,
      tile_rows);
  return static_cast<int>(cudaGetLastError());
}

// Checks the sizes and picks the instantiation: out_valid (B, W) for the
// window form, null for K1. Returns cudaGetLastError() or the refusal.
template <class Form>
int dispatch(const float* src, const int* aux, const float* a, const float* b,
             const float* shift, const int* nvalid, const int* out_valid,
             float* out, int* ptr, int batch, int h, int w, int dlen, int step,
             void* stream) {
  if (batch <= 0 || batch > 65535 || h <= 0 || w <= 0 || dlen <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool prune = h <= kPruneMaxRows;
  if (aux != nullptr) {
    return prune ? launch<true, true, Form>(src, aux, a, b, shift, nvalid,
                                               out_valid, out, ptr, batch, h,
                                               w, dlen, step, s)
                 : launch<true, false, Form>(src, aux, a, b, shift, nvalid,
                                                out_valid, out, ptr, batch, h,
                                                w, dlen, step, s);
  }
  return prune ? launch<false, true, Form>(src, nullptr, a, b, shift,
                                              nvalid, out_valid, out, ptr,
                                              batch, h, w, dlen, step, s)
               : launch<false, false, Form>(src, nullptr, a, b, shift,
                                               nvalid, out_valid, out, ptr,
                                               batch, h, w, dlen, step, s);
}

}  // namespace pbd_dt
