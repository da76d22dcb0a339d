// Adaptive-window 1-D generalized distance transform along axis -2, f32,
// step 1, for sm_90a.
//
// Replaces K5 of partsbaseddetector_tpu/ops/pallas_dt.py: _make_window_kernel
// (run by _dt1d_pallas_window / dt1d_pallas under PBD_DT_WINDOW=1). The TPU
// kernel laid output positions on lanes over an anchor-aligned slab and ran
// one while-loop per 128-lane tile until every lane could stop; here one
// thread owns one output and stops its own scan.
//
// For map b, output row i and column w, with q = shift[b] + i (shift
// integral) and i < out_valid[b, w]:
//   out[b,i,w] = max_{0 <= v < nvalid[b]} (a[b]*(q-v) + b[b])*(q-v) + src[b,v,w]
//   ptr[b,i,w] = the smallest v reaching the max; with aux:
//                (aux[b,v*,w] << 12) | v*.
// That is K1's value and pointer (csrc/dt1d.cu) bit for bit: every candidate
// value is rounded with the same __fsub_rn/__fmul_rn/__fadd_rn order. An
// output with no live source is (-inf, 0). Outputs at i >= out_valid[b, w]
// are don't-care for the caller (they are masked downstream) and are written
// as (-inf, 0) without a scan.
//
// The scan visits displacements outward from q: at step s it tries
// v = q - s, then v = q + s, skipping v outside [0, nvalid). Since that is
// not v order, a tie updates the best only when its v is smaller. After
// step s every remaining source has |q - v| > s, so its value is at most
//   msrc + max_{|d| > s} pen(d),   pen(d) = (a*d + b)*d,
// where msrc is the largest live source of the column. For a < 0 the pen is
// concave: its max over |d| >= s+1 is at d = +-(s+1), or at the vertex
// d* = -b/(2a) when |d*| > s+1. The thread exits when its best reaches that
// bound plus a slack of 1e-3 + 1e-3*(|msrc| + |pf|), so float rounding in
// the bound can only delay the exit, never cut a scan short. The exit is
// taken only when a < 0, or a == 0 and b == 0 (the penalty is then flat);
// otherwise the scan runs to max(q, nvalid - 1 - q), past which no source is
// live. A column with no live source (msrc = -inf) would give a NaN bound: its
// outputs are (-inf, 0) without a scan.
//
// Bounds on the H100: like K1 the work is FP32 throughput, ~5 ops a candidate,
// but a thread evaluates only the window its spring cost leaves winnable
// instead of all nvalid sources. Threads of a warp exit at different steps
// and diverge; neighbouring threads own neighbouring columns, so while they
// scan together the loads of src[b, v, :] coalesce. msrc is computed once
// per block and column in a shared-memory prologue (each of the blockDim.y
// threads of a column takes every kBlockI-th row). A block whose outputs
// are all don't-care skips the prologue and the scan.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBlockW = 32;
constexpr int kBlockI = 8;

template <bool kHasAux>
__global__ void __launch_bounds__(kBlockW * kBlockI)
dt1d_window_kernel(const float* __restrict__ src, const int* __restrict__ aux,
                   const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ shift,
                   const int* __restrict__ nvalid,
                   const int* __restrict__ out_valid, float* __restrict__ out,
                   int* __restrict__ ptr, int h, int w, int dlen) {
  __shared__ float colmax[kBlockI][kBlockW];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int x = blockIdx.x * kBlockW + tx;
  const int i = blockIdx.y * kBlockI + ty;
  const int m = blockIdx.z;
  const bool active = x < w && i < dlen;
  const int ov =
      x < w ? min(max(out_valid[static_cast<size_t>(m) * w + x], 0), dlen) : 0;
  const bool need = active && i < ov;
  const size_t o = (static_cast<size_t>(m) * dlen + i) * w + x;
  if (!__syncthreads_or(need)) {
    if (active) {
      out[o] = -CUDART_INF_F;
      ptr[o] = 0;
    }
    return;
  }

  const int nv = min(max(nvalid[m], 0), h);
  const float* col = src + static_cast<size_t>(m) * h * w + x;
  float cmax = -CUDART_INF_F;
  if (x < w) {
    for (int v = ty; v < nv; v += kBlockI) {
      cmax = fmaxf(cmax, col[static_cast<size_t>(v) * w]);
    }
  }
  colmax[ty][tx] = cmax;
  __syncthreads();
  if (!active) return;
  float msrc = colmax[0][tx];
  for (int k = 1; k < kBlockI; ++k) msrc = fmaxf(msrc, colmax[k][tx]);

  float best = -CUDART_INF_F;
  int bestv = 0;
  if (need && msrc != -CUDART_INF_F) {
    const float am = a[m];
    const float bm = b[m];
    const float sh = shift[m];
    const float q = __fadd_rn(sh, static_cast<float>(i));
    const int qi = static_cast<int>(sh) + i;
    const bool neg_a = am < 0.0f;
    const bool exitable = neg_a || (am == 0.0f && bm == 0.0f);
    const float dstar = neg_a ? -bm / (2.0f * am) : 0.0f;
    const float pen_star = (am * dstar + bm) * dstar;
    const int lim = max(qi, nv - 1 - qi);
    bestv = 0x7FFFFFFF;
    for (int s = 0; s <= lim; ++s) {
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        if (side == 1 && s == 0) break;
        const int v = side == 0 ? qi - s : qi + s;
        if (v < 0 || v >= nv) continue;
        const float d = __fsub_rn(q, static_cast<float>(v));
        const float pen = __fmul_rn(__fadd_rn(__fmul_rn(am, d), bm), d);
        const float val = __fadd_rn(pen, col[static_cast<size_t>(v) * w]);
        if (val > best || (val == best && v < bestv)) {
          best = val;
          bestv = v;
        }
      }
      if (exitable) {
        const float sf = static_cast<float>(s + 1);
        float pf = fmaxf((am * sf + bm) * sf, (-am * sf + bm) * -sf);
        if (neg_a && fabsf(dstar) > sf) pf = fmaxf(pf, pen_star);
        const float slack = 1e-3f + 1e-3f * (fabsf(msrc) + fabsf(pf));
        if (best >= msrc + pf + slack) break;
      }
    }
  }
  if (best == -CUDART_INF_F) bestv = 0;
  out[o] = best;
  int p = bestv;
  if (kHasAux && best != -CUDART_INF_F) {
    p = (aux[(static_cast<size_t>(m) * h + bestv) * w + x] << 12) | bestv;
  }
  ptr[o] = p;
}

}  // namespace

// src (B, H, W) f32, aux (B, H, W) i32 or null, a/b/shift (B,) f32 (shift
// integral), nvalid (B,) i32, out_valid (B, W) i32 -> out (B, dlen, W) f32,
// ptr (B, dlen, W) i32. All contiguous on the current device. Returns
// cudaGetLastError().
extern "C" int pbd_dt1d_window_axis2_f32(const float* src, const int* aux,
                                         const float* a, const float* b,
                                         const float* shift, const int* nvalid,
                                         const int* out_valid, float* out,
                                         int* ptr, int batch, int h, int w,
                                         int dlen, void* stream) {
  if (batch <= 0 || batch > 65535 || h <= 0 || w <= 0 || dlen <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block(kBlockW, kBlockI);
  const dim3 grid((w + kBlockW - 1) / kBlockW, (dlen + kBlockI - 1) / kBlockI,
                  batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (aux != nullptr) {
    dt1d_window_kernel<true><<<grid, block, 0, s>>>(
        src, aux, a, b, shift, nvalid, out_valid, out, ptr, h, w, dlen);
  } else {
    dt1d_window_kernel<false><<<grid, block, 0, s>>>(
        src, nullptr, a, b, shift, nvalid, out_valid, out, ptr, h, w, dlen);
  }
  return static_cast<int>(cudaGetLastError());
}
