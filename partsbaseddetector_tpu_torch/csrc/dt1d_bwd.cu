// Backward of the 1-D generalized distance transform along axis -2, f32,
// for sm_90a.
//
// Replaces K4 of partsbaseddetector_tpu/ops/pallas_dt.py: the custom VJP
// `_diff_dt` around the Pallas DT kernel (its backward, the max's
// subgradient). The forward is csrc/dt1d.cu; it leaves, for map b, output
// row i and column w, the value out[b,i,w] and the winning source v* (the
// low 12 bits of the pointer when the forward carried aux). With
// q = shift[b] + step*i and d = q - v*:
//   g_src[b, v, w] = sum of g[b,i,w] over the rows i whose v* is v,
//   g_a[b]         = sum_{i,w} g[b,i,w] * d * d,
//   g_b[b]         = sum_{i,w} g[b,i,w] * d.
// An output that is -inf (the forward's dead sentinel: no live source,
// pointer 0) contributes nothing. The Pallas backward builds a one-hot
// (dlen x N) contraction per row, a shape made for the TPU's matrix unit;
// here the scatter is a direct walk.
//
// Determinism, not speed, shapes the design. One thread block per map b;
// its threads stride over the columns w. A thread first zeroes column w of
// g_src, then walks the output rows i in ascending order and adds g[b,i,w]
// into g_src[b, v*, w]: only that thread touches column w of map b, so
// there are no atomics and the sum order is fixed. The thread keeps its
// g*d*d and g*d in registers; a fixed-order tree reduction in shared memory
// writes g_a[b] and g_b[b]. Every operation is a round-to-nearest intrinsic,
// so nvcc cannot contract g*d*d into an FMA, and each term is rounded as in
// the plain version (ops/dt_cuda.py::dt1d_bwd_plain); only the order of the
// sums differs from it.
//
// Bounds on the H100: per map it reads g, out and ptr once (12 bytes per
// output) and reads and writes g_src once per output, so it is bound by
// memory latency along each thread's dependent walk over i, not by FP32
// throughput. Threads of a warp own neighbouring w, so g, out and ptr loads
// coalesce; the g_src updates scatter over the rows v* of one map and are
// served from L1/L2. A faster form (one warp per column strip with the
// scatter staged in shared memory) is later work.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;

template <bool kHasAux>
__global__ void __launch_bounds__(kThreads)
dt1d_axis2_bwd_kernel(const float* __restrict__ g, const float* __restrict__ out,
                      const int* __restrict__ ptr,
                      const float* __restrict__ shift,
                      float* __restrict__ g_src, float* __restrict__ g_a,
                      float* __restrict__ g_b, int h, int w, int dlen,
                      int step) {
  __shared__ float red_a[kThreads];
  __shared__ float red_b[kThreads];
  const int m = blockIdx.x;
  const int t = threadIdx.x;
  const float sh = shift[m];
  const size_t in_base = static_cast<size_t>(m) * dlen * w;
  float* gs = g_src + static_cast<size_t>(m) * h * w;
  float acc_a = 0.0f;
  float acc_b = 0.0f;
  for (int x = t; x < w; x += kThreads) {
    for (int v = 0; v < h; ++v) gs[static_cast<size_t>(v) * w + x] = 0.0f;
    for (int i = 0; i < dlen; ++i) {
      const size_t o = in_base + static_cast<size_t>(i) * w + x;
      if (out[o] == -CUDART_INF_F) continue;
      const float gi = g[o];
      const int p = ptr[o];
      const int v = kHasAux ? (p & 0xFFF) : p;
      const float q = __fadd_rn(sh, static_cast<float>(step * i));
      const float d = __fsub_rn(q, static_cast<float>(v));
      const float gd = __fmul_rn(gi, d);
      acc_b = __fadd_rn(acc_b, gd);
      acc_a = __fadd_rn(acc_a, __fmul_rn(gd, d));
      float* cell = gs + static_cast<size_t>(v) * w + x;
      *cell = __fadd_rn(*cell, gi);
    }
  }
  red_a[t] = acc_a;
  red_b[t] = acc_b;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (t < s) {
      red_a[t] = __fadd_rn(red_a[t], red_a[t + s]);
      red_b[t] = __fadd_rn(red_b[t], red_b[t + s]);
    }
    __syncthreads();
  }
  if (t == 0) {
    g_a[m] = red_a[0];
    g_b[m] = red_b[0];
  }
}

}  // namespace

// g, out (B, dlen, W) f32, ptr (B, dlen, W) i32, shift (B,) f32 ->
// g_src (B, H, W) f32 (fully written), g_a, g_b (B,) f32. has_aux: the
// pointers carry aux in their high bits. All contiguous on the current
// device. Returns cudaGetLastError().
extern "C" int pbd_dt1d_axis2_bwd_f32(const float* g, const float* out,
                                      const int* ptr, const float* shift,
                                      float* g_src, float* g_a, float* g_b,
                                      int batch, int h, int w, int dlen,
                                      int step, int has_aux, void* stream) {
  if (batch <= 0 || batch > 65535 || h <= 0 || w <= 0 || dlen <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (has_aux) {
    dt1d_axis2_bwd_kernel<true><<<batch, kThreads, 0, s>>>(
        g, out, ptr, shift, g_src, g_a, g_b, h, w, dlen, step);
  } else {
    dt1d_axis2_bwd_kernel<false><<<batch, kThreads, 0, s>>>(
        g, out, ptr, shift, g_src, g_a, g_b, h, w, dlen, step);
  }
  return static_cast<int>(cudaGetLastError());
}
