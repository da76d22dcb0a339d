// 1-D generalized distance transform along axis -2, f32, for sm_90a.
//
// Replaces two Pallas kernels of partsbaseddetector_tpu/ops/pallas_dt.py:
//   K1  _make_sublane_kernel (run by _dt1d_sublane_call / dt1d_sublane), the
//       y pass and the transposed x pass of the main-path 2-D transform;
//   K3  _make_kernel, forward only (run by _dt1d_pallas_2d / dt1d_pallas), the
//       same transform along the last axis. The wrapper transposes the map so
//       that axis becomes axis -2. Row packing and tail peeling were 128-lane
//       artefacts and have no counterpart here.
//
// For map b, output row i and column w, with q = shift[b] + step*i:
//   out[b,i,w] = max_{v < nvalid[b]} (a[b]*(q-v) + b[b])*(q-v) + src[b,v,w]
//   ptr[b,i,w] = the smallest v reaching the max (strict > in ascending v);
//                with aux: (aux[b,v*,w] << 12) | v*.
// An output with no live source is -inf (the sentinel of this port and of
// its plain version dt_cuda.py::dt1d_plain) with pointer 0.
//
// Rounding: every operation is an explicit round-to-nearest intrinsic, so
// nvcc cannot contract (a*d+b)*d + s into FMAs. The plain torch version
// evaluates the same expression in the same order, and the two agree bit for
// bit, argmax included at near-ties.
//
// Bounds on the H100: the brute-force scan costs dlen*nvalid*W evaluations of
// ~5 FP32 ops per map, so it is bound by FP32 issue rate (67 TFLOP/s peak),
// not by memory: each source row is read once from DRAM and then served from
// L1 to the blockDim.y output rows of a block. One thread owns one output;
// neighbouring threads own neighbouring w, so the loads of src[b, v, :]
// coalesce. The O(N) lower-envelope scan (one thread per column, as in
// ops/reference.py::dt1d_envelope) is the later alternative; it must keep
// the smallest-v tie rule.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBlockW = 32;
constexpr int kBlockI = 8;

template <bool kHasAux>
__global__ void __launch_bounds__(kBlockW * kBlockI)
dt1d_axis2_kernel(const float* __restrict__ src, const int* __restrict__ aux,
                  const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ shift,
                  const int* __restrict__ nvalid, float* __restrict__ out,
                  int* __restrict__ ptr, int h, int w, int dlen, int step) {
  const int x = blockIdx.x * kBlockW + threadIdx.x;
  const int i = blockIdx.y * kBlockI + threadIdx.y;
  const int m = blockIdx.z;
  if (x >= w || i >= dlen) return;
  const float am = a[m];
  const float bm = b[m];
  const float q = __fadd_rn(shift[m], static_cast<float>(step * i));
  const int nv = min(max(nvalid[m], 0), h);
  const float* col = src + static_cast<size_t>(m) * h * w + x;
  float best = -CUDART_INF_F;
  int bestv = 0;
  for (int v = 0; v < nv; ++v) {
    const float d = __fsub_rn(q, static_cast<float>(v));
    const float pen = __fmul_rn(__fadd_rn(__fmul_rn(am, d), bm), d);
    const float val = __fadd_rn(pen, col[static_cast<size_t>(v) * w]);
    if (val > best) {
      best = val;
      bestv = v;
    }
  }
  const size_t o = (static_cast<size_t>(m) * dlen + i) * w + x;
  out[o] = best;
  int p = bestv;
  if (kHasAux) {
    p = (best == -CUDART_INF_F)
            ? 0
            : ((aux[(static_cast<size_t>(m) * h + bestv) * w + x] << 12) |
               bestv);
  }
  ptr[o] = p;
}

}  // namespace

// src (B, H, W) f32, aux (B, H, W) i32 or null, a/b/shift (B,) f32,
// nvalid (B,) i32 -> out (B, dlen, W) f32, ptr (B, dlen, W) i32.
// All contiguous on the current device. Returns cudaGetLastError().
extern "C" int pbd_dt1d_axis2_f32(const float* src, const int* aux,
                                  const float* a, const float* b,
                                  const float* shift, const int* nvalid,
                                  float* out, int* ptr, int batch, int h,
                                  int w, int dlen, int step, void* stream) {
  if (batch <= 0 || batch > 65535 || h <= 0 || w <= 0 || dlen <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block(kBlockW, kBlockI);
  const dim3 grid((w + kBlockW - 1) / kBlockW, (dlen + kBlockI - 1) / kBlockI,
                  batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (aux != nullptr) {
    dt1d_axis2_kernel<true><<<grid, block, 0, s>>>(
        src, aux, a, b, shift, nvalid, out, ptr, h, w, dlen, step);
  } else {
    dt1d_axis2_kernel<false><<<grid, block, 0, s>>>(
        src, nullptr, a, b, shift, nvalid, out, ptr, h, w, dlen, step);
  }
  return static_cast<int>(cudaGetLastError());
}
