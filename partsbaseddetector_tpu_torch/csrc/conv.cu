// Filter-bank valid correlation as an implicit GEMM in FP32 FMA, for sm_90a.
//
// Replaces partsbaseddetector_tpu/ops/conv_pallas.py::_conv_kernel (K2, run by
// filter_responses_pallas / filter_responses_infer):
//   out[s, y, x, f] = sum_{i < fh, j < fw, c < C} feat[s, y+i, x+j, c] * wk[(i*fw + j)*C + c, f]
// with features (S, H, W, C), the K-major weight matrix wk (K = fh*fw*C, FP)
// and out (S, H-fh+1, W-fw+1, FP). The wrapper pads the filter count F to FP,
// a multiple of kTileF, with zero columns and slices them off.
//
// The f32 contract is Precision.HIGHEST, so the products run on the FP32
// pipes (FFMA), not on TF32 tensor cores. Each output accumulates its K
// terms in (i, j, c) order in one register.
//
// Design: a block owns kTileH x kTileW output positions of one scale and
// kTileF filters. It stages the (kTileH+fh-1) x (kTileW+fw-1) x C feature
// patch in shared memory once (channel stride C+1, so the two column
// positions a warp reads fall in different banks), then walks the fh*fw taps;
// per tap it stages the C x kTileF weight slice and every thread does
// C x kTileH x 4 FMAs from registers (4 filters x kTileH rows at one column).
// Bounds on the H100: at the person26 VGA finest bucket (S = 5, 130x170x32
// features, F = 104 filters of 5x5, K = 800) the call does 8.7 GFLOP against
// ~58 MB of DRAM traffic (the f32 output dominates), ~150 FLOP per byte, so
// it is bound by FP32 issue rate (67 TFLOP/s peak) and by the shared-memory
// loads that feed it (9 loads per 32 FMAs per thread); wgmma on a 3xTF32
// split is the later route to tensor cores.

#include <cuda_runtime.h>

namespace {

constexpr int kTileH = 8;    // output rows per block
constexpr int kTileW = 16;   // output columns per block
constexpr int kTileF = 64;   // filters per block
constexpr int kThreads = 256;
constexpr int kFiltersPerThread = 4;  // kTileF / (kThreads / kTileW)

// The weight slice after the patch is read as float4: keep it 16 B aligned.
__host__ __device__ inline long long patch_floats(long long n) {
  return (n + 3) / 4 * 4;
}

__global__ void __launch_bounds__(kThreads)
conv_fp32_kernel(const float* __restrict__ feat, const float* __restrict__ wk,
                 float* __restrict__ out, int h, int w, int c, int fh, int fw,
                 int fp, int oh, int ow) {
  extern __shared__ float smem[];
  const int ph = kTileH + fh - 1;
  const int pw = kTileW + fw - 1;
  const int cs = c + 1;  // padded channel stride of the patch
  float* patch = smem;                             // [ph][pw][cs]
  float* wsm = smem + patch_floats(ph * pw * cs);  // [c][kTileF], 16 B aligned

  const int tiles_x = (ow + kTileW - 1) / kTileW;
  const int x0 = (blockIdx.x % tiles_x) * kTileW;
  const int y0 = (blockIdx.x / tiles_x) * kTileH;
  const int f0 = blockIdx.y * kTileF;
  const int s = blockIdx.z;
  const int tid = threadIdx.x;

  const float* fs = feat + static_cast<size_t>(s) * h * w * c;
  for (int idx = tid; idx < ph * pw * c; idx += kThreads) {
    const int ch = idx % c;
    const int rc = idx / c;
    const int cc = rc % pw;
    const int r = rc / pw;
    const int y = y0 + r;
    const int x = x0 + cc;
    float v = 0.0f;
    if (y < h && x < w) v = fs[(static_cast<size_t>(y) * w + x) * c + ch];
    patch[(r * pw + cc) * cs + ch] = v;
  }

  const int fg = tid % (kTileF / kFiltersPerThread);  // filter group
  const int col = tid / (kTileF / kFiltersPerThread);  // output column
  float acc[kTileH][kFiltersPerThread];
#pragma unroll
  for (int r = 0; r < kTileH; ++r)
#pragma unroll
    for (int q = 0; q < kFiltersPerThread; ++q) acc[r][q] = 0.0f;

  for (int i = 0; i < fh; ++i) {
    for (int j = 0; j < fw; ++j) {
      __syncthreads();  // patch written / previous weight slice consumed
      const float* wt = wk + static_cast<size_t>((i * fw + j) * c) * fp + f0;
      for (int idx = tid; idx < c * kTileF; idx += kThreads) {
        const int ch = idx / kTileF;
        const int f = idx % kTileF;
        wsm[idx] = wt[static_cast<size_t>(ch) * fp + f];
      }
      __syncthreads();
      const float* prow = patch + (i * pw + col + j) * cs;
      for (int ch = 0; ch < c; ++ch) {
        const float4 wv =
            *reinterpret_cast<const float4*>(wsm + ch * kTileF + fg * 4);
#pragma unroll
        for (int r = 0; r < kTileH; ++r) {
          const float xv = prow[r * pw * cs + ch];
          acc[r][0] = fmaf(xv, wv.x, acc[r][0]);
          acc[r][1] = fmaf(xv, wv.y, acc[r][1]);
          acc[r][2] = fmaf(xv, wv.z, acc[r][2]);
          acc[r][3] = fmaf(xv, wv.w, acc[r][3]);
        }
      }
    }
  }

  const int x = x0 + col;
  if (x >= ow) return;
#pragma unroll
  for (int r = 0; r < kTileH; ++r) {
    const int y = y0 + r;
    if (y < oh) {
      float4* dst = reinterpret_cast<float4*>(
          out + ((static_cast<size_t>(s) * oh + y) * ow + x) * fp + f0 +
          fg * 4);
      *dst = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
  }
}

}  // namespace

extern "C" int pbd_conv_tile_filters() { return kTileF; }

// Dynamic shared memory of one block, in bytes.
extern "C" long long pbd_conv_smem_bytes(int c, int fh, int fw) {
  return (patch_floats(static_cast<long long>(kTileH + fh - 1) *
                       (kTileW + fw - 1) * (c + 1)) +
          static_cast<long long>(c) * kTileF) *
         static_cast<long long>(sizeof(float));
}

// feat (S, H, W, C) f32, wk (fh*fw*C, FP) f32 -> out (S, H-fh+1, W-fw+1, FP)
// f32, all contiguous on the current device; FP a multiple of kTileF.
// Returns cudaGetLastError().
extern "C" int pbd_conv_fp32(const float* feat, const float* wk, float* out,
                             int s, int h, int w, int c, int fh, int fw,
                             int fp, void* stream) {
  const int oh = h - fh + 1;
  const int ow = w - fw + 1;
  if (s <= 0 || s > 65535 || c <= 0 || oh <= 0 || ow <= 0 || fp <= 0 ||
      fp % kTileF != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long smem = pbd_conv_smem_bytes(c, fh, fw);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv_fp32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int tiles = ((oh + kTileH - 1) / kTileH) * ((ow + kTileW - 1) / kTileW);
  const dim3 grid(tiles, fp / kTileF, s);
  conv_fp32_kernel<<<grid, kThreads, static_cast<size_t>(smem),
                     static_cast<cudaStream_t>(stream)>>>(
      feat, wk, out, h, w, c, fh, fw, fp, oh, ow);
  return static_cast<int>(cudaGetLastError());
}
