// Explicit-patch filter-bank correlation in FP32 FMA, for sm_90a.
//
// Replaces tools/conv_pallas_proto.py::kernel (T1, launched by conv_pallas
// through pl.pallas_call), the prototype of K2:
//   out[s, y, x, f] = sum_{i < fh, j < fw, c < C}
//                     feat_t[s, y+i, c, x+j] * w2[(i*fw + j)*C + c, f]
// from T1's own layouts: features pre-transposed to (S, H, C, W), so that one
// (scale, row) is one contiguous C x W run, and the K-major weight matrix w2
// (K = fh*fw*C, FP), FP a multiple of kTileF with zero columns past the
// filter count. out is (S, OH, OW, FP), OH = H-fh+1, OW = W-fw+1.
//
// Design: T1's explicit im2row, unlike K2's halo patch (csrc/conv.cu). A block
// owns `toh` output rows x `tw` = kPos / toh output columns of one scale
// (toh is a runtime parameter, 1 <= toh <= kPos) and kTileF filters. It walks
// K one tap (i, j) at a time, C K-rows per chunk. Per chunk it stages the
// patch-matrix slice P[c][t*tw + x] = feat_t[s, y0+t+i, c, x0+x+j] in shared
// memory (each source row is a run along W, so neighbouring threads load
// neighbouring columns) and the chunk's C x kTileF slice of w2, then every
// thread does C x 8 x 4 FMAs (8 positions x 4 filters) from shared memory.
// Positions past OH or OW (the ragged last tiles, and rows past OH when toh
// does not divide it) stage zeros and are never stored; no row past H is read.
// T1's padding of H to NOH*TOH + FH - 1 rows is therefore not needed, and the
// wrapper's FP columns past F are sliced off, so neither reaches the result.
//
// Accumulation order: each output sums its K terms in (i, j, c) order in one
// register with fmaf, starting from 0, exactly as csrc/conv.cu does, so on the
// same inputs its output equals K2's bit for bit.
//
// Resources: (C*kPos + C*kTileF) floats of dynamic shared memory per block,
// 24,576 bytes at C = 32 (pbd_conv_proto_smem_bytes), below the 48 KB default
// and the 227 KB per-block limit; 256 threads, 32 accumulators each.
// Bounds on the H100: at T1's default shapes (S = 5, 126x166x32 features,
// F = 104 filters of 5x5, K = 800) the call does 2*S*OH*OW*K*F = 16.44 GFLOP
// against 54.8 MB of inputs and outputs, so it is bound by the FP32 pipes
// (67 TFLOP/s: 0.245 ms) and, in this design, by the shared-memory loads that
// feed them (9 loads per 32 FMAs per thread, as K2). The tensor cores (wgmma
// on a 3xTF32 split) are the later route.

#include <cuda_runtime.h>

namespace {

constexpr int kPos = 128;     // output positions per block: toh rows x tw columns
constexpr int kTileF = 64;    // filters per block
constexpr int kThreads = 256;
constexpr int kFiltersPerThread = 4;
constexpr int kFilterGroups = kTileF / kFiltersPerThread;  // 16
constexpr int kPosGroups = kThreads / kFilterGroups;       // 16
constexpr int kPosPerThread = kPos / kPosGroups;           // 8

__global__ void __launch_bounds__(kThreads)
conv_proto_kernel(const float* __restrict__ feat, const float* __restrict__ w2,
                  float* __restrict__ out, int h, int w, int c, int fh, int fw,
                  int fp, int oh, int ow, int toh, int tw) {
  extern __shared__ float smem[];
  float* patch = smem;             // [c][kPos]
  float* wsm = smem + c * kPos;    // [c][kTileF], 16 B aligned (kPos % 4 == 0)

  const int tiles_x = (ow + tw - 1) / tw;
  const int x0 = (blockIdx.x % tiles_x) * tw;
  const int y0 = (blockIdx.x / tiles_x) * toh;
  const int f0 = blockIdx.y * kTileF;
  const int s = blockIdx.z;
  const int tid = threadIdx.x;
  const int npos = toh * tw;

  const float* fs = feat + static_cast<size_t>(s) * h * c * w;
  const int fg = tid % kFilterGroups;  // filters f0 + 4*fg .. +3
  const int pg = tid / kFilterGroups;  // positions pg + kPosGroups*r
  float acc[kPosPerThread][kFiltersPerThread];
#pragma unroll
  for (int r = 0; r < kPosPerThread; ++r)
#pragma unroll
    for (int q = 0; q < kFiltersPerThread; ++q) acc[r][q] = 0.0f;

  for (int i = 0; i < fh; ++i) {
    for (int j = 0; j < fw; ++j) {
      __syncthreads();  // the previous chunk is consumed
      for (int idx = tid; idx < c * kPos; idx += kThreads) {
        const int ch = idx / kPos;
        const int pos = idx % kPos;
        const int t = pos / tw;
        const int x = pos - t * tw;
        float v = 0.0f;
        if (pos < npos && y0 + t < oh && x0 + x < ow)
          v = fs[(static_cast<size_t>(y0 + t + i) * c + ch) * w + x0 + x + j];
        patch[idx] = v;
      }
      const float* wt = w2 + static_cast<size_t>((i * fw + j) * c) * fp + f0;
      for (int idx = tid; idx < c * kTileF; idx += kThreads) {
        const int ch = idx / kTileF;
        const int f = idx % kTileF;
        wsm[idx] = wt[static_cast<size_t>(ch) * fp + f];
      }
      __syncthreads();
      for (int ch = 0; ch < c; ++ch) {
        const float4 wv =
            *reinterpret_cast<const float4*>(wsm + ch * kTileF + fg * 4);
        const float* prow = patch + ch * kPos + pg;
#pragma unroll
        for (int r = 0; r < kPosPerThread; ++r) {
          const float xv = prow[r * kPosGroups];
          acc[r][0] = fmaf(xv, wv.x, acc[r][0]);
          acc[r][1] = fmaf(xv, wv.y, acc[r][1]);
          acc[r][2] = fmaf(xv, wv.z, acc[r][2]);
          acc[r][3] = fmaf(xv, wv.w, acc[r][3]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kPosPerThread; ++r) {
    const int pos = pg + r * kPosGroups;
    const int t = pos / tw;
    const int y = y0 + t;
    const int x = x0 + pos - t * tw;
    if (pos < npos && y < oh && x < ow) {
      float4* dst = reinterpret_cast<float4*>(
          out + ((static_cast<size_t>(s) * oh + y) * ow + x) * fp + f0 +
          fg * 4);
      *dst = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
  }
}

}  // namespace

extern "C" int pbd_conv_proto_tile_filters() { return kTileF; }

extern "C" int pbd_conv_proto_max_toh() { return kPos; }

// Dynamic shared memory of one block, in bytes.
extern "C" long long pbd_conv_proto_smem_bytes(int c) {
  return static_cast<long long>(c) * (kPos + kTileF) *
         static_cast<long long>(sizeof(float));
}

// feat_t (S, H, C, W) f32, w2 (fh*fw*C, FP) f32 -> out (S, H-fh+1, W-fw+1, FP)
// f32, all contiguous on the current device; FP a multiple of kTileF and
// 1 <= toh <= kPos. Returns cudaGetLastError().
extern "C" int pbd_conv_proto_fp32(const float* feat, const float* w2,
                                   float* out, int s, int h, int c, int w,
                                   int fh, int fw, int fp, int toh,
                                   void* stream) {
  const int oh = h - fh + 1;
  const int ow = w - fw + 1;
  if (s <= 0 || s > 65535 || c <= 0 || fh <= 0 || fw <= 0 || oh <= 0 ||
      ow <= 0 || fp <= 0 || fp % kTileF != 0 || fp / kTileF > 65535 ||
      toh < 1 || toh > kPos) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long smem = pbd_conv_proto_smem_bytes(c);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv_proto_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int tw = kPos / toh;
  const long long tiles =
      static_cast<long long>((oh + toh - 1) / toh) * ((ow + tw - 1) / tw);
  if (tiles > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles), fp / kTileF, s);
  conv_proto_kernel<<<grid, kThreads, static_cast<size_t>(smem),
                      static_cast<cudaStream_t>(stream)>>>(
      feat, w2, out, h, w, c, fh, fw, fp, oh, ow, toh, tw);
  return static_cast<int>(cudaGetLastError());
}
