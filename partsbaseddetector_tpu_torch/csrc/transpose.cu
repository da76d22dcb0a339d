// Batched 2-D transpose of 32-bit words, (B, H, W) -> (B, W, H), for sm_90a.
//
// Replaces T2, tools/transpose_kernel_probe.py::make_tp (a Pallas kernel that
// writes x_ref[0].T per map), whose purpose was the DT x pass's four
// response-sized transposes. Here it serves exactly those: the y-pass values
// and pointers before the x pass, the x-pass values and pointers after it
// (ops/distance_transform.py). It moves words and never does arithmetic on
// them, so one kernel serves f32 values and i32 pointers, and its output is
// the plain version's (x.transpose(-1, -2).contiguous()) bit for bit.
//
// Bounds on the H100: no arithmetic, so it is bound by memory, each word read
// once and written once: 2 * 4 * B*H*W bytes at 3.35 TB/s. A 32x32 tile goes
// through shared memory with a padding column ([32][33]), so that neither
// the row-wise read nor the column-wise read of the tile has bank conflicts
// and both the global load and the global store are coalesced (a warp moves
// 32 neighbouring words). 32x8 threads, each moving 4 words of the tile.
// The map index is on gridDim.x (up to 2^31 - 1): batched serving stacks
// more than 65,535 maps. The tiles of a map are on gridDim.y (columns) and
// gridDim.z (rows); ragged edges are guarded. Each thread issues its four
// loads before its first shared-memory store (unrolled, into registers), so
// that four loads per thread are in flight: a rolled loop, whose shared store
// waits on its load, keeps one in flight and measured ~450 GB/s on an H100 at
// the person26 shapes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;
constexpr int kPer = kTile / kRows;  // words per thread

__global__ void __launch_bounds__(kTile * kRows)
transpose32_kernel(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst,
                   int h, int w) {
  __shared__ uint32_t tile[kTile][kTile + 1];
  const size_t map = static_cast<size_t>(blockIdx.x) * h * w;
  const int x0 = blockIdx.y * kTile;  // source column of the tile
  const int y0 = blockIdx.z * kTile;  // source row of the tile
  const int x = x0 + threadIdx.x;
  uint32_t v[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int y = y0 + threadIdx.y + k * kRows;
    v[k] = (x < w && y < h) ? __ldg(src + map + static_cast<size_t>(y) * w + x)
                            : 0u;
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    tile[threadIdx.y + k * kRows][threadIdx.x] = v[k];
  }
  __syncthreads();
  // destination row r = source column, destination column c = source row
  const int c = y0 + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = threadIdx.y + k * kRows;
    const int r = x0 + j;
    if (r < w && c < h) {
      dst[map + static_cast<size_t>(r) * h + c] = tile[threadIdx.x][j];
    }
  }
}

}  // namespace

// src (B, H, W) of 32-bit words -> dst (B, W, H), both contiguous on the
// current device. Returns cudaGetLastError().
extern "C" int pbd_transpose32(const void* src, void* dst, int batch, int h,
                               int w, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles_w = (w + kTile - 1) / kTile;
  const int tiles_h = (h + kTile - 1) / kTile;
  if (tiles_w > 65535 || tiles_h > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block(kTile, kRows);
  const dim3 grid(batch, tiles_w, tiles_h);
  transpose32_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(src), static_cast<uint32_t*>(dst), h, w);
  return static_cast<int>(cudaGetLastError());
}
