// Batched 2-D transpose of 32-bit words, (B, H, W) -> (B, W, H), of one array
// or of a pair of arrays of one shape in a single launch, for sm_90a.
//
// Replaces T2, tools/transpose_kernel_probe.py::make_tp (a Pallas kernel that
// writes x_ref[0].T per map), whose purpose was the DT x pass's four
// response-sized transposes. Here it serves exactly those, as two pairs: the
// y-pass values and pointers before the x pass, the x-pass values and
// pointers after it (ops/distance_transform.py). It moves words and never
// does arithmetic on them, so one kernel serves f32 values and i32 pointers,
// and its output is the plain version's (x.transpose(-1, -2).contiguous())
// bit for bit.
//
// Bounds on the H100: no arithmetic, each word read once and written once:
// 2 * 4 * B*H*W bytes at 3.35 TB/s. Two regimes, both measured with
// tools/kernel_variants.py. At a detect's shapes (a few MB that the DT pass
// before it left in the 50 MB L2) a 32x32 register tile already takes what
// the card gives a contiguous copy of the same bytes (dst.copy_(src)), and
// what is left to save is the launch. At a microbatch's shapes (hundreds of
// MB, beyond the L2) the time is HBM's, and it depends on the order in which
// the blocks touch memory. So:
//
//   * One launch per pair. The block index runs over the maps of the first
//     array and then over those of the second, so values and pointers share
//     a launch. A detect launches 100 transposes instead of 200.
//   * Consecutive blocks walk the tiles of one map, so that the blocks in
//     flight read and write a few neighbouring maps and not one tile position
//     of hundreds of maps 84 KB apart: beyond the L2 that order takes 0.43x
//     the time of the other, within 7% of the contiguous copy. The grid is
//     one axis of maps x tiles (up to 2^31 - 1 blocks: batched serving stacks
//     more than 65,535 maps); ragged edges are guarded.
//   * A 32x32 tile goes through shared memory with a padding column
//     ([32][33]), so that neither the row-wise write nor the column-wise read
//     of the tile has bank conflicts and both the global load and the global
//     store are coalesced (a warp moves 32 neighbouring words). 32x8 threads;
//     each starts its four loads into registers before its first
//     shared-memory store (unrolled), so that they are all in flight
//     together: a rolled loop, whose shared store waits on its load, keeps
//     one in flight. Larger tiles (64x32, 32x64, 64x64) measured no faster in
//     the L2 and slower beyond it.
//
// Tried and measured slower on this card: a persistent grid of two blocks per
// SM walking (array, map, tile) items with two cp.async-filled tile buffers
// and balanced tiles of up to 64x64. In the L2 its per-word index arithmetic
// and 4- or 8-byte cp.async cost more than the wave tail and the ragged tiles
// they remove; beyond the L2 its memory order beat a map-major grid by 1.9x,
// and the tile-major grid here beats it in turn. 16-byte copies and a TMA
// tensor map do not apply: the row pitches (664 and 504 bytes at the person26
// shapes) are multiples of 8, not of 16, and TMA needs global strides that
// are multiples of 16 bytes, which these maps only meet after a padding copy.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;
constexpr int kPer = kTile / kRows;  // words per thread

__global__ void __launch_bounds__(kTile * kRows)
transpose32_kernel(const uint32_t* __restrict__ src0,
                   uint32_t* __restrict__ dst0,
                   const uint32_t* __restrict__ src1,
                   uint32_t* __restrict__ dst1, unsigned batch, int h, int w,
                   unsigned tiles_w, unsigned per_map) {
  __shared__ uint32_t tile[kTile][kTile + 1];
  // consecutive blocks walk one map's tiles; the second array's maps follow
  // the first's
  const unsigned m = blockIdx.x / per_map;
  const unsigned t = blockIdx.x % per_map;
  const bool second = m >= batch;
  const size_t map = static_cast<size_t>(second ? m - batch : m) * h * w;
  const uint32_t* __restrict__ src = (second ? src1 : src0) + map;
  uint32_t* __restrict__ dst = (second ? dst1 : dst0) + map;
  const int x0 = (t % tiles_w) * kTile;  // source column of the tile
  const int y0 = (t / tiles_w) * kTile;  // source row of the tile
  const int x = x0 + threadIdx.x;
  uint32_t v[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int y = y0 + threadIdx.y + k * kRows;
    v[k] = (x < w && y < h) ? __ldg(src + static_cast<size_t>(y) * w + x) : 0u;
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
      dst[static_cast<size_t>(r) * h + c] = tile[threadIdx.x][j];
    }
  }
}

}  // namespace

// src0 (B, H, W) of 32-bit words -> dst0 (B, W, H); with src1 and dst1 not
// null, a second array of the same shape in the same launch. All contiguous
// on the current device. Returns cudaGetLastError().
extern "C" int pbd_transpose32(const void* src0, void* dst0, const void* src1,
                               void* dst1, int batch, int h, int w,
                               void* stream) {
  const bool pair = src1 != nullptr;
  if (batch <= 0 || h <= 0 || w <= 0 || pair != (dst1 != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles_w = (w + kTile - 1) / kTile;
  const long long per_map = tiles_w * ((h + kTile - 1) / kTile);
  const long long blocks = (pair ? 2LL * batch : batch) * per_map;
  if (blocks > 0x7fffffffLL) {  // one grid axis
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block(kTile, kRows);
  const dim3 grid(static_cast<unsigned>(blocks));
  transpose32_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(src0), static_cast<uint32_t*>(dst0),
      static_cast<const uint32_t*>(src1), static_cast<uint32_t*>(dst1),
      static_cast<unsigned>(batch), h, w, static_cast<unsigned>(tiles_w),
      static_cast<unsigned>(per_map));
  return static_cast<int>(cudaGetLastError());
}
