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
// Bounds on the H100: per map it reads g, out and ptr once (12 bytes per
// output) and writes g_src once, a few FP32 operations per output, so
// bytes bound it (0.0174 ms for the person26 240x320 train pair). What
// held the first kernel back was latency: one thread per column walked
// every output row with a read-modify-write of g_src in global memory, a
// chain of dlen L2 round trips per thread, after zeroing its column there.
//
// Design. One block owns one map, so the map's sums finish in the block
// and no atomics or second pass are needed. The map's columns fall into
// 32-column strips, a lane per column; the block takes `strips` of them at
// a time (a round, all of them when they fit) and splits each strip's
// output rows into `segments` contiguous segments, one warp each: warp
// k = t * segments + j takes strip t of the round and segment j. A warp
// reads g, out and ptr a whole 128-byte row at a time, in batches of
// kBatch rows: the next batch's loads are issued before this batch's
// scatter (the first's before the slab is zeroed), so no load waits on an
// update. It scatters into its own slab of shared memory, [h][32] f32 zeroed in place
// (lane l only ever touches column l of its slab: no bank conflicts, no
// hazards between lanes). After a barrier the block adds each strip's slabs
// in segment order and writes each row of g_src once, coalesced, zeros
// included. The layout is chosen per launch from h, W and dlen
// (pbd_dt1d_bwd_strips, pbd_dt1d_bwd_segments): as many strips at once as
// there are (up to kMaxWarps and the slabs' budget kSlabBytes), then as
// many segments as the remaining warps allow, so that a map's strips run
// side by side instead of one after another. Maps too tall for even one
// slab take the kernel's global-memory path: one warp a map, strip after
// strip, each lane zeroing and accumulating its column of g_src in global
// memory in row order.
//
// Determinism: every sum has a fixed order, the same bits on every run.
// g_src[v, x] is segment 0's sum over its rows (ascending), plus segment
// 1's, and so on; g_a and g_b add per lane over the rounds in order and
// the rows of its segment in order, then over the lanes by a shuffle tree
// (lane l takes lane l + o, o = 16, 8, 4, 2, 1), then over the warps in
// order. Every operation is a round-to-nearest intrinsic, so nvcc cannot
// contract g*d*d into an FMA. ops/dt_cuda.py::dt1d_bwd_order_plain states
// that order in torch, and the card tests hold the kernel to it bit for
// bit.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>

namespace {

constexpr int kMaxWarps = 8;            // warps of a map's block at most
constexpr int kSlabBytes = 224 * 1024;  // shared memory the slabs may take
constexpr int kBatch = 4;               // rows a load batch takes

struct Layout {
  int strips;    // 32-column strips a round takes; 0: the global-memory path
  int segments;  // warps (row segments) per strip
};

Layout bwd_layout(int h, int w, int dlen) {
  const long long slab = 128LL * h;
  if (slab > kSlabBytes) return {0, 1};
  const int fit =
      static_cast<int>(std::min<long long>(kMaxWarps, kSlabBytes / slab));
  const int strips = std::min((w + 31) / 32, fit);
  return {strips, std::max(1, std::min(fit / strips, dlen))};
}

// kBatch consecutive output rows of one lane's column: g, out and ptr.
struct Batch {
  float g[kBatch];
  float out[kBatch];
  int ptr[kBatch];

  // rows i0.. (those at or beyond i_end, or outside the map, read as dead)
  __device__ __forceinline__ void load(const float* __restrict__ gp,
                                       const float* __restrict__ outp,
                                       const int* __restrict__ ptrp,
                                       size_t base, int w, int x, bool col,
                                       int i0, int i_end) {
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const bool ok = col && i0 + j < i_end;
      const size_t o = base + static_cast<size_t>(i0 + j) * w + x;
      g[j] = ok ? gp[o] : 0.0f;
      out[j] = ok ? outp[o] : -CUDART_INF_F;
      ptr[j] = ok ? ptrp[o] : 0;
    }
  }

  // adds each live row's g into cells[v* * pitch] and its g*d*d, g*d
  // into the lane's sums, in row order
  template <bool kHasAux>
  __device__ __forceinline__ void scatter(float* cells, int pitch, float sh,
                                          int step, int i0, float& acc_a,
                                          float& acc_b) const {
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (out[j] == -CUDART_INF_F) continue;  // dead, or outside the map
      const int v = kHasAux ? (ptr[j] & 0xFFF) : ptr[j];
      const float q = __fadd_rn(sh, static_cast<float>(step * (i0 + j)));
      const float d = __fsub_rn(q, static_cast<float>(v));
      const float gd = __fmul_rn(g[j], d);
      acc_b = __fadd_rn(acc_b, gd);
      acc_a = __fadd_rn(acc_a, __fmul_rn(gd, d));
      float* cell = cells + static_cast<size_t>(v) * pitch;
      *cell = __fadd_rn(*cell, g[j]);
    }
  }
};

template <bool kHasAux, bool kShared>
__global__ void __launch_bounds__(32 * kMaxWarps)
dt1d_axis2_bwd_kernel(const float* __restrict__ g, const float* __restrict__ out,
                      const int* __restrict__ ptr,
                      const float* __restrict__ shift,
                      float* __restrict__ g_src, float* __restrict__ g_a,
                      float* __restrict__ g_b, int h, int w, int dlen,
                      int step, int segments) {
  extern __shared__ float slabs[];  // [warps][h][32], kShared
  __shared__ float red_a[kMaxWarps];
  __shared__ float red_b[kMaxWarps];
  const int m = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int k = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int strips = warps / segments;  // strips a round takes
  const int t = k / segments;           // the warp's strip in the round
  const int seg = (dlen + segments - 1) / segments;
  const int i_begin = min((k % segments) * seg, dlen);
  const int i_end = min(i_begin + seg, dlen);
  const float sh = shift[m];
  const size_t in_base = static_cast<size_t>(m) * dlen * w;
  float* gs = g_src + static_cast<size_t>(m) * h * w;
  const size_t slab_size = static_cast<size_t>(h) * 32;
  float acc_a = 0.0f;
  float acc_b = 0.0f;
  for (int r0 = 0; r0 < w; r0 += 32 * strips) {  // a round of strips
    const int x = r0 + 32 * t + lane;
    const bool col = x < w;
    // the cells this lane accumulates into: column `lane` of the warp's
    // slab, or column x of g_src
    float* cells = kShared ? slabs + k * slab_size + lane : gs + x;
    const int pitch = kShared ? 32 : w;
    // two batches of rows in flight: the next one's loads are issued
    // before this one's scatter, and the first one's before the zeroing
    Batch a, b;
    a.load(g, out, ptr, in_base, w, x, col, i_begin, i_end);
    if (kShared || col) {
      for (int v = 0; v < h; ++v) cells[static_cast<size_t>(v) * pitch] = 0.0f;
    }
    for (int ib = i_begin; ib < i_end; ib += 2 * kBatch) {
      b.load(g, out, ptr, in_base, w, x, col, ib + kBatch, i_end);
      a.scatter<kHasAux>(cells, pitch, sh, step, ib, acc_a, acc_b);
      a.load(g, out, ptr, in_base, w, x, col, ib + 2 * kBatch, i_end);
      b.scatter<kHasAux>(cells, pitch, sh, step, ib + kBatch, acc_a, acc_b);
    }
    if (kShared) {
      __syncthreads();  // every warp's slab is complete
      // the round's cells, strip by strip: segment 0's slab, plus 1's, ...
      for (int ts = 0; ts < strips; ++ts) {
        const float* strip = slabs + ts * segments * slab_size;
        const int xc = r0 + 32 * ts + lane;
        for (int c = threadIdx.x; c < h * 32; c += blockDim.x) {
          float s = strip[c];
          for (int j = 1; j < segments; ++j) s = __fadd_rn(s, strip[j * slab_size + c]);
          if (xc < w) gs[static_cast<size_t>(c >> 5) * w + xc] = s;
        }
      }
      __syncthreads();  // the slabs are read until here
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    acc_a = __fadd_rn(acc_a, __shfl_down_sync(0xffffffffu, acc_a, o));
    acc_b = __fadd_rn(acc_b, __shfl_down_sync(0xffffffffu, acc_b, o));
  }
  if (lane == 0) {
    red_a[k] = acc_a;
    red_b[k] = acc_b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ta = red_a[0];
    float tb = red_b[0];
    for (int kk = 1; kk < warps; ++kk) {
      ta = __fadd_rn(ta, red_a[kk]);
      tb = __fadd_rn(tb, red_b[kk]);
    }
    g_a[m] = ta;
    g_b[m] = tb;
  }
}

template <bool kHasAux>
int launch(const float* g, const float* out, const int* ptr, const float* shift,
           float* g_src, float* g_a, float* g_b, int batch, int h, int w,
           int dlen, int step, cudaStream_t stream) {
  const Layout lay = bwd_layout(h, w, dlen);
  if (lay.strips == 0) {
    dt1d_axis2_bwd_kernel<kHasAux, false><<<batch, 32, 0, stream>>>(
        g, out, ptr, shift, g_src, g_a, g_b, h, w, dlen, step, 1);
    return static_cast<int>(cudaGetLastError());
  }
  const int warps = lay.strips * lay.segments;
  const size_t smem = static_cast<size_t>(warps) * h * 32 * sizeof(float);
  auto kernel = dt1d_axis2_bwd_kernel<kHasAux, true>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<batch, 32 * warps, smem, stream>>>(g, out, ptr, shift, g_src, g_a,
                                             g_b, h, w, dlen, step,
                                             lay.segments);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The block's layout for maps of h source rows, W columns and dlen output
// rows, which sets the order of the sums (ops/dt_cuda.py::dt1d_bwd_layout,
// dt1d_bwd_order_plain): the strips a round takes (0 where the
// global-memory path runs, strip after strip in one warp), and the row
// segments (warps) per strip.
extern "C" int pbd_dt1d_bwd_strips(int h, int w, int dlen) {
  return h > 0 && w > 0 && dlen > 0 ? bwd_layout(h, w, dlen).strips : 0;
}
extern "C" int pbd_dt1d_bwd_segments(int h, int w, int dlen) {
  return h > 0 && w > 0 && dlen > 0 ? bwd_layout(h, w, dlen).segments : 1;
}

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
  return has_aux ? launch<true>(g, out, ptr, shift, g_src, g_a, g_b, batch, h,
                                w, dlen, step, s)
                 : launch<false>(g, out, ptr, shift, g_src, g_a, g_b, batch,
                                 h, w, dlen, step, s);
}
