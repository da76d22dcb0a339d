// The filter-bank correlation core of K2 (csrc/conv.cu) and T1
// (csrc/conv_proto.cu): an implicit GEMM on Hopper's tensor cores in
// 3xTF32, for sm_90a.
//
//   out[s, y, x, f] = sum_{i < fh, j < fw, c < C} feat[s, y+i, x+j, c] * filt[f, i, j, c]
//
// M is a block's output positions, N its filters, K the fh*fw taps of C
// channels, walked tap by tap in k8 steps.
//
// Arithmetic (the f32 contract, Precision.HIGHEST, without single-pass
// TF32). Each f32 operand x is split into big = rna_tf32(x) and small =
// rna_tf32(x - big): the feature patch once per block in shared memory,
// the filter bank once per model (ops/conv_cuda.py::split_bank). x -
// big is exact and |x - big - small| <= 2^-22 |x|. A product is big*big +
// big*small + small*big: each partial product of two TF32 values is exact
// in f32; the dropped small*small and the split errors stay below
// 3 * 2^-22 |x*w|. mma.sync.m16n8k8 adds them into an f32 tile, small
// terms first. The tensor core truncates its f32 sums: on an H100, all 25
// taps of a 5x5 bank summed straight into one accumulator erred up to
// 1.04x the rule on positive terms (tools/kernel_variants.py). So each
// tap's 3 * Cp/8 products accumulate in a fresh register tile, which one
// rounded FADD then adds to the output's accumulator: truncation acts on
// one tap's sum, never on the running total (0.08x the rule on the same
// terms). The rule is 1e-5 *
// sum|x*w|; ops/conv.py::filter_responses_3xtf32_plain states it in torch.
// Every output sums its taps in (i, j) order and its channels in k8 steps,
// whatever the block tiling, the inputs' layout or the launch, so K2, T1
// and the grouped launch give the same bits, and a map gives the same bits
// in any batch.
//
// Tiling: 8 warps, 4 along M x 2 along N; a warp owns kMT = 2 m16 tiles
// (32 positions) x NT n8 tiles; a block 128 positions (toh rows x tw =
// 128/toh columns of one map) x 16*NT filters, NT = 1..8 (F = 104 is 13 n8
// tiles: one block of NT = 7 covers it, 8 columns of padding). The halo
// patch, (toh+fh-1) x (tw+fw-1) positions x C channels, is staged once per
// block and split in place; each tap's filter slice (big and small) goes
// through a ring of kStages buffers by cp.async, its copies' offsets worked
// out once per block, so the next tap's loads overlap this tap's products.
// Both operands are K-major in shared memory, [position][c] and [filter][c]
// with a row stride of Cp + 4 floats (Cp = C rounded up to 8, zeros past
// C), and reach registers by ldmatrix (each 32-bit value two b16 halves):
// the 8 rows of 16 bytes of each 8x8 matrix then fall in 32 different
// banks. On an H100 a wgmma version of the same core (A from registers, B
// by descriptor) measured no faster and was deleted (PERF.md).
//
// Bound at the person26 VGA table shape (S = 5, 130x170x32 features, 104
// filters of 5x5): 17.40 GFLOP of useful work; in 3xTF32 that is 52.2
// GFLOP of TF32 (0.1055 ms at 495 TFLOP/s) against 57.98 MB of inputs and
// output (0.0173 ms at 3.35 TB/s): the tensor cores bound it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pbd_conv {

constexpr int kWarpsM = 4;
constexpr int kWarpsN = 2;
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kMT = 2;                       // m16 tiles per warp
constexpr int kPos = kWarpsM * kMT * 16;     // output positions per block
constexpr int kMaxNT = 8;                    // n8 tiles per warp, at most
constexpr int kStages = 2;                   // filter-slice ring depth
constexpr int kRows = 8;                     // K2's output rows per block

__host__ __device__ inline int padded_channels(int c) { return (c + 7) / 8 * 8; }
__host__ __device__ inline int row_stride(int c) { return padded_channels(c) + 4; }

// Dynamic shared memory of one block of toh x tw positions, in bytes.
__host__ inline long long smem_bytes(int c, int fh, int fw, int toh, int tw, int nt) {
  const long long patch =
      2LL * (toh + fh - 1) * (tw + fw - 1) * row_stride(c);  // big, small
  const long long filt = static_cast<long long>(kStages) * 2 * 16 * nt * row_stride(c);
  return (patch + filt) * static_cast<long long>(sizeof(float));
}

// The columns of a block of toh rows: kPos / toh, halved while the block
// would not fit in 227 KB of shared memory (a one-row block's wide halo
// patch); positions past toh * tw are idle.
__host__ inline int block_cols(int c, int fh, int fw, int toh, int nt) {
  int tw = kPos / toh;
  while (tw > 8 && smem_bytes(c, fh, fw, toh, tw, nt) > 227 * 1024) tw /= 2;
  return tw;
}

// n8 tiles per warp for f filters, and the blocks along N.
__host__ inline void n_tiling(int f, int* nt, int* nblocks) {
  const int n8 = (f + 7) / 8;
  *nblocks = (n8 + kWarpsN * kMaxNT - 1) / (kWarpsN * kMaxNT);
  *nt = (n8 + kWarpsN * *nblocks - 1) / (kWarpsN * *nblocks);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, or zeros where valid is false (src-size 0 reads nothing)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// x = big + small + O(2^-22 |x|), big and small TF32 (low 13 bits zero),
// each rounded to nearest with ties away from zero.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  uint32_t b, s;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(b) : "f"(x));
  b &= 0xffffe000u;
  const float rest = __fsub_rn(x, __uint_as_float(b));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(s) : "f"(rest));
  big = b;
  small = s & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Where the inputs come from. kT1 = false: K2's features (S, H, W, C) and
// its filter bank (F, fh, fw, C). kT1 = true: T1's features (S, H, C, W)
// and K-major weights w2 (fh*fw*C, fp), transposed to [.][c] while staged.
struct Args {
  const float* feat;
  const float* filt;  // the split bank: big, then small at small_off
  float* out;         // (S, oh, ow, f)
  int h, w, c, fh, fw, f, fp, oh, ow, toh, tw;
  long long small_off;
};

template <bool kT1>
__device__ __forceinline__ void stage_patch(const Args& a, float* patch, int s,
                                            int y0, int x0) {
  const int ph = a.toh + a.fh - 1, pw = a.tw + a.fw - 1;
  const int cs = row_stride(a.c);
  const int cp = padded_channels(a.c);
  if (!kT1 && a.c % 4 == 0) {
    const float* fs = a.feat + static_cast<size_t>(s) * a.h * a.w * a.c;
    const int q4 = a.c / 4;
    for (int idx = threadIdx.x; idx < ph * pw * q4; idx += kThreads) {
      const int q = idx % q4, pos = idx / q4;
      const int y = y0 + pos / pw, x = x0 + pos % pw;
      const bool ok = y < a.h && x < a.w;
      cp_async16(patch + pos * cs + 4 * q,
                 ok ? fs + (static_cast<size_t>(y) * a.w + x) * a.c + 4 * q : fs, ok);
    }
  } else if (!kT1) {
    const float* fs = a.feat + static_cast<size_t>(s) * a.h * a.w * a.c;
    for (int idx = threadIdx.x; idx < ph * pw * a.c; idx += kThreads) {
      const int ch = idx % a.c, pos = idx / a.c;
      const int y = y0 + pos / pw, x = x0 + pos % pw;
      const bool ok = y < a.h && x < a.w;
      cp_async4(patch + pos * cs + ch,
                ok ? fs + (static_cast<size_t>(y) * a.w + x) * a.c + ch : fs, ok);
    }
  } else {
    // (S, H, C, W): neighbouring threads read neighbouring columns
    const float* fs = a.feat + static_cast<size_t>(s) * a.h * a.c * a.w;
    for (int idx = threadIdx.x; idx < ph * a.c * pw; idx += kThreads) {
      const int col = idx % pw, rc = idx / pw;
      const int ch = rc % a.c, r = rc / a.c;
      const int y = y0 + r, x = x0 + col;
      const bool ok = y < a.h && x < a.w;
      cp_async4(patch + (r * pw + col) * cs + ch,
                ok ? fs + (static_cast<size_t>(y) * a.c + ch) * a.w + x : fs, ok);
    }
  }
  // channels C..Cp-1 stay zero
  for (int idx = threadIdx.x; idx < ph * pw * (cp - a.c); idx += kThreads) {
    const int k = idx % (cp - a.c), pos = idx / (cp - a.c);
    patch[pos * cs + a.c + k] = 0.0f;
  }
}

// A thread's 16-byte copies of one tap's filter slice, worked out once per
// block: source offsets at tap 0 (a tap adds tap * C) and destinations.
// The general loops below divide by runtime sizes for every copy of every
// tap; with these offsets a tap costs its copies alone.
constexpr int kMaxChunks = 4;

struct Stager {
  bool fast;
  int n;
  int src[kMaxChunks], dst[kMaxChunks];
};

template <bool kT1>
__device__ __forceinline__ Stager make_stager(const Args& a, int f0, int bn) {
  Stager st{};
  const int q4 = a.c / 4;
  const int nf = min(bn, a.f - f0);
  st.fast = !kT1 && a.c % 4 == 0 && nf * q4 <= kMaxChunks * kThreads;
  if (!st.fast) return st;
  const int cs = row_stride(a.c);
  st.n = 0;
#pragma unroll
  for (int j = 0; j < kMaxChunks; ++j) {
    const int idx = threadIdx.x + j * kThreads;
    if (idx < nf * q4) {
      const int q = idx % q4, n = idx / q4;
      st.src[j] = (f0 + n) * a.fh * a.fw * a.c + 4 * q;
      st.dst[j] = n * cs + 4 * q;
      st.n = j + 1;
    }
  }
  return st;
}

// One tap's slice of the split bank, big then small, each bn x cs floats.
template <bool kT1>
__device__ __forceinline__ void stage_filters(const Args& a, const Stager& st, float* dst,
                                              int tap, int f0, int bn) {
  const int cs = row_stride(a.c);
  const int nf = min(bn, a.f - f0);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float* src = a.filt + half * a.small_off;
    float* d = dst + half * bn * cs;
    if (st.fast) {
      const float* t = src + tap * a.c;
#pragma unroll
      for (int j = 0; j < kMaxChunks; ++j)
        if (j < st.n) cp_async16(d + st.dst[j], t + st.src[j], true);
    } else if (!kT1 && a.c % 4 == 0) {
      const int q4 = a.c / 4;
      for (int idx = threadIdx.x; idx < nf * q4; idx += kThreads) {
        const int q = idx % q4, n = idx / q4;
        cp_async16(d + n * cs + 4 * q,
                   src + (static_cast<size_t>(f0 + n) * a.fh * a.fw + tap) * a.c + 4 * q,
                   true);
      }
    } else if (!kT1) {
      for (int idx = threadIdx.x; idx < nf * a.c; idx += kThreads) {
        const int ch = idx % a.c, n = idx / a.c;
        cp_async4(d + n * cs + ch,
                  src + (static_cast<size_t>(f0 + n) * a.fh * a.fw + tap) * a.c + ch, true);
      }
    } else {
      // w2 row (tap*C + c) holds the filters along its fp columns
      for (int idx = threadIdx.x; idx < a.c * nf; idx += kThreads) {
        const int n = idx % nf, ch = idx / nf;
        cp_async4(d + n * cs + ch,
                  src + static_cast<size_t>(tap * a.c + ch) * a.fp + f0 + n, true);
      }
    }
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1, const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p)));
}

// One block's work: output tile `tile` (row-major over the map's
// toh x tw tiles) of map s, filters from nblk * 16 * NT.
template <int NT, bool kT1>
__device__ __forceinline__ void conv_block(const Args& a, int tile, int nblk, int s,
                                           float* smem) {
  const int cs = row_stride(a.c);
  const int cp = padded_channels(a.c);
  const int pw = a.tw + a.fw - 1;
  constexpr int kBN = 16 * NT;
  constexpr int kSlice = 2 * kBN;  // rows of one ring buffer: big, then small
  const int patch_floats = (a.toh + a.fh - 1) * pw * cs;
  float* patch = smem;                         // big pieces, [position][cs]
  float* patch_small = smem + patch_floats;    // small pieces
  float* ring = smem + 2 * patch_floats;       // kStages x [kSlice][cs]

  const int tiles_x = (a.ow + a.tw - 1) / a.tw;
  const int x0 = (tile % tiles_x) * a.tw;
  const int y0 = (tile / tiles_x) * a.toh;
  const int f0 = nblk * kBN;
  const int taps = a.fh * a.fw;

  // zeros where no filter or channel is staged: filters past F, channels
  // C..Cp-1 (the ring's staged entries never touch them)
  const int nf = min(kBN, a.f - f0);
  for (int idx = threadIdx.x; idx < kStages * 2 * (kBN - nf) * cp; idx += kThreads) {
    const int ch = idx % cp, r = idx / cp;  // rows nf.. of each of the 2 kStages slices
    const int n = nf + r % (kBN - nf), half = r / (kBN - nf);
    ring[half * kBN * cs + n * cs + ch] = 0.0f;
  }
  for (int idx = threadIdx.x; idx < kStages * 2 * nf * (cp - a.c); idx += kThreads) {
    const int ch = a.c + idx % (cp - a.c), r = idx / (cp - a.c);
    const int n = r % nf, half = r / nf;
    ring[half * kBN * cs + n * cs + ch] = 0.0f;
  }
  const Stager st = make_stager<kT1>(a, f0, kBN);
  stage_patch<kT1>(a, patch, s, y0, x0);
  cp_async_commit();
#pragma unroll
  for (int stage = 0; stage < kStages - 1; ++stage) {
    if (stage < taps) stage_filters<kT1>(a, st, ring + stage * kSlice * cs, stage, f0, kBN);
    cp_async_commit();
  }
  // split the patch once, in place: every element feeds fh*fw taps of
  // two warps, so splitting it here, not per k8 step, saves most of the
  // conversions
  cp_async_wait<kStages - 1>();
  __syncthreads();
  for (int idx = threadIdx.x; idx < patch_floats; idx += kThreads) {
    uint32_t big, small;
    split_tf32(patch[idx], big, small);
    patch[idx] = __uint_as_float(big);
    patch_small[idx] = __uint_as_float(small);
  }

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tg = lane % 4;
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;
  const int npos = a.toh * a.tw;
  // ldmatrix: lane l addresses row l % 8 of 8x8 matrix l / 8. For A (m16 x
  // k8) matrix m is rows (m & 1) * 8.., channels (m >> 1) * 4..: a0..a3.
  // For B (n8 x k8 per tile) matrix m is tile (m >> 1), channels
  // (m & 1) * 4..: b0, b1 of two n8 tiles.
  const int lm = lane / 8, lr = lane % 8;
  int abase[kMT];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    const int p = (wm * kMT + mt) * 16 + (lm & 1) * 8 + lr;
    abase[mt] = (p < npos ? ((p / a.tw) * pw + p % a.tw) * cs : 0) + (lm >> 1) * 4;
  }
  const int bbase = (wn * 8 * NT + (lm >> 1) * 8 + lr) * cs + (lm & 1) * 4;
  const int bbase2 = (wn * 8 * NT + lr) * cs + (lm & 1) * 4;  // .x2: one tile

  float acc[kMT][NT][4], part[kMT][NT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.0f;

  for (int tap = 0; tap < taps; ++tap) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this tap's slice (and the patch) landed; the
                      // buffer refilled below was consumed last tap
    const int next = tap + kStages - 1;
    if (next < taps)
      stage_filters<kT1>(a, st, ring + (next % kStages) * kSlice * cs, next, f0, kBN);
    cp_async_commit();

    const float* big = ring + (tap % kStages) * kSlice * cs;
    const float* small = big + kBN * cs;
    const int toff = ((tap / a.fw) * pw + tap % a.fw) * cs;
    // the tap's products go to a fresh tile `part`, then one rounded add
    // per output into the running total
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[mt][nt][q] = 0.0f;
    for (int k0 = 0; k0 < cp; k0 += 8) {
      uint32_t ab[kMT][4], as[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        ldsm_x4(ab[mt], patch + abase[mt] + toff + k0);
        ldsm_x4(as[mt], patch_small + abase[mt] + toff + k0);
      }
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t bb[4], bs[4];
        if (nt + 1 < NT) {
          ldsm_x4(bb, big + bbase + nt * 8 * cs + k0);
          ldsm_x4(bs, small + bbase + nt * 8 * cs + k0);
        } else {
          ldsm_x2(bb[0], bb[1], big + bbase2 + nt * 8 * cs + k0);
          ldsm_x2(bs[0], bs[1], small + bbase2 + nt * 8 * cs + k0);
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (nt + u >= NT) break;
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            mma_tf32(part[mt][nt + u], as[mt], bb[2 * u], bb[2 * u + 1]);
            mma_tf32(part[mt][nt + u], ab[mt], bs[2 * u], bs[2 * u + 1]);
            mma_tf32(part[mt][nt + u], ab[mt], bb[2 * u], bb[2 * u + 1]);
          }
        }
      }
    }
    {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[mt][nt][q] = __fadd_rn(acc[mt][nt][q], part[mt][nt][q]);
    }
  }

  // c0, c1 at (row g, filters 2tg, 2tg+1); c2, c3 at row g + 8
  const bool pairs = a.f % 2 == 0;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int p = (wm * kMT + mt) * 16 + hf * 8 + g;
      const int y = y0 + p / a.tw, x = x0 + p % a.tw;
      if (p >= npos || y >= a.oh || x >= a.ow) continue;
      float* row = a.out + ((static_cast<size_t>(s) * a.oh + y) * a.ow + x) * a.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = f0 + wn * 8 * NT + nt * 8 + 2 * tg;
        const float v0 = acc[mt][nt][2 * hf], v1 = acc[mt][nt][2 * hf + 1];
        if (pairs && n + 1 < a.f) {
          *reinterpret_cast<float2*>(row + n) = make_float2(v0, v1);
        } else {
          if (n < a.f) row[n] = v0;
          if (n + 1 < a.f) row[n + 1] = v1;
        }
      }
    }
}

// T1: one launch over (tile, filter block, map).
template <int NT>
__global__ void __launch_bounds__(kThreads, 1) conv3xtf32_t1_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  conv_block<NT, true>(a, blockIdx.x, blockIdx.y, blockIdx.z, smem);
}

// Up to kMaxGroups correlations with one filter bank in one launch (a
// detect's buckets): blockIdx.x walks group 0's (map, tile) blocks, then
// group 1's, and so on; each group's outputs are the bits a launch of its
// own gives.
constexpr int kMaxGroups = 16;

struct Groups {
  Args common;  // c, fh, fw, f, fp, toh, tw, filt
  int n;
  int start[kMaxGroups + 1];  // first block of each group, then the total
  const float* feat[kMaxGroups];
  float* out[kMaxGroups];
  int h[kMaxGroups], w[kMaxGroups];
};

template <int NT>
__global__ void __launch_bounds__(kThreads, 1) conv3xtf32_grouped_kernel(const Groups g) {
  extern __shared__ __align__(16) float smem[];
  int k = 0;
  while (k + 1 < g.n && static_cast<int>(blockIdx.x) >= g.start[k + 1]) ++k;
  Args a = g.common;
  a.feat = g.feat[k];
  a.out = g.out[k];
  a.h = g.h[k];
  a.w = g.w[k];
  a.oh = a.h - a.fh + 1;
  a.ow = a.w - a.fw + 1;
  const int tiles = ((a.oh + a.toh - 1) / a.toh) * ((a.ow + a.tw - 1) / a.tw);
  const int local = blockIdx.x - g.start[k];
  conv_block<NT, false>(a, local % tiles, blockIdx.y, local / tiles, smem);
}

template <int NT>
inline int launch_t1_nt(const Args& a, int s, int nblocks, cudaStream_t stream) {
  const long long smem = smem_bytes(a.c, a.fh, a.fw, a.toh, a.tw, NT);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncSetAttribute(
      conv3xtf32_t1_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long tiles = static_cast<long long>((a.oh + a.toh - 1) / a.toh) *
                          ((a.ow + a.tw - 1) / a.tw);
  if (tiles > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles), nblocks, s);
  conv3xtf32_t1_kernel<NT><<<grid, kThreads, static_cast<size_t>(smem), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// T1's launch: checks the shapes, picks NT for a.f and launches. Returns a
// CUDA error code (cudaErrorInvalidValue for shapes the kernel does not take).
inline int launch_t1(Args a, int s, void* stream) {
  a.oh = a.h - a.fh + 1;
  a.ow = a.w - a.fw + 1;
  if (s <= 0 || s > 65535 || a.c <= 0 || a.fh <= 0 || a.fw <= 0 || a.oh <= 0 ||
      a.ow <= 0 || a.f <= 0 || a.toh < 1 || a.toh > kPos) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int nt, nblocks;
  n_tiling(a.f, &nt, &nblocks);
  a.tw = block_cols(a.c, a.fh, a.fw, a.toh, nt);
  if (nblocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nt) {
    case 1: return launch_t1_nt<1>(a, s, nblocks, st);
    case 2: return launch_t1_nt<2>(a, s, nblocks, st);
    case 3: return launch_t1_nt<3>(a, s, nblocks, st);
    case 4: return launch_t1_nt<4>(a, s, nblocks, st);
    case 5: return launch_t1_nt<5>(a, s, nblocks, st);
    case 6: return launch_t1_nt<6>(a, s, nblocks, st);
    case 7: return launch_t1_nt<7>(a, s, nblocks, st);
    default: return launch_t1_nt<8>(a, s, nblocks, st);
  }
}

template <int NT>
inline int launch_grouped_nt(const Groups& g, int nblocks, cudaStream_t stream) {
  const long long smem =
      smem_bytes(g.common.c, g.common.fh, g.common.fw, g.common.toh, g.common.tw, NT);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncSetAttribute(
      conv3xtf32_grouped_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(g.start[g.n], nblocks, 1);
  conv3xtf32_grouped_kernel<NT><<<grid, kThreads, static_cast<size_t>(smem), stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

// K2 over n <= kMaxGroups feature stacks (group i: s[i] maps of h[i] x
// w[i], all with c channels) and one filter bank, in one launch.
inline int launch_grouped(const float* const* feats, float* const* outs, const int* s,
                          const int* h, const int* w, int n, const float* filt, int c,
                          int f, int fh, int fw, void* stream) {
  if (n <= 0 || n > kMaxGroups || c <= 0 || f <= 0 || fh <= 0 || fw <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Groups g{};
  int nt, nblocks;
  n_tiling(f, &nt, &nblocks);
  if (nblocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  g.common = Args{nullptr, filt, nullptr, 0, 0, c, fh, fw, f, f, 0, 0, kRows,
                  block_cols(c, fh, fw, kRows, nt), static_cast<long long>(f) * fh * fw * c};
  g.n = n;
  long long total = 0;
  for (int i = 0; i < n; ++i) {
    const int oh = h[i] - fh + 1, ow = w[i] - fw + 1;
    if (s[i] <= 0 || oh <= 0 || ow <= 0) return static_cast<int>(cudaErrorInvalidValue);
    g.start[i] = static_cast<int>(total);
    total += static_cast<long long>(s[i]) * ((oh + kRows - 1) / kRows) *
             ((ow + g.common.tw - 1) / g.common.tw);
    if (total > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    g.feat[i] = feats[i];
    g.out[i] = outs[i];
    g.h[i] = h[i];
    g.w[i] = w[i];
  }
  g.start[n] = static_cast<int>(total);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nt) {
    case 1: return launch_grouped_nt<1>(g, nblocks, st);
    case 2: return launch_grouped_nt<2>(g, nblocks, st);
    case 3: return launch_grouped_nt<3>(g, nblocks, st);
    case 4: return launch_grouped_nt<4>(g, nblocks, st);
    case 5: return launch_grouped_nt<5>(g, nblocks, st);
    case 6: return launch_grouped_nt<6>(g, nblocks, st);
    case 7: return launch_grouped_nt<7>(g, nblocks, st);
    default: return launch_grouped_nt<8>(g, nblocks, st);
  }
}

}  // namespace pbd_conv
