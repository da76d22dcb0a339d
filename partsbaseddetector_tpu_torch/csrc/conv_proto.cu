// Explicit-layout filter-bank correlation on K2's 3xTF32 core, for sm_90a.
//
// Replaces tools/conv_pallas_proto.py::kernel (T1, launched by conv_pallas
// through pl.pallas_call), the prototype of K2:
//   out[s, y, x, f] = sum_{i < fh, j < fw, c < C}
//                     feat_t[s, y+i, c, x+j] * w2[(i*fw + j)*C + c, f]
// from T1's own layouts: features pre-transposed to (S, H, C, W), so that one
// (scale, row) is one contiguous C x W run, and the K-major weight matrix w2
// (K = fh*fw*C, FP), FP >= F, columns past F ignored. out is (S, OH, OW, F),
// OH = H-fh+1, OW = W-fw+1, written directly.
//
// Design: the core of csrc/conv.cu (csrc/conv_core.cuh: mma.sync.m16n8k8 in
// 3xTF32, K-major operands in shared memory, a cp.async ring of filter slices
// of the weights split once into TF32 pieces by the wrapper),
// fed from T1's layouts: the patch is transposed from [row][c][col] to
// [row][col][c] and each tap's C rows of w2 to [filter][c] while they are
// staged (4-byte cp.async, neighbouring threads on neighbouring global words).
// A block owns `toh` output rows x 128/toh columns (1 <= toh <= 128, a
// runtime knob; positions past OH, OW or toh*(128/toh) are never stored). Every
// output sums the same products in the same order as K2 whatever toh is, so
// T1 equals K2 bit for bit. T1's padding of H to NOH*TOH + FH - 1 rows is not
// needed. Bound: as K2's (conv_core.cuh), 16.44 GFLOP at T1's default shapes
// (S = 5, 126x166x32, F = 104 of 5x5): 0.0997 ms of TF32 at 495 TFLOP/s in
// 3xTF32, 0.2454 ms in FP32.

#include "conv_core.cuh"

extern "C" int pbd_conv_proto_max_toh() { return pbd_conv::kPos; }

// Dynamic shared memory of one block, in bytes.
extern "C" long long pbd_conv_proto_smem_bytes(int c, int fh, int fw, int f,
                                               int toh) {
  int nt, nblocks;
  pbd_conv::n_tiling(f, &nt, &nblocks);
  return pbd_conv::smem_bytes(c, fh, fw, toh, pbd_conv::block_cols(c, fh, fw, toh, nt), nt);
}

// feat_t (S, H, C, W) f32, w2 (2, fh*fw*C, FP) f32, the weights split into
// their TF32 big and small pieces -> out (S, H-fh+1, W-fw+1, F)
// f32, all contiguous on the current device; F <= FP and
// 1 <= toh <= 128. Returns a CUDA error code.
extern "C" int pbd_conv_proto_3xtf32(const float* feat, const float* w2,
                                     float* out, int s, int h, int c, int w,
                                     int fh, int fw, int f, int fp, int toh,
                                     void* stream) {
  if (f > fp) return static_cast<int>(cudaErrorInvalidValue);
  pbd_conv::Args a{feat, w2, out, h, w, c, fh, fw, f, fp, 0, 0, toh, 0,
                   static_cast<long long>(fh) * fw * c * fp};
  return pbd_conv::launch_t1(a, s, stream);
}
