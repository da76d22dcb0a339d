// Filter-bank valid correlation on the tensor cores in 3xTF32, for sm_90a.
//
// Replaces partsbaseddetector_tpu/ops/conv_pallas.py::_conv_kernel (K2, run by
// filter_responses_pallas / filter_responses_infer):
//   out[s, y, x, f] = sum_{i < fh, j < fw, c < C} feat[s, y+i, x+j, c] * filt[f, i, j, c]
// with features (S, H, W, C), the filter bank in its own layout (F, fh, fw, C)
// and out (S, H-fh+1, W-fw+1, F), all contiguous: no padded weight copy, no
// output copy.
//
// The core (csrc/conv_core.cuh) is an implicit GEMM on mma.sync.m16n8k8 with
// each f32 operand split into two TF32 pieces (three exact products
// per pair, f32 accumulation, one rounded FADD per tap into the output's
// accumulator); it states the error argument and the bound. A block owns
// kRows x 128/kRows output positions of one scale; both operands are staged
// K-major, the feature patch as [position][c] straight from (S, H, W, C) and
// each tap's filter slice as [filter][c] straight from the bank, by
// cp.async, the filter slices through a ring. The bank is constant per
// detector, so its split into TF32 pieces, (2, F, fh, fw, C), is made once
// when the model goes to the card (models/model.py::to_device); the
// features are split once per block in shared memory. One launch takes
// every bucket of a detect (a list of feature stacks, one bank).

#include "conv_core.cuh"

extern "C" long long pbd_conv_smem_bytes(int c, int fh, int fw, int f) {
  int nt, nblocks;
  pbd_conv::n_tiling(f, &nt, &nblocks);
  return pbd_conv::smem_bytes(c, fh, fw, pbd_conv::kRows,
                              pbd_conv::block_cols(c, fh, fw, pbd_conv::kRows, nt), nt);
}

extern "C" int pbd_conv_max_groups() { return pbd_conv::kMaxGroups; }

// n <= pbd_conv_max_groups() correlations with one filter bank in one
// launch: feats[i] (s[i], h[i], w[i], C) f32 -> outs[i] (s[i], h[i]-fh+1,
// w[i]-fw+1, F) f32, filt (2, F, fh, fw, C) f32, the bank split into its
// TF32 big and small pieces (ops/conv.py::split_tf32); tensors contiguous
// and 16-byte aligned on the current device, the pointer and size arrays
// in host memory. Each group's output has the bits that group gives in a
// launch of its own (n = 1). Returns a CUDA error code
// (cudaGetLastError() after the launch).
extern "C" int pbd_conv_3xtf32_grouped(const float* const* feats, float* const* outs,
                                       const int* s, const int* h, const int* w, int n,
                                       const float* filt, int c, int f, int fh, int fw,
                                       void* stream) {
  return pbd_conv::launch_grouped(feats, outs, s, h, w, n, filt, c, f, fh, fw, stream);
}
