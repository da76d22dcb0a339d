// Adaptive-window 1-D generalized distance transform along axis -2, f32,
// step 1, for sm_90a.
//
// Replaces K5 of partsbaseddetector_tpu/ops/pallas_dt.py: _make_window_kernel
// (run by _dt1d_pallas_window / dt1d_pallas under PBD_DT_WINDOW=1). The TPU
// kernel laid output positions on lanes over an anchor-aligned slab and ran
// one while-loop per 128-lane tile until every lane could stop scanning
// outward from q. Here it is K1's core (csrc/dt1d_core.cuh) in its window
// form: for map b, output row i and column w with i < out_valid[b, w], the
// value and pointer of K1 (csrc/dt1d.cu) at step 1, bit for bit; outputs at
// i >= out_valid[b, w] are don't-care for the caller (masked downstream) and
// are written (-inf, 0), as dt_cuda.py::dt1d_window_plain does.
//
// What the window buys on the card is what out_valid lets the core skip:
// only a thread's live rows set its seed, threshold and displacement
// interval (a tighter prune than K1's), a warp without a live row evaluates
// nothing, and a block without one writes its outputs and stops. The
// outward scan with a per-thread exit that this kernel used to run diverged
// within warps and re-read every source from global memory; the chunk prune
// over staged sources subsumes its exit bound (the column's maximum).

#include "dt1d_core.cuh"

// src (B, H, W) f32, aux (B, H, W) i32 or null, a/b/shift (B,) f32 (shift
// integral), nvalid (B,) i32, out_valid (B, W) i32 -> out (B, dlen, W) f32,
// ptr (B, dlen, W) i32. All contiguous on the current device. Returns
// cudaGetLastError().
extern "C" int pbd_dt1d_window_axis2_f32(const float* src, const int* aux,
                                         const float* a, const float* b,
                                         const float* shift, const int* nvalid,
                                         const int* out_valid, float* out,
                                         int* ptr, int batch, int h, int w,
                                         int dlen, void* stream) {
  return pbd_dt::dispatch<pbd_dt::dt1d_window>(src, aux, a, b, shift, nvalid, out_valid, out,
                                ptr, batch, h, w, dlen, 1, stream);
}
