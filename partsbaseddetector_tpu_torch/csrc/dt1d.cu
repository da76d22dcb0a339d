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
// The kernel is the core of csrc/dt1d_core.cuh (staged sources, register-
// blocked rows, shared penalties, exact chunk pruning), which states the
// function, its rounding and its bounds; this file is its K1 entry, exact at
// every output.

#include "dt1d_core.cuh"

// The output rows a thread owns and the source rows of a chunk: the run and
// chunk sizes of the pruning rule (ops/dt_cuda.py::dt1d_chunk_keep_plain).
extern "C" int pbd_dt1d_rows() { return pbd_dt::kR; }
extern "C" int pbd_dt1d_chunk() { return pbd_dt::kV; }

// src (B, H, W) f32, aux (B, H, W) i32 or null, a/b/shift (B,) f32,
// nvalid (B,) i32 -> out (B, dlen, W) f32, ptr (B, dlen, W) i32.
// All contiguous on the current device. Returns cudaGetLastError().
extern "C" int pbd_dt1d_axis2_f32(const float* src, const int* aux,
                                  const float* a, const float* b,
                                  const float* shift, const int* nvalid,
                                  float* out, int* ptr, int batch, int h,
                                  int w, int dlen, int step, void* stream) {
  return pbd_dt::dispatch<pbd_dt::dt1d_exact>(src, aux, a, b, shift, nvalid, nullptr, out,
                                 ptr, batch, h, w, dlen, step, stream);
}
