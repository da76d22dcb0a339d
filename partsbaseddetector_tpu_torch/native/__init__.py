"""ctypes bindings for the native C++ kernel library (`pbd_kernels.cc`
beside this file).

A copy of `partsbaseddetector_tpu/native/__init__.py`, over the port's
own copy of `native/pbd_kernels.cc`, so that the port never imports the
JAX package. The library is built on first use with g++ (-O3
-march=native -fopenmp) into `build/torch_native/` at the root of the
checkout, named by a hash of the source, the flags and the host's CPU
model (-march=native builds for this CPU alone). The build is
safe when several processes start it at once: they take an exclusive
file lock in that directory, the first compiles to a temporary file
there and renames it onto the final path, and the others find it built.
No process ever loads a half-written library. `available()` reports
whether a compiler or a built library is usable, so that callers can
fall back to the NumPy reference kernels.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..utils.rounding import cround

SRC = Path(__file__).resolve().parent / "pbd_kernels.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "torch_native"
CXX_FLAGS = (
    "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC", "-std=c++17",
)
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as fh:
            return next((line for line in fh if line.startswith("model name")), "")
    except OSError:
        return ""


def library_path(build_dir: Optional[os.PathLike] = None) -> Path:
    """Where the library for the current source, flags and CPU lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update((platform.machine() + _cpu_model()).encode())
    h.update(SRC.read_bytes())
    return Path(build_dir or BUILD_DIR) / f"libpbd_kernels_{h.hexdigest()[:16]}.so"


def build(build_dir: Optional[os.PathLike] = None) -> Path:
    """Compile the library if it is not built yet; returns its path.
    Raises RuntimeError if g++ fails or is missing."""
    out = library_path(build_dir)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / ".lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        try:
            if out.exists():  # another process built it while we waited
                return out
            fd, tmp = tempfile.mkstemp(dir=out.parent, suffix=".so.tmp")
            os.close(fd)
            try:
                proc = subprocess.run(
                    ["g++", *CXX_FLAGS, str(SRC), "-o", tmp],
                    capture_output=True, text=True, timeout=300,
                )
                if proc.returncode != 0:
                    raise RuntimeError(f"g++ failed:\n{proc.stderr[-4000:]}")
                os.replace(tmp, out)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(f"native build failed: {e}") from e
        finally:
            fcntl.flock(lockf, fcntl.LOCK_UN)
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError):
            _failed = True
            return None
        i64, f32p, f64p, i32p, u8p = (
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.float32, flags="C"),
            np.ctypeslib.ndpointer(np.float64, flags="C"),
            np.ctypeslib.ndpointer(np.int32, flags="C"),
            np.ctypeslib.ndpointer(np.uint8, flags="C"),
        )
        lib.pbd_hog.argtypes = [f32p, i64, i64, i64, f32p]
        lib.pbd_resize.argtypes = [f32p, i64, i64, i64, ctypes.c_double, f32p, f32p]
        lib.pbd_reduce.argtypes = [f32p, i64, i64, i64, f32p, f32p]
        lib.pbd_shiftdt.argtypes = [
            f64p, i64, i64,
            ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
            i64, i64, i64, i64, i64, f64p, i32p, i32p,
        ]
        lib.pbd_fconv_valid.argtypes = [f32p, i64, i64, i64, f32p, i64, i64, f32p]
        lib.pbd_fconv_bank.argtypes = [
            f32p, i64, i64, i64, f32p, i64, i64, i64, f32p,
        ]
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
        lib.pbd_shiftdt_batch.argtypes = [
            f64p, i64, i64, i64, f64p, i64p, i64, i64, i64, f64p, i32p, i32p,
        ]
        lib.pbd_mixture_combine.argtypes = [
            f64p, i32p, i32p, i64, i64, f64p, i64, f64p, i32p, i32p, i32p,
        ]
        lib.pbd_paint_nms.argtypes = [f64p, i64, i64, i64, ctypes.c_double, u8p]
        lib.pbd_box_medians.argtypes = [f32p, i64, i64, f64p, i64, f64p]
        lib.pbd_version.restype = ctypes.c_int64
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def hog(im: np.ndarray, sbin: int) -> np.ndarray:
    lib = _load()
    im = np.ascontiguousarray(im, dtype=np.float32)
    h, w, _ = im.shape
    bh, bw = cround(h / sbin), cround(w / sbin)
    out = np.zeros((max(bh - 2, 0), max(bw - 2, 0), 32), dtype=np.float32)
    lib.pbd_hog(im, h, w, sbin, out)
    return out


def resize(im: np.ndarray, scale: float) -> np.ndarray:
    lib = _load()
    im = np.ascontiguousarray(im, dtype=np.float32)
    h, w, c = im.shape
    dh, dw = cround(h * scale), cround(w * scale)
    out = np.zeros((dh, dw, c), dtype=np.float32)
    tmp = np.zeros((dh, w, c), dtype=np.float32)
    lib.pbd_resize(im, h, w, c, scale, out, tmp)
    return out


def reduce(im: np.ndarray) -> np.ndarray:
    lib = _load()
    im = np.ascontiguousarray(im, dtype=np.float32)
    h, w, c = im.shape
    dh, dw = cround(h * 0.5), cround(w * 0.5)
    out = np.zeros((dh, dw, c), dtype=np.float32)
    tmp = np.zeros((dh, w, c), dtype=np.float32)
    lib.pbd_reduce(im, h, w, c, out, tmp)
    return out


def shiftdt(score, w, shift_x, shift_y, dlen_x, dlen_y, step=1):
    lib = _load()
    score = np.ascontiguousarray(score, dtype=np.float64)
    h, wd = score.shape
    msg = np.zeros((dlen_y, dlen_x), dtype=np.float64)
    ix = np.zeros((dlen_y, dlen_x), dtype=np.int32)
    iy = np.zeros((dlen_y, dlen_x), dtype=np.int32)
    lib.pbd_shiftdt(
        score, h, wd,
        float(w[0]), float(w[1]), float(w[2]), float(w[3]),
        int(shift_x), int(shift_y), int(dlen_x), int(dlen_y), int(step),
        msg, ix, iy,
    )
    return msg, ix, iy


def fconv_valid(feat: np.ndarray, filt: np.ndarray) -> np.ndarray:
    lib = _load()
    feat = np.ascontiguousarray(feat, dtype=np.float32)
    filt = np.ascontiguousarray(filt, dtype=np.float32)
    h, w, c = feat.shape
    fh, fw, fc = filt.shape
    assert c == fc
    out = np.zeros((h - fh + 1, w - fw + 1), dtype=np.float32)
    lib.pbd_fconv_valid(feat, h, w, c, filt, fh, fw, out)
    return out


def fconv_bank(feat: np.ndarray, filters) -> list:
    """Responses of MANY same/mixed-size filters on one feature map in
    few native calls: filters are grouped by (fh, fw) and each group
    runs as one im2row+SGEMM pass with OpenMP over filters (the batched
    analog of the reference's per-filter OpenMP loop,
    src/SpatialConvolutionEngine.cpp:106-124). Returns per-filter
    response maps in input order."""
    lib = _load()
    feat = np.ascontiguousarray(feat, dtype=np.float32)
    h, w, c = feat.shape
    groups = {}
    for i, f in enumerate(filters):
        groups.setdefault(f.shape[:2], []).append(i)
    outs = [None] * len(filters)
    for (fh, fw), idxs in groups.items():
        bank = np.ascontiguousarray(
            np.stack([filters[i] for i in idxs]), dtype=np.float32
        )
        nf = len(idxs)
        oh, ow = h - fh + 1, w - fw + 1
        res = np.zeros((nf, oh, ow), dtype=np.float32)
        lib.pbd_fconv_bank(feat, h, w, c, bank, nf, fh, fw, res)
        for j, i in enumerate(idxs):
            outs[i] = res[j]
    return outs


def box_medians(depth: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """Median finite depth per box (N, 4) [x1 y1 x2 y2] inclusive coords;
    the reference's nth_element-at-n/2 semantics (include/Math.hpp:62-72),
    batched over the boxes of every candidate/part in one call."""
    lib = _load()
    depth = np.ascontiguousarray(depth, dtype=np.float32)
    boxes = np.ascontiguousarray(boxes, dtype=np.float64).reshape(-1, 4)
    out = np.empty(len(boxes), dtype=np.float64)
    lib.pbd_box_medians(
        depth, depth.shape[0], depth.shape[1], boxes, len(boxes), out
    )
    return out


def paint_nms(boxes: np.ndarray, im_shape, overlap: float = 0.0) -> np.ndarray:
    """boxes (N, 4) sorted by descending score -> bool keep mask."""
    lib = _load()
    boxes = np.ascontiguousarray(boxes, dtype=np.float64)
    keep = np.zeros(len(boxes), dtype=np.uint8)
    lib.pbd_paint_nms(boxes, len(boxes), im_shape[0], im_shape[1], overlap, keep)
    return keep.astype(bool)


# reference-pipeline-compatible alias
def shift_dt_2d(score, w, shift_x, shift_y, dlen_x, dlen_y, step=1):
    return shiftdt(score, w, shift_x, shift_y, dlen_x, dlen_y, step)


def shift_dt_2d_batch(scores, defs, shifts, dlen_x, dlen_y, step=1):
    """K mixture maps in one native call. scores (K, h, w); defs (K, 4)
    [wx2 wx1 wy2 wy1]; shifts (K, 2) [sx, sy]. Returns (msg, ix, iy)
    each (K, dlen_y, dlen_x)."""
    lib = _load()
    scores = np.ascontiguousarray(scores, dtype=np.float64)
    K, h, w = scores.shape
    defs = np.ascontiguousarray(defs, dtype=np.float64)
    shifts = np.ascontiguousarray(shifts, dtype=np.int64)
    msg = np.empty((K, dlen_y, dlen_x), dtype=np.float64)
    ix = np.empty((K, dlen_y, dlen_x), dtype=np.int32)
    iy = np.empty((K, dlen_y, dlen_x), dtype=np.int32)
    lib.pbd_shiftdt_batch(
        scores, K, h, w, defs, shifts, int(dlen_x), int(dlen_y), int(step),
        msg, ix, iy,
    )
    return msg, ix, iy


def mixture_combine(dt, ix, iy, bias):
    """passmsg combine: dt/ix/iy (K, ny, nx); bias (L, K). Returns
    (msg, ix, iy, ik) each (L, ny, nx), first-max over k."""
    lib = _load()
    K, ny, nx = dt.shape
    n = ny * nx
    dt = np.ascontiguousarray(dt, dtype=np.float64)
    ix = np.ascontiguousarray(ix, dtype=np.int32)
    iy = np.ascontiguousarray(iy, dtype=np.int32)
    bias = np.ascontiguousarray(bias, dtype=np.float64)
    L = bias.shape[0]
    msg = np.empty((L, ny, nx), dtype=np.float64)
    oix = np.empty((L, ny, nx), dtype=np.int32)
    oiy = np.empty((L, ny, nx), dtype=np.int32)
    oik = np.empty((L, ny, nx), dtype=np.int32)
    lib.pbd_mixture_combine(dt, ix, iy, K, n, bias, L, msg, oix, oiy, oik)
    return msg, oix, oiy, oik
