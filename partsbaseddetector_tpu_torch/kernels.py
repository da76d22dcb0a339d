"""Build and load the hand-written CUDA kernels.

Every `csrc/*.cu` file (with the `csrc/*.cuh` headers it includes) is
compiled by `nvcc` into one shared library with
a plain C interface, linked against the shared CUDA runtime and loaded
with `ctypes`. The build runs at first use,
into `build/torch_kernels/` at the root of the checkout, and is keyed on
a hash of the sources and flags: a changed source builds a new library,
an unchanged one is reused. Nothing is imported or built when this
module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
# -cudart shared: the library launches through the libcudart.so.12 that
# `import torch` has loaded, whose stream handles the wrappers pass, not
# through a private static copy of the runtime. It moved no detect time
# and had no consistent effect on what the profiler records (PERF.md §6).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v", "-cudart", "shared",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # src, aux, a, b, shift, nvalid, out, ptr, batch, h, w, dlen, step, stream
    "pbd_dt1d_axis2_f32": ([_P] * 8 + [_I] * 5 + [_P], _I),
    # g, out, ptr, shift, g_src, g_a, g_b, batch, h, w, dlen, step, has_aux,
    # stream
    "pbd_dt1d_axis2_bwd_f32": ([_P] * 7 + [_I] * 6 + [_P], _I),
    # src, aux, a, b, shift, nvalid, out_valid, out, ptr, batch, h, w, dlen,
    # stream
    "pbd_dt1d_window_axis2_f32": ([_P] * 9 + [_I] * 4 + [_P], _I),
    # c, fh, fw, f
    "pbd_conv_smem_bytes": ([_I] * 4, ctypes.c_longlong),
    # feats, outs, s, h, w (host arrays), n, filt, c, f, fh, fw, stream
    "pbd_conv_3xtf32_grouped": ([_P] * 5 + [_I] + [_P] + [_I] * 4 + [_P], _I),
    "pbd_conv_max_groups": ([], _I),
    # feat_t, w2, out, s, h, c, w, fh, fw, f, fp, toh, stream
    "pbd_conv_proto_3xtf32": ([_P] * 3 + [_I] * 9 + [_P], _I),
    # c, fh, fw, f, toh
    "pbd_conv_proto_smem_bytes": ([_I] * 5, ctypes.c_longlong),
    "pbd_conv_proto_max_toh": ([], _I),
    # src0, dst0, src1 or null, dst1 or null, batch, h, w, stream
    "pbd_transpose32": ([_P] * 4 + [_I] * 3 + [_P], _I),
    "pbd_dt1d_rows": ([], _I),
    "pbd_dt1d_chunk": ([], _I),
    # h, w, dlen
    "pbd_dt1d_bwd_strips": ([_I] * 3, _I),
    "pbd_dt1d_bwd_segments": ([_I] * 3, _I),
}

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def headers() -> list:
    return sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources (and the headers they
    include) lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libpbd_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources if their library is not built yet; returns
    its path. Every source compiles in its own `nvcc`, all started
    together, and one more `nvcc` links the objects. The compilers'
    output (ptxas register and shared-memory report included) is kept
    beside the library as `<name>.log`."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
        jobs = []
        for src in sources():
            obj = os.path.join(work, src.stem + ".o")
            cmd = [_nvcc(), *compile_flags, "-c", "-o", obj, str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
            )))
        log, failed = [], []
        for cmd, _, proc in jobs:
            stdout, stderr = proc.communicate()
            log.append(" ".join(cmd) + "\n" + stdout + stderr)
            if proc.returncode != 0:
                failed.append(f"{cmd[-1]} ({proc.returncode}):\n{stderr[-4000:]}")
        if not failed:
            tmp = os.path.join(work, "lib.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(obj for _, obj, _ in jobs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(f"link ({proc.returncode}):\n{proc.stderr[-4000:]}")
        out.with_suffix(".log").write_text("".join(log))
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (args, res) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = res
        _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code. The entries return
    cudaGetLastError() of the runtime they share with torch, so the code
    can also be an error that an earlier torch op left pending; it is
    raised all the same, at the first launch after it."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
