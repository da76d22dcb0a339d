"""Explicit-patch filter-bank correlation: the T1 port.

`conv_proto` replaces `tools/conv_pallas_proto.py::conv_pallas` and its
kernel `kernel` (T1), the prototype of K2 that takes the features
pre-transposed to (S, H, C, W) and contracts an explicit patch matrix
against K-major weights. On a CUDA tensor it launches
`csrc/conv_proto.cu`, K2's 3xTF32 tensor-core core fed from T1's layouts
(T1 runs at Precision.HIGHEST; single-pass TF32 stays forbidden), whose
outputs equal K2's bit for bit; on a CPU tensor it runs
`conv_proto_plain`. No detect or train path runs
it: its path is its harness, `tools/conv_proto.py`, the K2 tuning
harness.

Layouts, as in the tool: feat_t (S, H, C, W); w2 (K = fh*fw*C, FP) with
row (i*fw + j)*C + c holding filters[:, i, j, c] and zero columns past F
(`weights_k_major`); the result is (S, H-fh+1, W-fw+1, F). The tool pads
H to NOH*TOH + FH - 1 rows and F to a multiple of 128; the kernel needs
no row padding (it masks the ragged row block), reads the first F
columns of w2 and writes the (S, OH, OW, F) result itself.
"""

from __future__ import annotations

import contextlib

import torch

from .. import kernels
from ..utils.profiling import hand_launches

# T1's fixed shapes (tools/conv_pallas_proto.py:30)
C, FH, FW = 32, 5, 5
# w2's columns are padded to a multiple of TILE_F, as the tool pads them
# (the kernel reads only the first F)
TILE_F = 64


def weights_k_major(filt) -> torch.Tensor:
    """(F, fh, fw, C) filters -> the (fh*fw*C, FP) K-major weight matrix,
    FP = F rounded up to TILE_F, zero columns past F: the tool's `w2`
    layout (row (i*fw + j)*C + c = filt[:, i, j, c])."""
    filt = torch.as_tensor(filt, dtype=torch.float32)
    f, fh, fw, c = filt.shape
    fp = -(-f // TILE_F) * TILE_F
    w2 = torch.zeros((fh * fw * c, fp), dtype=torch.float32, device=filt.device)
    w2[:, :f] = filt.permute(1, 2, 3, 0).reshape(fh * fw * c, f)
    return w2


@contextlib.contextmanager
def _no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def conv_proto_plain(feat_t: torch.Tensor, w2: torch.Tensor, f: int,
                     fh: int = FH, fw: int = FW) -> torch.Tensor:
    """T1's function in plain torch: the explicit (S, OH, OW, K) patch
    matrix (k = (i*fw + j)*C + c) times w2, in f32 with TF32 off, cut to
    the first f filters."""
    s, h, c, w = feat_t.shape
    oh, ow = h - fh + 1, w - fw + 1
    taps = [feat_t[:, i : i + oh, :, j : j + ow]
            for i in range(fh) for j in range(fw)]  # (S, OH, C, OW) each
    patch = torch.stack(taps, dim=2)  # (S, OH, T, C, OW)
    patch = patch.permute(0, 1, 4, 2, 3).reshape(s, oh, ow, fh * fw * c)
    with _no_tf32():
        out = patch @ w2
    return out[..., :f]


def _check(feat_t, w2, f, toh, fh, fw):
    for name, t, dims in (("feat_t", feat_t, 4), ("w2", w2, 2)):
        if (t.device != feat_t.device or t.dtype != torch.float32
                or t.dim() != dims):
            raise ValueError(
                f"conv_proto: {name} must be a {dims}-d float32 tensor on "
                f"{feat_t.device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    s, h, c, w = feat_t.shape
    k, fp = w2.shape
    if k != fh * fw * c:
        raise ValueError(f"conv_proto: w2 has {k} rows, want {fh}*{fw}*{c}")
    if fp % TILE_F or not 0 < f <= fp:
        raise ValueError(
            f"conv_proto: w2's {fp} columns must be a multiple of {TILE_F} "
            f"holding the {f} filters"
        )
    if h < fh or w < fw:
        raise ValueError(f"conv_proto: filters {fh}x{fw} larger than {h}x{w}")
    if s > 65535:
        raise ValueError(f"conv_proto: {s} scales exceed one launch (65535)")
    if toh < 1:
        raise ValueError(f"conv_proto: toh must be positive, got {toh}")


def _conv_proto_cuda(feat_t, w2, f, toh, fh, fw):
    s, h, c, w = feat_t.shape
    fp = w2.shape[1]
    lib = kernels.library()
    if toh > lib.pbd_conv_proto_max_toh():
        raise ValueError(
            f"conv_proto: toh {toh} exceeds the kernel's "
            f"{lib.pbd_conv_proto_max_toh()} positions per block"
        )
    smem = lib.pbd_conv_proto_smem_bytes(c, fh, fw, f, toh)
    if smem > 227 * 1024:
        raise ValueError(f"conv_proto: a {fh}x{fw}x{c} patch at toh {toh} "
                         f"needs {smem} B of shared memory")
    from .conv_cuda import split_bank

    feat_t = feat_t.contiguous()
    w2 = split_bank(w2)  # (2, K, FP): the TF32 pieces the kernel stages
    out = torch.empty((s, h - fh + 1, w - fw + 1, f), dtype=torch.float32,
                      device=feat_t.device)
    with torch.cuda.device(feat_t.device):
        rc = lib.pbd_conv_proto_3xtf32(
            feat_t.data_ptr(), w2.data_ptr(), out.data_ptr(),
            s, h, c, w, fh, fw, f, fp, toh,
            torch.cuda.current_stream(feat_t.device).cuda_stream,
        )
    kernels.check(rc, "conv_proto kernel launch")
    hand_launches["conv"] += 1  # a conv3xtf32 kernel, as K2
    return out


def conv_proto(feat_t: torch.Tensor, w2: torch.Tensor, f: int, toh: int,
               fh: int = FH, fw: int = FW) -> torch.Tensor:
    """T1: feat_t (S, H, C, W) and K-major w2 (fh*fw*C, FP) ->
    (S, H-fh+1, W-fw+1, f), the first f of FP filters. toh
    output rows per block (1 <= toh <= 128 on the card) is a blocking
    knob only: the result does not depend on it. The CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    _check(feat_t, w2, f, toh, fh, fw)
    dev = feat_t.device
    if dev.type == "cuda":
        return _conv_proto_cuda(feat_t, w2, f, int(toh), fh, fw)
    if dev.type == "cpu":
        return conv_proto_plain(feat_t, w2, f, fh, fw)
    raise ValueError(f"conv_proto: no kernel for device {dev}")
