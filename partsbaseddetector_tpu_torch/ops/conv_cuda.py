"""Implicit-GEMM filter-bank correlation: the K2 port.

`filter_responses_infer` replaces `partsbaseddetector_tpu/ops/
conv_pallas.py::filter_responses_infer` and its kernel `_conv_kernel`
(via `filter_responses_pallas`). On a CUDA tensor it launches
`csrc/conv.cu`, which accumulates K = fh*fw*C in FP32 FMA (the f32
contract is Precision.HIGHEST: no TF32). On a CPU tensor it runs the
plain version, `ops/conv.py::filter_responses`.

Same contract as the plain version: features (S, H, W, C), filters
(F, fh, fw, C) -> (S, H-fh+1, W-fw+1, F). The wrapper lays the weights
out K-major (row (i*fw + j)*C + c holds filters[:, i, j, c], the order
of `conv_pallas.py:153-154`), zero-pads F to the kernel's filter tile
and slices the output back.
"""

from __future__ import annotations

import torch

from .. import kernels
from .conv import filter_responses

# launches of the CUDA kernel by filter_responses_infer
launches = 0


def _conv_cuda(features: torch.Tensor, filters: torch.Tensor) -> torch.Tensor:
    global launches
    s, h, w, c = features.shape
    f, fh, fw, fc = filters.shape
    for name, t in (("features", features), ("filters", filters)):
        if t.device != features.device or t.dtype != torch.float32:
            raise ValueError(
                f"conv: {name} must be float32 on {features.device}, "
                f"got {t.dtype} on {t.device}"
            )
    if fc != c:
        raise ValueError(f"conv: channel mismatch: features {c}, filters {fc}")
    oh, ow = h - fh + 1, w - fw + 1
    if oh <= 0 or ow <= 0:
        raise ValueError(
            f"conv: filters {fh}x{fw} larger than features {h}x{w}"
        )
    lib = kernels.library()
    smem = lib.pbd_conv_smem_bytes(c, fh, fw)
    if smem > 227 * 1024:
        raise ValueError(
            f"conv: a {fh}x{fw}x{c} patch needs {smem} B of shared memory"
        )
    tile = lib.pbd_conv_tile_filters()
    fp = -(-f // tile) * tile
    k = fh * fw * c
    wk = torch.zeros((k, fp), dtype=torch.float32, device=features.device)
    wk[:, :f] = filters.permute(1, 2, 3, 0).reshape(k, f)
    feat = features.contiguous()
    out = torch.empty((s, oh, ow, fp), dtype=torch.float32, device=features.device)
    with torch.cuda.device(features.device):
        rc = lib.pbd_conv_fp32(
            feat.data_ptr(), wk.data_ptr(), out.data_ptr(),
            s, h, w, c, fh, fw, fp,
            torch.cuda.current_stream(features.device).cuda_stream,
        )
    kernels.check(rc, "conv kernel launch")
    launches += 1
    return out if fp == f else out[..., :f].contiguous()


def filter_responses_infer(
    features: torch.Tensor, filters: torch.Tensor
) -> torch.Tensor:
    """Responses on the inference path: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    dev = features.device
    if dev.type == "cuda":
        return _conv_cuda(features, filters)
    if dev.type == "cpu":
        return filter_responses(features, filters)
    raise ValueError(f"conv: no kernel for device {dev}")
