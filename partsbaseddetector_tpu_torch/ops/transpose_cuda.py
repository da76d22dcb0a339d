"""Batched transpose of the last two axes: the T2 port.

`transpose_last2` replaces `tools/transpose_kernel_probe.py::make_tp`
(T2), a Pallas transpose meant for the DT x pass's four response-sized
transposes, which is where the port uses it
(`ops/distance_transform.py`). On a CUDA tensor it launches
`csrc/transpose.cu`; on a CPU tensor it runs `transpose_last2_plain`.
The kernel moves 32-bit words, so it serves float32 values and int32
pointers alike, and its output is the plain version's bit for bit.

Under autograd it runs inside `Transpose2Function`, whose backward is
the same transpose, so training's DTs take the kernel both ways.
"""

from __future__ import annotations

import math

import torch

from .. import kernels

# launches of the CUDA kernel by transpose_last2 (the plain version does
# not count)
launches = 0

_WORD_TYPES = (torch.float32, torch.int32)


def transpose_last2_plain(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., W, H), contiguous."""
    return x.transpose(-1, -2).contiguous()


def _transpose_cuda(x: torch.Tensor) -> torch.Tensor:
    global launches
    if x.dtype not in _WORD_TYPES:
        raise ValueError(f"transpose: float32 or int32 only, got {x.dtype}")
    if x.dim() < 2:
        raise ValueError(f"transpose: needs two axes, got shape {tuple(x.shape)}")
    x = x.contiguous()
    h, w = x.shape[-2], x.shape[-1]
    bsz = math.prod(x.shape[:-2])
    out = torch.empty((*x.shape[:-2], w, h), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if bsz > 2**31 - 1:
        raise ValueError(f"transpose: {bsz} maps exceed one launch")
    lib = kernels.library()
    with torch.cuda.device(x.device):
        rc = lib.pbd_transpose32(
            x.data_ptr(), out.data_ptr(), bsz, h, w,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    kernels.check(rc, "transpose kernel launch")
    launches += 1
    return out


def _transpose(x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cuda":
        return _transpose_cuda(x)
    if x.device.type == "cpu":
        return transpose_last2_plain(x)
    raise ValueError(f"transpose: no kernel for device {x.device}")


class Transpose2Function(torch.autograd.Function):
    """The transpose with itself as its backward."""

    @staticmethod
    def forward(ctx, x):
        return _transpose(x)

    @staticmethod
    def backward(ctx, g):
        return _transpose(g)


def transpose_last2(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., W, H), contiguous: the kernel for a CUDA
    tensor, the plain version for a CPU tensor; differentiable."""
    if torch.is_grad_enabled() and x.requires_grad:
        return Transpose2Function.apply(x)
    return _transpose(x)
