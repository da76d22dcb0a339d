"""Batched transpose of the last two axes: the T2 port.

`transpose_last2` replaces `tools/transpose_kernel_probe.py::make_tp`
(T2), a Pallas transpose meant for the DT x pass's four response-sized
transposes, which is where the port uses it
(`ops/distance_transform.py`). `transpose_last2_pair` transposes two
tensors of one shape (the DT's values and pointers) in one launch of
the same kernel. On CUDA tensors they launch `csrc/transpose.cu`; on
CPU tensors they run `transpose_last2_plain` /
`transpose_last2_pair_plain`. The kernel moves 32-bit words, so it
serves float32 values and int32 pointers alike, and its output is the
plain version's bit for bit.

Under autograd both run inside `Transpose2Function`, whose backward is
the same transpose (of a pair: the pair of the cotangents; an integer
tensor takes no gradient), so training's DTs take the kernel both ways.
"""

from __future__ import annotations

import math

import torch

from .. import kernels

# launches of the CUDA kernel by transpose_last2 and transpose_last2_pair
# (one per call, single or pair; the plain versions do not count)
launches = 0

_WORD_TYPES = (torch.float32, torch.int32)


def transpose_last2_plain(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., W, H), contiguous."""
    return x.transpose(-1, -2).contiguous()


def transpose_last2_pair_plain(x: torch.Tensor, y: torch.Tensor):
    """The plain transposes of two tensors."""
    return transpose_last2_plain(x), transpose_last2_plain(y)


def _transpose_cuda(x: torch.Tensor, y: torch.Tensor = None):
    """One launch over x, or over x and y (same shape and device)."""
    global launches
    both = (x,) if y is None else (x, y)
    for t in both:
        if t.dtype not in _WORD_TYPES:
            raise ValueError(f"transpose: float32 or int32 only, got {t.dtype}")
        if t.dim() < 2:
            raise ValueError(f"transpose: needs two axes, got shape {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"transpose: {t.device} and {x.device} differ")
    both = [t.contiguous() for t in both]
    h, w = x.shape[-2], x.shape[-1]
    bsz = math.prod(x.shape[:-2])
    outs = [torch.empty((*t.shape[:-2], w, h), dtype=t.dtype, device=t.device)
            for t in both]
    if outs[0].numel() == 0:
        return outs
    if bsz > 2**30:
        raise ValueError(f"transpose: {bsz} maps exceed one launch")
    lib = kernels.library()
    with torch.cuda.device(x.device):
        rc = lib.pbd_transpose32(
            both[0].data_ptr(), outs[0].data_ptr(),
            both[1].data_ptr() if y is not None else None,
            outs[1].data_ptr() if y is not None else None,
            bsz, h, w, torch.cuda.current_stream(x.device).cuda_stream,
        )
    kernels.check(rc, "transpose kernel launch")
    launches += 1
    return outs


def _transpose(x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cuda":
        return _transpose_cuda(x)[0]
    if x.device.type == "cpu":
        return transpose_last2_plain(x)
    raise ValueError(f"transpose: no kernel for device {x.device}")


def _transpose_pair(x: torch.Tensor, y: torch.Tensor):
    if x.shape != y.shape:
        raise ValueError(
            f"transpose pair: shapes {tuple(x.shape)} and {tuple(y.shape)} differ"
        )
    if x.device.type == "cuda":
        return tuple(_transpose_cuda(x, y))
    if x.device.type == "cpu":
        return transpose_last2_pair_plain(x, y)
    raise ValueError(f"transpose: no kernel for device {x.device}")


class Transpose2Function(torch.autograd.Function):
    """The transpose with itself as its backward, of one tensor or of a
    pair. A pair's backward transposes both cotangents in one launch
    when both inputs want a gradient, else the one that does."""

    @staticmethod
    def forward(ctx, x, y=None):
        if y is None:
            return _transpose(x)
        outs = _transpose_pair(x, y)
        ctx.mark_non_differentiable(*(t for t in outs if not t.is_floating_point()))
        return outs

    @staticmethod
    def backward(ctx, *grads):
        if len(grads) == 1:
            return _transpose(grads[0])
        want = [g is not None and need
                for g, need in zip(grads, ctx.needs_input_grad)]
        if all(want):
            return _transpose_pair(*grads)
        return tuple(_transpose(g) if w else None for g, w in zip(grads, want))


def transpose_last2(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., W, H), contiguous: the kernel for a CUDA
    tensor, the plain version for a CPU tensor; differentiable."""
    if torch.is_grad_enabled() and x.requires_grad:
        return Transpose2Function.apply(x)
    return _transpose(x)


def transpose_last2_pair(x: torch.Tensor, y: torch.Tensor):
    """Two tensors of one shape (..., H, W), each float32 or int32 ->
    their transposes (..., W, H), contiguous, from one kernel launch on
    CUDA tensors and from the plain version on CPU tensors;
    differentiable in the floating-point ones."""
    if torch.is_grad_enabled() and (x.requires_grad or y.requires_grad):
        return Transpose2Function.apply(x, y)
    return _transpose_pair(x, y)
