"""Implicit-GEMM filter-bank correlation: the K2 port.

`filter_responses_grouped` and `filter_responses_infer` replace
`partsbaseddetector_tpu/ops/conv_pallas.py::filter_responses_infer` and
its kernel `_conv_kernel` (via `filter_responses_pallas`). On CUDA
tensors they launch `csrc/conv.cu`, which runs the products on the
tensor cores in 3xTF32: each f32 operand split into two TF32 pieces,
three exact partial products per pair, f32 accumulation (the Hopper
counterpart of Precision.HIGHEST on the TPU's MXU; single-pass TF32
stays forbidden). Its error rule is
`ops/conv.py::filter_responses_3xtf32_plain`'s: within 1e-5 * sum|x*w|
of the f32 correlation. On CPU tensors they run the plain version,
`ops/conv.py::filter_responses`.

Same contract as the plain version: features (S, H, W, C), filters
(F, fh, fw, C) -> (S, H-fh+1, W-fw+1, F). The kernel reads both in
these layouts and writes the result directly: no weight copy, no
output copy. `filter_responses_grouped` runs a list of feature stacks
(a detect's buckets) against one bank in one launch, each output the
bits that stack gives alone; `filter_responses_infer` is that launch
for one stack. The kernel stages the bank split into its TF32 pieces
(`split_bank`): a detector makes that split once, when its model goes
to the card (`models/model.py::to_device`), and passes it in; without
it the wrapper splits the bank per call.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from ..utils.profiling import hand_launches
from .conv import filter_responses, split_tf32


def split_bank(weights: torch.Tensor) -> torch.Tensor:
    """(2, *weights.shape): split_tf32's big and small pieces of a
    weight tensor, stacked, the form the kernels stage."""
    return torch.stack(split_tf32(weights.contiguous()))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous with a 16-byte aligned start (the kernel's 16-byte
    cp.async copies)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(features: torch.Tensor, filters: torch.Tensor, lib) -> None:
    """Raise on inputs the kernel does not take."""
    f, fh, fw, fc = filters.shape
    s, h, w, c = features.shape
    for name, t in (("features", features), ("filters", filters)):
        if t.device != filters.device or t.dtype != torch.float32:
            raise ValueError(
                f"conv: {name} must be float32 on {filters.device}, "
                f"got {t.dtype} on {t.device}"
            )
    if fc != c:
        raise ValueError(f"conv: channel mismatch: features {c}, filters {fc}")
    if h - fh + 1 <= 0 or w - fw + 1 <= 0:
        raise ValueError(f"conv: filters {fh}x{fw} larger than features {h}x{w}")
    smem = lib.pbd_conv_smem_bytes(c, fh, fw, f)
    if smem > 227 * 1024:
        raise ValueError(f"conv: a {fh}x{fw}x{c} patch needs {smem} B of shared memory")


def _grouped_cuda(features: list, filters: torch.Tensor, bank) -> list:
    f, fh, fw, c = filters.shape
    lib = kernels.library()
    for feat in features:
        _check(feat, filters, lib)
    if bank is None:
        bank = split_bank(filters)
    elif bank.shape != (2, *filters.shape) or bank.device != filters.device:
        raise ValueError(f"conv: split bank {tuple(bank.shape)} on {bank.device} "
                         f"for filters {tuple(filters.shape)} on {filters.device}")
    bank = _aligned(bank)
    outs = []
    most = lib.pbd_conv_max_groups()
    for lo in range(0, len(features), most):
        group = [_aligned(x) for x in features[lo : lo + most]]
        out = [torch.empty((x.shape[0], x.shape[1] - fh + 1, x.shape[2] - fw + 1, f),
                           dtype=torch.float32, device=filters.device) for x in group]
        n = len(group)
        ptrs = lambda ts: (ctypes.c_void_p * n)(*(t.data_ptr() for t in ts))
        ints = lambda k: (ctypes.c_int * n)(*(x.shape[k] for x in group))
        with torch.cuda.device(filters.device):
            rc = lib.pbd_conv_3xtf32_grouped(
                ptrs(group), ptrs(out), ints(0), ints(1), ints(2), n,
                bank.data_ptr(), c, f, fh, fw,
                torch.cuda.current_stream(filters.device).cuda_stream,
            )
        kernels.check(rc, "conv kernel launch")
        hand_launches["conv"] += 1
        outs += out
    return outs


def filter_responses_grouped(features: list, filters: torch.Tensor,
                             bank=None) -> list:
    """filter_responses of each (S_i, H_i, W_i, C) stack in `features`
    against one (F, fh, fw, C) bank: on CUDA tensors one kernel launch
    per 16 stacks, each output the bits of the stack alone; on CPU
    tensors the plain version of each. bank (optional, CUDA):
    split_bank(filters), made once by the caller."""
    dev = filters.device
    if dev.type == "cuda":
        return _grouped_cuda(list(features), filters, bank)
    if dev.type == "cpu":
        return [filter_responses(x, filters) for x in features]
    raise ValueError(f"conv: no kernel for device {dev}")


def filter_responses_infer(
    features: torch.Tensor, filters: torch.Tensor
) -> torch.Tensor:
    """Responses of one stack: filter_responses_grouped's launch for it
    on CUDA tensors, the plain version on CPU tensors."""
    if features.device != filters.device:
        raise ValueError(f"conv: features on {features.device}, filters on {filters.device}")
    return filter_responses_grouped([features], filters)[0]
