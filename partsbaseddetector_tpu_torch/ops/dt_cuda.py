"""1-D generalized distance transform along axis -2: the K1/K3 port.

`dt1d` replaces `partsbaseddetector_tpu/ops/pallas_dt.py::dt1d_sublane`
(K1, `_make_sublane_kernel`) and, through a transpose, the forward of
`dt1d_pallas` (K3, `_make_kernel`). On a CUDA tensor it launches
`csrc/dt1d.cu`; on a CPU tensor it runs `dt1d_plain`, the brute-force
torch version of the same arithmetic. The two agree bit for bit.

For map b, output row i and column w, with q = shift_b + step*i:
  out[b, i, w] = max_{v < nvalid_b} (a_b*(q - v) + b_b)*(q - v) + src[b, v, w]
  ptr[b, i, w] = first argmax v (strict > in ascending v: the smallest
                 source index wins ties), or (aux[b, v, w] << 12) | v
                 with aux.
Sources at or beyond nvalid_b are excluded. An output with no live source
is -inf with pointer 0. (The JAX package's sublane kernel leaves its
float32-min sentinel there instead, and its XLA path -inf; pointers at
such outputs are don't-care downstream.)
"""

from __future__ import annotations

import math

import torch

from .. import kernels

# launches of the CUDA kernel by dt1d (the plain version does not count)
launches = 0

_NEG_INF = -math.inf


def dt1d_plain(
    src: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    shift: torch.Tensor,
    nvalid: torch.Tensor,
    dlen: int,
    step: int = 1,
    aux: torch.Tensor = None,
    max_elems: int = 1 << 26,
):
    """Brute-force max-plus over (B, H, W) maps, chunked over output
    rows so that at most `max_elems` candidate values exist at once.
    a/b/shift (B,) f32, nvalid (B,) int, aux (B, H, W) int32 or None.
    Returns (out (B, dlen, W) f32, ptr (B, dlen, W) int32)."""
    bsz, h, w = src.shape
    dev = src.device
    v = torch.arange(h, device=dev, dtype=torch.float32)
    live = torch.arange(h, device=dev)[None, :] < nvalid.to(dev)[:, None]
    srcm = torch.where(live[:, :, None], src, torch.full((), _NEG_INF, device=dev))
    a3 = a[:, None, None]
    b3 = b[:, None, None]
    rows = max(1, max_elems // max(1, bsz * h * w))
    outs, ptrs = [], []
    for i0 in range(0, dlen, rows):
        i = torch.arange(i0, min(dlen, i0 + rows), device=dev, dtype=torch.float32)
        q = shift[:, None] + step * i  # (B, ic)
        d = q[:, :, None] - v  # (B, ic, H)
        pen = (a3 * d + b3) * d
        vals = pen[..., None] + srcm[:, None]  # (B, ic, H, W)
        best, arg = torch.max(vals, dim=2)  # first max on ties
        arg = arg.to(torch.int32)
        if aux is not None:
            held = torch.gather(aux, 1, arg.long())
            arg = torch.where(best == _NEG_INF, 0, (held << 12) | arg)
        outs.append(best)
        ptrs.append(arg)
    return torch.cat(outs, dim=1), torch.cat(ptrs, dim=1)


def _dt1d_cuda(src, a, b, shift, nvalid, dlen, step, aux):
    global launches
    bsz, h, w = src.shape
    for name, t, dtype in (
        ("src", src, torch.float32), ("a", a, torch.float32),
        ("b", b, torch.float32), ("shift", shift, torch.float32),
        ("nvalid", nvalid, torch.int32),
    ) + ((("aux", aux, torch.int32),) if aux is not None else ()):
        if t.device != src.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"dt1d: {name} must be a contiguous {dtype} tensor on "
                f"{src.device}, got {t.dtype} on {t.device}"
            )
    if aux is not None and aux.shape != src.shape:
        raise ValueError(f"dt1d: aux shape {tuple(aux.shape)} != src shape")
    if bsz > 65535:
        raise ValueError(f"dt1d: {bsz} maps exceed one launch (65535)")
    out = torch.empty((bsz, dlen, w), dtype=torch.float32, device=src.device)
    ptr = torch.empty((bsz, dlen, w), dtype=torch.int32, device=src.device)
    lib = kernels.library()
    with torch.cuda.device(src.device):
        rc = lib.pbd_dt1d_axis2_f32(
            src.data_ptr(), aux.data_ptr() if aux is not None else None,
            a.data_ptr(), b.data_ptr(), shift.data_ptr(), nvalid.data_ptr(),
            out.data_ptr(), ptr.data_ptr(), bsz, h, w, dlen, step,
            torch.cuda.current_stream(src.device).cuda_stream,
        )
    kernels.check(rc, "dt1d kernel launch")
    launches += 1
    return out, ptr


def dt1d(src, a, b, shift, dlen: int, step: int = 1, nvalid=None, aux=None):
    """Batched 1-D DT along axis -2 of src (..., H, W).

    a, b, shift (f32) and nvalid (per-map live source count, default H)
    broadcast to src.shape[:-2]; aux (optional, int32, src's shape,
    values < 2^12) is carried through the max into the pointer.
    Returns (out (..., dlen, W) f32, ptr (..., dlen, W) int32)."""
    batch_shape = src.shape[:-2]
    h, w = src.shape[-2], src.shape[-1]
    bsz = math.prod(batch_shape)
    dev = src.device

    def per_map(x, dtype):
        x = torch.as_tensor(x, dtype=dtype, device=dev)
        return x.broadcast_to(batch_shape).reshape(bsz).contiguous()

    a_ = per_map(a, torch.float32)
    b_ = per_map(b, torch.float32)
    s_ = per_map(shift, torch.float32)
    nv = per_map(h if nvalid is None else nvalid, torch.int32).clamp(0, h)
    src3 = src.reshape(bsz, h, w)
    aux3 = None if aux is None else aux.reshape(bsz, h, w)
    if dev.type == "cuda":
        out, ptr = _dt1d_cuda(
            src3.contiguous(), a_, b_, s_, nv, dlen, step,
            None if aux3 is None else aux3.contiguous(),
        )
    elif dev.type == "cpu":
        out, ptr = dt1d_plain(src3, a_, b_, s_, nv, dlen, step, aux3)
    else:
        raise ValueError(f"dt1d: no kernel for device {dev}")
    return (
        out.reshape(*batch_shape, dlen, w),
        ptr.reshape(*batch_shape, dlen, w),
    )
