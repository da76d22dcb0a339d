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

`dt1d(..., differentiable=True)` runs the same forward inside
`DT1dFunction`, whose backward replaces K4, the custom VJP of
`partsbaseddetector_tpu/ops/pallas_dt.py::_diff_dt`: the max's
subgradient, with d = q - v* at the winning source v*,
  g_src[b, v, w] = sum of g[b, i, w] over the outputs i with v* = v,
  g_a[b] = sum_{i,w} g*d^2,   g_b[b] = sum_{i,w} g*d.
On a CUDA tensor it launches `csrc/dt1d_bwd.cu`, on a CPU tensor it runs
`dt1d_bwd_plain`. shift, nvalid and aux get no gradient, and an output
that is -inf (no live source) passes none on.

`dt1d_window` replaces K5, `partsbaseddetector_tpu/ops/pallas_dt.py::
_dt1d_pallas_window` (kernel `_make_window_kernel`): the same transform
at step 1 with integral shifts, exact only at outputs i < out_valid[b, w]
(the consumer's extent) and (-inf, 0) beyond, so that each output's scan
may stop as soon as no farther source can win. On a CUDA tensor it
launches `csrc/dt1d_window.cu`, on a CPU tensor it runs
`dt1d_window_plain`.
"""

from __future__ import annotations

import math

import torch

from .. import kernels

# launches of the CUDA kernels by dt1d, by DT1dFunction's backward and by
# dt1d_window (the plain versions do not count); aux_launches counts the
# dt1d launches that carried aux (the x passes, K3's work)
launches = 0
aux_launches = 0
bwd_launches = 0
window_launches = 0

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


def _check_args(what, src, named, aux=None):
    """Raise unless every (name, tensor, dtype) of `named` is a
    contiguous tensor of that dtype on src's device, aux (if any) has
    src's shape and the maps fit one launch."""
    if aux is not None:
        named = named + (("aux", aux, torch.int32),)
    for name, t, dtype in named:
        if t.device != src.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"{what}: {name} must be a contiguous {dtype} tensor on "
                f"{src.device}, got {t.dtype} on {t.device}"
            )
    if aux is not None and aux.shape != src.shape:
        raise ValueError(f"{what}: aux shape {tuple(aux.shape)} != src shape")
    if src.shape[0] > 65535:
        raise ValueError(f"{what}: {src.shape[0]} maps exceed one launch (65535)")


def _map_args(src, a, b, shift, nvalid):
    return (
        ("src", src, torch.float32), ("a", a, torch.float32),
        ("b", b, torch.float32), ("shift", shift, torch.float32),
        ("nvalid", nvalid, torch.int32),
    )


def _dt1d_cuda(src, a, b, shift, nvalid, dlen, step, aux):
    global launches, aux_launches
    bsz, h, w = src.shape
    _check_args("dt1d", src, _map_args(src, a, b, shift, nvalid), aux)
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
    if aux is not None:
        aux_launches += 1
    return out, ptr


def _dt1d_fwd(src, a, b, shift, nvalid, dlen, step, aux):
    """(B, H, W) forward on the maps' device: the kernel on CUDA, the
    plain version on the CPU."""
    if src.device.type == "cuda":
        return _dt1d_cuda(
            src.contiguous(), a, b, shift, nvalid, dlen, step,
            None if aux is None else aux.contiguous(),
        )
    if src.device.type == "cpu":
        return dt1d_plain(src, a, b, shift, nvalid, dlen, step, aux)
    raise ValueError(f"dt1d: no kernel for device {src.device}")


def _winners(out, ptr, shift, step: int, has_aux: bool):
    """For (B, dlen, W) forward outputs: the winning source v*, the
    offset d = q - v* (rounded as the kernels round it) and the mask of
    live (not -inf) outputs."""
    v = (ptr & 0xFFF) if has_aux else ptr
    i = torch.arange(ptr.shape[1], device=ptr.device, dtype=torch.float32)
    q = shift[:, None] + step * i  # (B, dlen)
    return v, q[:, :, None] - v.to(torch.float32), out != _NEG_INF


def dt1d_bwd_plain(g_out, out, ptr, shift, h: int, step: int, has_aux: bool):
    """K4's backward in torch. g_out, out, ptr (B, dlen, W); shift (B,).
    Returns (g_src (B, h, W), g_a (B,), g_b (B,)). Outputs that are -inf
    (no live source) contribute nothing. The scatter is `scatter_add_`
    along axis -2, deterministic on the CPU."""
    v, d, live = _winners(out, ptr, shift, step, has_aux)
    g = torch.where(live, g_out, torch.zeros((), device=g_out.device))
    gd = g * d
    g_src = torch.zeros(
        (g_out.shape[0], h, g_out.shape[2]), dtype=g_out.dtype,
        device=g_out.device,
    )
    g_src.scatter_add_(1, v.long(), g)
    return g_src, (gd * d).sum(dim=(1, 2)), gd.sum(dim=(1, 2))


def dt1d_bwd_magnitudes(g_out, out, ptr, shift, h: int, step: int,
                        has_aux: bool):
    """The magnitudes the backward sums, which scale its error bounds
    where two implementations sum in different orders: sum |g| over the
    outputs that point at each source (B, h, W), and per map sum
    |g*d^2| and sum |g*d| (B,)."""
    m_src, m_a, _ = dt1d_bwd_plain(g_out.abs(), out, ptr, shift, h, step, has_aux)
    _, d, live = _winners(out, ptr, shift, step, has_aux)
    m_b = torch.where(live, (g_out * d).abs(), torch.zeros((), device=g_out.device))
    return m_src, m_a, m_b.sum(dim=(1, 2))


def _dt1d_bwd_cuda(g_out, out, ptr, shift, h, step, has_aux):
    global bwd_launches
    bsz, dlen, w = g_out.shape
    for name, t, dtype in (
        ("g_out", g_out, torch.float32), ("out", out, torch.float32),
        ("ptr", ptr, torch.int32), ("shift", shift, torch.float32),
    ):
        if t.device != g_out.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"dt1d backward: {name} must be a contiguous {dtype} tensor "
                f"on {g_out.device}, got {t.dtype} on {t.device}"
            )
    if out.shape != g_out.shape or ptr.shape != g_out.shape:
        raise ValueError("dt1d backward: g_out, out and ptr shapes differ")
    if bsz > 65535:
        raise ValueError(f"dt1d backward: {bsz} maps exceed one launch (65535)")
    g_src = torch.empty((bsz, h, w), dtype=torch.float32, device=g_out.device)
    g_a = torch.empty((bsz,), dtype=torch.float32, device=g_out.device)
    g_b = torch.empty((bsz,), dtype=torch.float32, device=g_out.device)
    lib = kernels.library()
    with torch.cuda.device(g_out.device):
        rc = lib.pbd_dt1d_axis2_bwd_f32(
            g_out.data_ptr(), out.data_ptr(), ptr.data_ptr(),
            shift.data_ptr(), g_src.data_ptr(), g_a.data_ptr(),
            g_b.data_ptr(), bsz, h, w, dlen, step, int(has_aux),
            torch.cuda.current_stream(g_out.device).cuda_stream,
        )
    kernels.check(rc, "dt1d backward kernel launch")
    bwd_launches += 1
    return g_src, g_a, g_b


def dt1d_bwd(g_out, out, ptr, shift, h: int, step: int, has_aux: bool):
    """K4's backward on the tensors' device: the kernel on CUDA, the
    plain version on the CPU."""
    if g_out.device.type == "cuda":
        return _dt1d_bwd_cuda(
            g_out.contiguous(), out, ptr, shift, h, step, has_aux
        )
    if g_out.device.type == "cpu":
        return dt1d_bwd_plain(g_out, out, ptr, shift, h, step, has_aux)
    raise ValueError(f"dt1d backward: no kernel for device {g_out.device}")


class DT1dFunction(torch.autograd.Function):
    """The (B, H, W) DT with K4's backward. Gradients reach src, a and b;
    shift, nvalid and aux are grid metadata and get none."""

    @staticmethod
    def forward(ctx, src, a, b, shift, nvalid, dlen, step, aux):
        out, ptr = _dt1d_fwd(src, a, b, shift, nvalid, dlen, step, aux)
        ctx.save_for_backward(out, ptr, shift)
        ctx.h, ctx.step, ctx.has_aux = src.shape[1], step, aux is not None
        ctx.mark_non_differentiable(ptr)
        return out, ptr

    @staticmethod
    def backward(ctx, g_out, _g_ptr):
        out, ptr, shift = ctx.saved_tensors
        g_src, g_a, g_b = dt1d_bwd(
            g_out, out, ptr, shift, ctx.h, ctx.step, ctx.has_aux
        )
        return g_src, g_a, g_b, None, None, None, None, None


def dt1d(src, a, b, shift, dlen: int, step: int = 1, nvalid=None, aux=None,
         differentiable: bool = False):
    """Batched 1-D DT along axis -2 of src (..., H, W).

    a, b, shift (f32) and nvalid (per-map live source count, default H)
    broadcast to src.shape[:-2]; aux (optional, int32, src's shape,
    values < 2^12) is carried through the max into the pointer.
    differentiable=True attaches K4's backward (DT1dFunction): src, a
    and b get gradients, those of a and b summed over the axes they
    were broadcast along.
    Returns (out (..., dlen, W) f32, ptr (..., dlen, W) int32)."""
    batch_shape = src.shape[:-2]
    w = src.shape[-1]
    args = flatten_maps(src, a, b, shift, nvalid, aux)
    if differentiable:
        out, ptr = DT1dFunction.apply(*args[:5], dlen, step, args[5])
    else:
        out, ptr = _dt1d_fwd(*args[:5], dlen, step, args[5])
    return (
        out.reshape(*batch_shape, dlen, w),
        ptr.reshape(*batch_shape, dlen, w),
    )


def flatten_maps(src, a, b, shift, nvalid, aux):
    """(..., H, W) maps and their per-map parameters as one (B, H, W)
    batch: (src, a, b, shift, nvalid, aux) with a/b/shift (B,) f32 and
    nvalid (B,) int32 clamped to [0, H] (default H)."""
    batch_shape = src.shape[:-2]
    h, w = src.shape[-2], src.shape[-1]
    bsz = math.prod(batch_shape)
    dev = src.device

    def per_map(x, dtype):
        x = torch.as_tensor(x, dtype=dtype, device=dev)
        return x.broadcast_to(batch_shape).reshape(bsz).contiguous()

    return (
        src.reshape(bsz, h, w),
        per_map(a, torch.float32),
        per_map(b, torch.float32),
        per_map(shift, torch.float32),
        per_map(h if nvalid is None else nvalid, torch.int32).clamp(0, h),
        None if aux is None else aux.reshape(bsz, h, w),
    )


def dt1d_window_plain(src, a, b, shift, nvalid, out_valid, dlen: int,
                      aux=None):
    """K5 in torch: `dt1d_plain` at step 1, then (-inf, 0) at every
    output i >= out_valid[b, w]. src (B, H, W); a/b/shift (B,) f32;
    nvalid (B,) int; out_valid (B, W) int (clamped to [0, dlen])."""
    out, ptr = dt1d_plain(src, a, b, shift, nvalid, dlen, 1, aux)
    i = torch.arange(dlen, device=src.device)[None, :, None]
    dont_care = i >= out_valid.to(src.device).clamp(0, dlen)[:, None, :]
    return (
        out.masked_fill(dont_care, _NEG_INF),
        ptr.masked_fill(dont_care, 0),
    )


def _dt1d_window_cuda(src, a, b, shift, nvalid, out_valid, dlen, aux):
    global window_launches
    bsz, h, w = src.shape
    _check_args(
        "dt1d_window", src,
        _map_args(src, a, b, shift, nvalid)
        + (("out_valid", out_valid, torch.int32),),
        aux,
    )
    if out_valid.shape != (bsz, w):
        raise ValueError(
            f"dt1d_window: out_valid shape {tuple(out_valid.shape)} != {(bsz, w)}"
        )
    out = torch.empty((bsz, dlen, w), dtype=torch.float32, device=src.device)
    ptr = torch.empty((bsz, dlen, w), dtype=torch.int32, device=src.device)
    lib = kernels.library()
    with torch.cuda.device(src.device):
        rc = lib.pbd_dt1d_window_axis2_f32(
            src.data_ptr(), aux.data_ptr() if aux is not None else None,
            a.data_ptr(), b.data_ptr(), shift.data_ptr(), nvalid.data_ptr(),
            out_valid.data_ptr(), out.data_ptr(), ptr.data_ptr(),
            bsz, h, w, dlen,
            torch.cuda.current_stream(src.device).cuda_stream,
        )
    kernels.check(rc, "dt1d_window kernel launch")
    window_launches += 1
    return out, ptr


def dt1d_window(src, a, b, shift, dlen: int, out_valid, nvalid=None,
                aux=None):
    """The adaptive-window DT (K5) along axis -2 of src (..., H, W), at
    step 1. Arguments as for `dt1d`, but shift must be integral (the
    scan steps over integer displacements; the caller decides this on
    the host), and out_valid (int, broadcastable to (..., W)) gives per
    output column the number of rows that must be exact: rows at or
    beyond it come back (-inf, 0). No gradient.
    Returns (out (..., dlen, W) f32, ptr (..., dlen, W) int32)."""
    batch_shape = src.shape[:-2]
    w = src.shape[-1]
    src3, a_, b_, s_, nv, aux3 = flatten_maps(src, a, b, shift, nvalid, aux)
    ov = torch.as_tensor(out_valid, dtype=torch.int32, device=src.device)
    ov = ov.broadcast_to((*batch_shape, w)).reshape(src3.shape[0], w)
    ov = ov.clamp(0, dlen).contiguous()
    if src.device.type == "cuda":
        out, ptr = _dt1d_window_cuda(
            src3.contiguous(), a_, b_, s_, nv, ov, dlen,
            None if aux3 is None else aux3.contiguous(),
        )
    elif src.device.type == "cpu":
        out, ptr = dt1d_window_plain(src3, a_, b_, s_, nv, ov, dlen, aux3)
    else:
        raise ValueError(f"dt1d_window: no kernel for device {src.device}")
    return (
        out.reshape(*batch_shape, dlen, w),
        ptr.reshape(*batch_shape, dlen, w),
    )
