"""1-D generalized distance transform along axis -2: the K1/K3 port.

`dt1d` replaces `partsbaseddetector_tpu/ops/pallas_dt.py::dt1d_sublane`
(K1, `_make_sublane_kernel`) and, through a transpose, the forward of
`dt1d_pallas` (K3, `_make_kernel`). On a CUDA tensor it launches
`csrc/dt1d.cu`; on a CPU tensor it runs `dt1d_plain`, the brute-force
torch version of the same arithmetic. The two agree bit for bit. The
kernel skips whole chunks of source rows that cannot win
(`dt1d_chunk_keep_plain` states its rule in torch, for the tests).

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
that is -inf (no live source) passes none on. The kernel sums in a fixed
order, the same bits on every run; `dt1d_bwd_order_plain` states that
order in torch for the card tests.

`dt1d_window` replaces K5, `partsbaseddetector_tpu/ops/pallas_dt.py::
_dt1d_pallas_window` (kernel `_make_window_kernel`): the same transform
at step 1 with integral shifts, exact only at outputs i < out_valid[b, w]
(the consumer's extent) and (-inf, 0) beyond. On a CUDA tensor it
launches `csrc/dt1d_window.cu`, K1's core in its window form, which
skips what out_valid leaves don't-care (`dt1d_chunk_keep_plain(...,
out_valid=)` states its rule); on a CPU tensor it runs
`dt1d_window_plain`.
"""

from __future__ import annotations

import math

import torch

from .. import kernels
from ..utils.profiling import hand_launches

_NEG_INF = -math.inf
# csrc/dt1d_core.cuh's kR and kV: the consecutive output rows one thread owns
# (a run) and the source rows of one chunk of its pruning rule
DT1D_ROWS = 8
DT1D_CHUNK = 16
# csrc/dt1d_bwd.cu's kMaxWarps and kSlabBytes: the warps of a map's block
# at most, and the shared memory its per-warp slabs may take (they set its
# layout, and so the order of its sums: dt1d_bwd_layout)
DT1D_BWD_MAX_WARPS = 8
DT1D_BWD_SLAB_BYTES = 224 * 1024


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


def dt1d_chunk_keep_plain(
    src: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    shift: torch.Tensor,
    nvalid: torch.Tensor,
    dlen: int,
    step: int = 1,
    rows: int = DT1D_ROWS,
    chunk: int = DT1D_CHUNK,
    out_valid: torch.Tensor = None,
) -> torch.Tensor:
    """The chunk-pruning rule of `csrc/dt1d_core.cuh` in torch, in the
    kernel's own float32 arithmetic: which chunks of `chunk` source rows
    each run of `rows` consecutive output rows keeps, per column.
    Arguments as for `dt1d_plain` (sources finite or -inf); with
    out_valid (B, W) int, the rule of the window form (K5). Returns a
    bool tensor (B, ceil(dlen / rows), ceil(H / chunk), W).

    A run's live rows are its rows inside the map, or with out_valid
    those before out_valid[b, w]; only they count below, and a run with
    none keeps no chunk. A run first evaluates a seed window of `chunk`
    sources centred on its live rows; the smallest of their best seed
    values is the threshold `thr`. For chunk [v0, v1] every
    displacement d = q - v of a live row lies in [q_lo - v1, q_hi - v0],
    over which the penalty (a*d + b)*d is at most `pm`, the largest of
    its values at the two ends and at the vertex -b/(2a) clamped into
    the interval. The chunk is dropped when its maximum `cm` is -inf or
    when (cm + pm) + (1e-3 + 1e-3*(|cm| + |pm|)) < thr. The kernel
    evaluates every chunk that any lane of a warp keeps, so it evaluates
    at least these; every source that reaches a live output's maximum
    must lie in a kept chunk (`tests/test_torch_dt_prune.py`)."""
    bsz, _, w = src.shape
    dev = src.device
    nruns = -(-dlen // rows)
    i_first = torch.arange(nruns, device=dev) * rows
    n_live = (dlen - i_first).clamp(max=rows)[None, :, None].expand(bsz, nruns, w)
    if out_valid is not None:
        ov = out_valid.to(dev).long().clamp(0, dlen)
        n_live = torch.minimum(n_live, (ov[:, None, :] - i_first[:, None]).clamp(min=0))
    return chunk_keep_rows(src, a, b, shift, nvalid, step, rows, chunk,
                           torch.zeros_like(n_live), n_live)


def chunk_keep_rows(src, a, b, shift, nvalid, step, rows, chunk, lo, hi):
    """`dt1d_chunk_keep_plain` for the rows [lo, hi) of each run, lo and
    hi (B, runs, W) int: those rows alone set the seed window's centre,
    the threshold and the displacement interval, and a run with hi <= lo
    keeps nothing. The kernel's rule is lo = 0, hi = the live rows."""
    bsz, h, w = src.shape
    dev = src.device
    f32 = torch.float32
    nv = nvalid.to(dev).clamp(0, h).long()
    nruns, nchunks = lo.shape[1], -(-h // chunk)
    hp = nchunks * chunk
    srcp = torch.full((bsz, hp, w), _NEG_INF, dtype=f32, device=dev)
    srcp[:, :h] = src
    live = torch.arange(hp, device=dev)[None, :] < nv[:, None]
    srcp = torch.where(live[:, :, None], srcp, torch.full((), _NEG_INF, device=dev))
    cm = srcp.reshape(bsz, nchunks, chunk, w).amax(dim=2)[:, None]  # (B,1,C,W)

    def pen(d):
        ix = (slice(None),) + (None,) * (d.dim() - 1)
        return (a[ix] * d + b[ix]) * d

    i_first = torch.arange(nruns, device=dev) * rows
    n = (hi - lo).clamp(min=1)
    q_at = lambda r: shift[:, None, None] + (step * (i_first[:, None] + r)).to(f32)
    q_first, q_last = q_at(lo), q_at(lo + n - 1)  # (B, R, W)

    # the seed window [vs, vs + chunk) and each row's best value over it
    half = ((step * (n - 1) - chunk) >> 1).to(f32)
    vs = (q_first.floor() + half).clamp(min=0)
    vs = torch.minimum(vs, (nv - chunk).clamp(min=0).to(f32)[:, None, None]).long()
    r = torch.arange(rows, device=dev)
    q = shift[:, None, None] + (step * (i_first[:, None] + r)).to(f32)  # (B,R,rows)
    v = vs[:, :, None] + torch.arange(chunk, device=dev)[:, None]  # (B,R,chunk,W)
    held = torch.gather(srcp[:, None].expand(bsz, nruns, hp, w), 2, v)
    d = q[:, :, :, None, None] - v[:, :, None].to(f32)  # (B,R,rows,chunk,W)
    seed = (pen(d) + held[:, :, None]).amax(dim=3)  # (B,R,rows,W)
    sets = (r[:, None] >= lo[:, :, None]) & (r[:, None] < hi[:, :, None])
    thr = torch.where(sets, seed, torch.full((), math.inf, device=dev)).amin(dim=2)

    v_lo = torch.arange(nchunks, device=dev) * chunk
    v_hi = torch.minimum(v_lo[None, :] + chunk, nv[:, None]) - 1  # (B, C)
    d_lo = torch.minimum(q_first, q_last)[:, :, None] - v_hi[:, None, :, None].to(f32)
    d_hi = torch.maximum(q_first, q_last)[:, :, None] - v_lo[:, None].to(f32)
    pm = torch.maximum(pen(d_lo), pen(d_hi))  # (B, R, C, W)
    curved = a != 0
    dstar = (-b) / (2.0 * torch.where(curved, a, torch.ones_like(a)))
    vertex = torch.minimum(torch.maximum(dstar[:, None, None, None], d_lo), d_hi)
    pm = torch.where(curved[:, None, None, None], torch.maximum(pm, pen(vertex)), pm)
    slack = 1e-3 + 1e-3 * (cm.abs() + pm.abs())
    keep = (cm != _NEG_INF) & ~((cm + pm) + slack < thr[:, :, None, :])
    return keep & (hi > lo)[:, :, None, :]


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
    hand_launches["dt1d"] += 1
    if aux is not None:
        hand_launches["dt1d_aux"] += 1
    return out, ptr


def dt1d_flat(src, a, b, shift, nvalid, dlen: int, step: int = 1, aux=None):
    """`dt1d`'s forward (no gradient) on arguments in flatten_maps' form:
    src (B, H, W), a/b/shift (B,) f32, nvalid (B,) int32 in [0, H], aux
    (B, H, W) int32 or None; the kernel on CUDA, the plain version on
    the CPU. It flattens nothing, so a caller that builds the per-map
    parameters once (`map_params`) copies nothing per call. Returns
    (out, ptr) (B, dlen, W)."""
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


def dt1d_bwd_layout(h: int, w: int, dlen: int) -> tuple:
    """The layout of `csrc/dt1d_bwd.cu`'s block (one block a map) for
    maps of h source rows, w columns and dlen output rows: (strips,
    segments), the 32-column strips a round of the block takes and the
    row segments (one warp each) per strip. As many strips at once as
    there are, within DT1D_BWD_MAX_WARPS warps and slabs of shared
    memory (h x 32 f32 each) within DT1D_BWD_SLAB_BYTES; then as many
    segments as the warps left allow, at most dlen. (0, 1) where one
    slab does not fit: the kernel's global-memory path, one warp that
    takes the strips one after another."""
    slab = 128 * h
    if slab > DT1D_BWD_SLAB_BYTES:
        return 0, 1
    fit = min(DT1D_BWD_MAX_WARPS, DT1D_BWD_SLAB_BYTES // slab)
    strips = min(-(-w // 32), fit)
    return strips, max(1, min(fit // strips, dlen))


def dt1d_bwd_order_plain(g_out, out, ptr, shift, h: int, step: int,
                         has_aux: bool, strips: int = None, segments: int = None):
    """`dt1d_bwd_plain`'s sums in the order of `csrc/dt1d_bwd.cu`, which
    the card tests hold the kernel to bit for bit. A map's output rows
    fall into `segments` contiguous segments of seg = ceil(dlen /
    segments) rows, its columns into 32-column strips, taken `strips` at
    a time (a round); warp k = t * segments + j of the block takes strip
    t of each round and segment j, a lane per column. g_src[v, x] is
    segment 0's sum of g over its rows with v* = v (ascending), plus
    segment 1's, and so on. g_a (g_b) adds, per lane, its outputs' g*d*d
    (g*d) over the rounds in order and its rows in order, then the lanes
    by a shuffle tree (lane l takes lane l + o, o = 16, 8, 4, 2, 1),
    then the warps in order. Dead (-inf) outputs add nothing. The layout
    defaults to the kernel's (`dt1d_bwd_layout`; its global-memory path
    sums as strips = segments = 1)."""
    bsz, dlen, w = g_out.shape
    dev = g_out.device
    if strips is None or segments is None:
        strips, segments = dt1d_bwd_layout(h, w, dlen)
        strips = max(strips, 1)
    v, d, live = _winners(out, ptr, shift, step, has_aux)
    zero = torch.zeros((), dtype=g_out.dtype, device=dev)
    gd = g_out * d
    terms = [torch.where(live, t, zero) for t in (g_out, gd * d, gd)]
    v = torch.where(live, v, 0).long()
    seg = -(-dlen // segments)
    rounds = -(-w // (32 * strips))
    width = rounds * strips * 32

    def by_segment(t):  # (B, dlen, W) -> (B, segments, seg, width), zero-padded
        t = torch.nn.functional.pad(t, (0, width - w, 0, segments * seg - dlen))
        return t.reshape(bsz, segments, seg, width)

    g, vs = (by_segment(t).permute(1, 2, 0, 3) for t in (terms[0], v))
    slabs = torch.zeros((segments, bsz, h, width), dtype=g_out.dtype, device=dev)
    at = (torch.arange(segments, device=dev)[:, None, None],
          torch.arange(bsz, device=dev)[None, :, None])
    cols = torch.arange(width, device=dev)
    for p in range(seg):  # one row of every segment; no cell twice
        idx = (*at, vs[:, p], cols)
        slabs[idx] = slabs[idx] + g[:, p]
    g_src = slabs[0]
    for j in range(1, segments):
        g_src = g_src + slabs[j]

    def total(t):
        lanes = by_segment(t).reshape(bsz, segments, seg, rounds, strips, 32)
        lanes = lanes.permute(4, 1, 3, 2, 0, 5)  # (strips, segments, rounds, seg, B, 32)
        acc = torch.zeros((strips, segments, bsz, 32), dtype=g_out.dtype, device=dev)
        for r in range(rounds):
            for p in range(seg):
                acc = acc + lanes[:, :, r, p]
        for o in (16, 8, 4, 2, 1):
            acc = acc[..., :o] + acc[..., o:2 * o]
        acc = acc.reshape(strips * segments, bsz)  # warp k = t * segments + j
        tot = acc[0]
        for k in range(1, strips * segments):
            tot = tot + acc[k]
        return tot

    return g_src[..., :w].contiguous(), total(terms[1]), total(terms[2])


def _dt1d_bwd_cuda(g_out, out, ptr, shift, h, step, has_aux):
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
    hand_launches["dt1d_bwd"] += 1
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
        out, ptr = dt1d_flat(src, a, b, shift, nvalid, dlen, step, aux)
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
        out, ptr = dt1d_flat(*args[:5], dlen, step, args[5])
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
    return (
        src.reshape(bsz, h, w),
        *map_params(batch_shape, h, a, b, shift, nvalid, src.device),
        None if aux is None else aux.reshape(bsz, h, w),
    )


def map_params(batch_shape, h: int, a, b, shift, nvalid, device):
    """flatten_maps' per-map parameters of maps with batch axes
    batch_shape and h source rows: (a, b, shift) (B,) f32 and nvalid
    (B,) int32 clamped to [0, h] (default h), contiguous. A caller that
    runs one batch of maps again and again builds them once and passes
    them to `dt1d_flat` (ops/distance_transform.py::dt_maps)."""
    bsz = math.prod(batch_shape)

    def per_map(x, dtype):
        x = torch.as_tensor(x, dtype=dtype, device=device)
        return x.broadcast_to(batch_shape).reshape(bsz).contiguous()

    return (
        per_map(a, torch.float32),
        per_map(b, torch.float32),
        per_map(shift, torch.float32),
        per_map(h if nvalid is None else nvalid, torch.int32).clamp(0, h),
    )


def out_valid_rows(batch_shape, w: int, out_valid, dlen: int, device):
    """`dt1d_window`'s out_valid for maps with batch axes batch_shape and
    w columns: (B, W) int32 clamped to [0, dlen], contiguous."""
    ov = torch.as_tensor(out_valid, dtype=torch.int32, device=device)
    ov = ov.broadcast_to((*batch_shape, w)).reshape(math.prod(batch_shape), w)
    return ov.clamp(0, dlen).contiguous()


def dt1d_window_flat(src, a, b, shift, nvalid, out_valid, dlen: int, aux=None):
    """`dt1d_window` on arguments in window_args' form (out_valid (B, W)
    int32 in [0, dlen]): the kernel on CUDA, the plain version on the
    CPU. Returns (out, ptr) (B, dlen, W)."""
    if src.device.type == "cuda":
        return _dt1d_window_cuda(src, a, b, shift, nvalid, out_valid, dlen, aux)
    if src.device.type == "cpu":
        return dt1d_window_plain(src, a, b, shift, nvalid, out_valid, dlen, aux)
    raise ValueError(f"dt1d_window: no kernel for device {src.device}")


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
    hand_launches["dt1d_window"] += 1
    return out, ptr


def window_args(src, a, b, shift, dlen: int, out_valid, nvalid=None,
                aux=None):
    """`dt1d_window`'s arguments as one batch of maps, the form its
    kernel and plain version take: (src (B, H, W), a, b, shift, nvalid,
    out_valid (B, W) int32 clamped to [0, dlen], aux or None), all
    contiguous."""
    src3, a_, b_, s_, nv, aux3 = flatten_maps(src, a, b, shift, nvalid, aux)
    ov = out_valid_rows(src.shape[:-2], src.shape[-1], out_valid, dlen, src.device)
    return (src3.contiguous(), a_, b_, s_, nv, ov,
            None if aux3 is None else aux3.contiguous())


def dt1d_window(src, a, b, shift, dlen: int, out_valid, nvalid=None,
                aux=None):
    """The adaptive-window DT (K5) along axis -2 of src (..., H, W), at
    step 1. Arguments as for `dt1d`, but shift must be integral (the
    caller decides this on the host), and out_valid (int, broadcastable
    to (..., W)) gives per output column the number of rows that must be
    exact: rows at or beyond it come back (-inf, 0). No gradient.
    Returns (out (..., dlen, W) f32, ptr (..., dlen, W) int32)."""
    batch_shape = src.shape[:-2]
    w = src.shape[-1]
    src3, a_, b_, s_, nv, ov, aux3 = window_args(
        src, a, b, shift, dlen, out_valid, nvalid, aux)
    out, ptr = dt1d_window_flat(src3, a_, b_, s_, nv, ov, dlen, aux3)
    return (
        out.reshape(*batch_shape, dlen, w),
        ptr.reshape(*batch_shape, dlen, w),
    )
