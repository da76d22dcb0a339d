"""The torch port on the card: its CUDA kernels against their plain
versions, and every detect profile, trainer, serving API and surface
against the port's own CPU path. Every test here needs a CUDA device
(and nvcc to build the kernels): without one it skips. On the card, run

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(the card machine has no jax, and tests/conftest.py imports it; nothing
here imports the JAX package). Each route's hand kernels are read
through the launch registry (utils/profiling.py::launch_counts): which
of them it launches, which it must not, and, for a detect, the same
counts eager, captured and replayed.

The kernels are held to: the DT bit for bit (values, and pointers at
live outputs); the conv (3xTF32) within 1e-5 * sum|x*w|, and its grouped
launch equal to single launches bit for bit; the DT's backward (K4)
bit for bit against its own order of the sums (dt1d_bwd_order_plain),
the same bits on every run, and within 1e-5 * sum|g| per source and 1e-5 *
sum|g*d^2|, sum|g*d| per map of dt1d_bwd_plain;
the adaptive-window DT (K5) bit for bit against its plain version, and
against K1 inside out_valid. Detect with the window DT gives the default
detect's candidates bit for bit; the Fourier and RGB-D detectors give the
CPU path's candidates. The transpose (T2) is exact for float32 and int32,
single and as a pair, and so is its gradient; the serving APIs give
detect's candidates, and the pyramid's features are the same bits alone,
in a batch of 8 and on the CPU. T1's
port (conv_proto) is within 1e-5 * sum|x*w| of its plain version and
equal to K2 bit for bit at every toh; the hybrid bf16 profile gives the
CPU path's candidates through K1, K2 and T2, and the QP trainers'
miner the CPU miner's placements, plain and latent. person26 read back
from .xml and .mat detects as the in-memory model bit for bit, and the
stream node (apps.stream.DetectionStream.process_stream) gives sorted,
NMS'd detect's candidates bit for bit. parallel/ at world size 1 over
NCCL gives detect_batch_fn's outputs bit for bit and make_train_step's
loss and pools within rtol 1e-4, atol 1e-5.
"""

import contextlib
import copy
import dataclasses
import io
import math
import os

import numpy as np
import pytest
import torch

from partsbaseddetector_tpu_torch.bench import _match_boxes
from partsbaseddetector_tpu_torch.utils.profiling import (
    HAND_FAMILIES, launch_counts, launches_since,
)

pytestmark = pytest.mark.cuda

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
# the conv (3xTF32) against the f32 correlation: 1e-5 * sum|x*w|
CONV_RTOL = 1e-5
# K4 against dt1d_bwd_plain: 1e-5 * sum|g| per source, 1e-5 * sum|g*d^2|
# and sum|g*d| per map (dt1d_bwd_magnitudes)
DT_BWD_RTOL = 1e-5
# a train step on the card against the CPU's
TRAIN_TOL = dict(rtol=1e-4, atol=1e-5)
VGA = (480, 640)
SMALL = (120, 160)
# the JAX package's visualize_model(make_person_like_model()) and
# hog_picture(<a 5x5 filter>) shapes (tests/test_torch_apps.py holds the
# port's to them on the CPU)
PERSON26_MOSAIC_SHAPE = (600, 680)
HOG_GLYPH_SHAPE = (100, 100)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("aux", [False, True])
@pytest.mark.parametrize(
    "h,w,dlen,step", [(40, 50, 37, 1), (33, 70, 17, 2), (9, 5, 130, 1)]
)
def test_dt_kernel_matches_plain(cuda, h, w, dlen, step, aux):
    from partsbaseddetector_tpu_torch.ops import dt_cuda

    gen = torch.Generator().manual_seed(h * w)
    bsz = 7
    src = torch.randn((bsz, h, w), generator=gen) * 3
    nv = torch.randint(0, h + 1, (bsz,), generator=gen, dtype=torch.int32)
    src = torch.where(torch.arange(h)[None, :, None] < nv[:, None, None], src, -torch.inf)
    a = -(0.01 + 0.05 * torch.rand((bsz,), generator=gen))
    b = 0.3 * torch.randn((bsz,), generator=gen)
    sh = torch.randint(-3, 4, (bsz,), generator=gen).float()
    ax = torch.randint(0, 4096, (bsz, h, w), generator=gen, dtype=torch.int32) if aux else None
    args = [t.to(cuda) for t in (src, a, b, sh, nv)]
    axd = ax.to(cuda) if aux else None
    before = launch_counts()
    got_v, got_p = dt_cuda.dt1d(*args[:4], dlen, step, nvalid=args[4], aux=axd)
    counted = launches_since(before)
    want_v, want_p = dt_cuda.dt1d_plain(*args, dlen, step, aux=axd)
    assert (counted["dt1d"], counted["dt1d_aux"]) == (1, int(aux))
    assert torch.equal(got_v, want_v)
    live = torch.isfinite(want_v)
    assert torch.equal(got_p[live], want_p[live])


@pytest.mark.parametrize(
    "name,bsz,h,w,dlen,step,aux,kind,ab",
    [
        ("fractional_shift", 5, 40, 50, 37, 1, True, "frac", None),
        ("fractional_shift_step2", 5, 40, 21, 30, 2, False, "frac", None),
        ("linear_penalty", 5, 30, 33, 30, 1, True, "int", (0.0, 0.5)),
        ("flat_penalty", 5, 30, 33, 30, 1, False, "int", (0.0, 0.0)),
        ("convex_penalty", 5, 30, 33, 30, 1, False, "int", (0.02, -0.3)),
        ("narrower_than_a_tile", 6, 50, 5, 45, 1, True, "int", None),
        ("one_column", 6, 50, 1, 45, 1, False, "int", None),
        ("h_over_one_chunk_ragged", 6, 37, 40, 29, 1, True, "int", None),
        ("dlen_not_a_multiple_of_a_run", 6, 40, 33, 13, 1, True, "int", None),
        ("dlen_one", 6, 40, 33, 1, 1, False, "int", None),
        ("dlen_beyond_h", 4, 20, 33, 150, 1, True, "int", None),
        ("more_rows_than_stay_resident", 2, 1100, 40, 70, 1, True, "int", None),
        ("resident_beyond_48k_of_shared_memory", 3, 1000, 20, 40, 1, True, "int", None),
        ("person26_x_pass", 80, 166, 126, 166, 1, True, "int", None),
        ("person26_y_pass", 80, 126, 166, 126, 1, False, "int", None),
        ("integer_ties", 8, 24, 40, 24, 1, False, "ties", None),
        ("integer_ties_aux", 8, 24, 40, 24, 1, True, "ties", None),
        ("every_other_map_dead", 6, 30, 33, 30, 1, True, "dead", None),
    ],
)
def test_dt_kernel_edge_shapes_match_plain(cuda, name, bsz, h, w, dlen, step,
                                           aux, kind, ab):
    """The redesigned K1 (register-blocked rows, shared penalties at
    integral shifts, chunk pruning) bit for bit against dt1d_plain where
    its paths change: the general path (fractional shift, step 2), a = 0
    and a > 0, tiles and runs that the map does not fill, the streamed
    path of tall maps, integer sources and weights (ties), half the maps
    dead, the person26 VGA finest bucket's passes, -inf tails and a dead
    map in every case."""
    from partsbaseddetector_tpu_torch.ops import dt_cuda

    gen = torch.Generator().manual_seed(h * w + dlen)
    if kind == "ties":
        src = torch.randint(-4, 5, (bsz, h, w), generator=gen).float()
    else:
        src = torch.randn((bsz, h, w), generator=gen) * 3
    nv = torch.randint(1, h + 1, (bsz,), generator=gen, dtype=torch.int32)
    nv[0], nv[1] = h, 0
    if kind == "dead":
        nv[::2] = 0
    src = torch.where(torch.arange(h)[None, :, None] < nv[:, None, None], src, -torch.inf)
    if kind == "ties":
        a = -torch.randint(1, 3, (bsz,), generator=gen).float()
        b = torch.randint(-2, 3, (bsz,), generator=gen).float()
    else:
        a = -(0.01 + 0.05 * torch.rand((bsz,), generator=gen))
        b = 0.3 * torch.randn((bsz,), generator=gen)
    if ab is not None:
        a.fill_(ab[0])
        b.fill_(ab[1])
    if kind == "frac":
        sh = torch.rand((bsz,), generator=gen) * 6 - 3
    else:
        sh = torch.randint(-3, 4, (bsz,), generator=gen).float()
    ax = torch.randint(0, 4096, (bsz, h, w), generator=gen, dtype=torch.int32) if aux else None
    args = [t.to(cuda) for t in (src, a, b, sh, nv)]
    axd = ax.to(cuda) if aux else None
    got_v, got_p = dt_cuda.dt1d(*args[:4], dlen, step, nvalid=args[4], aux=axd)
    want_v, want_p = dt_cuda.dt1d_plain(*args, dlen, step, aux=axd)
    assert torch.equal(got_v, want_v)
    live = torch.isfinite(want_v)
    assert torch.equal(got_p[live], want_p[live])
    assert bool((got_v[1] == -torch.inf).all()) and bool((got_p[1] == 0).all())


def test_dt_kernel_constants_and_refusals(cuda):
    """The run and chunk sizes the torch statement of the pruning rule
    assumes are the kernel's (K1 and K5 share them), and so is the warp
    count that sets the order of K4's sums; more than 65,535 maps are
    refused."""
    from partsbaseddetector_tpu_torch import kernels
    from partsbaseddetector_tpu_torch.ops import dt_cuda

    lib = kernels.library()
    assert lib.pbd_dt1d_rows() == dt_cuda.DT1D_ROWS
    assert lib.pbd_dt1d_chunk() == dt_cuda.DT1D_CHUNK
    for h in (1, 9, 66, 86, 224, 225, 500, 1792, 1793, 1900):
        for w in (1, 32, 66, 86, 166, 300):
            for dlen in (1, 2, 5, 66, 86, 200):
                got = (lib.pbd_dt1d_bwd_strips(h, w, dlen),
                       lib.pbd_dt1d_bwd_segments(h, w, dlen))
                assert got == dt_cuda.dt1d_bwd_layout(h, w, dlen)
    src = torch.zeros((65536, 2, 2), device=cuda)
    zeros = torch.zeros((65536,), device=cuda)
    with pytest.raises(ValueError, match="exceed one launch"):
        dt_cuda.dt1d(src, zeros - 1, zeros, zeros, 2)


# (12, 12) filters need more than 48 KB of shared memory per block; F =
# 130 takes two blocks along N; (5, 130, 170) x 104 is the person26 VGA
# table shape, once more with every third filter's last rows zero (the
# bank's smaller filters zero-padded); C = 12 is no multiple of 8 (zero
# channels in the k8 steps)
@pytest.mark.parametrize(
    "s,h,w,c,f,fh,fw,padded",
    [(3, 40, 53, 32, 70, 5, 4, False), (1, 30, 31, 32, 3, 12, 12, False),
     (2, 9, 20, 8, 130, 2, 3, False), (5, 130, 170, 32, 104, 5, 5, False),
     (2, 17, 19, 12, 9, 3, 3, False), (5, 130, 170, 32, 104, 5, 5, True)],
)
def test_conv_kernel_matches_plain(cuda, s, h, w, c, f, fh, fw, padded):
    from partsbaseddetector_tpu_torch.ops import conv, conv_cuda

    gen = torch.Generator().manual_seed(s * f)
    feat = torch.rand((s, h, w, c), generator=gen).to(cuda)
    filt = (0.1 * torch.randn((f, fh, fw, c), generator=gen)).to(cuda)
    if padded:
        filt[::3, 3:, :, :] = 0.0
    before = launch_counts()
    got = conv_cuda.filter_responses_infer(feat, filt)
    assert launches_since(before)["conv"] == 1
    want = conv.filter_responses(feat, filt)
    bound = CONV_RTOL * conv.filter_responses(feat.abs(), filt.abs())
    assert got.shape == want.shape
    assert bool(((got - want).abs() <= bound).all())


def test_grouped_conv_equals_one_launch_per_stack(cuda):
    """A detect's buckets in one grouped launch: each output equals its
    own launch bit for bit, more than 16 stacks take more launches."""
    from partsbaseddetector_tpu_torch.ops import conv_cuda

    gen = torch.Generator().manual_seed(11)
    filt = (0.1 * torch.randn((104, 5, 5, 32), generator=gen)).to(cuda)
    shapes = [(10, 130, 170), (10, 70, 90), (5, 40, 53), (1, 12, 13)] * 5
    feats = [torch.rand((s, h, w, 32), generator=gen).to(cuda) for s, h, w in shapes]
    before = launch_counts()
    got = conv_cuda.filter_responses_grouped(feats, filt)
    assert launches_since(before)["conv"] == 2  # 20 stacks: 16 + 4
    for g, x in zip(got, feats):
        assert torch.equal(g, conv_cuda.filter_responses_infer(x, filt))


@pytest.mark.parametrize("model", ["person26", "face39", "face68"])
def test_detect_passes_the_bank_split_once_per_model(cuda, model, monkeypatch):
    """to_device splits the filter bank into its TF32 pieces once; every
    bucket of a VGA detect goes to K2 in one grouped call that stages that
    split; the launch again on the detect's own stacks gives its
    responses bit for bit, each within CONV_RTOL * sum|x*w| of the f32
    correlation (person26: ten buckets, F = 156; the face model: F = 117,
    a partial last tile; face68: F = 204, two N blocks); a bank of
    another shape is refused."""
    from partsbaseddetector_tpu_torch import PartsBasedDetector, pipeline
    from partsbaseddetector_tpu_torch.ops import conv, conv_cuda

    mdl, kw, _ = _detect_profile({"person26": "f32"}.get(model, model))
    det = PartsBasedDetector(mdl, device=cuda, **kw)
    dm = det._dmodel
    assert torch.equal(dm.filters_split, conv_cuda.split_bank(dm.filters))
    calls = []
    orig = pipeline.filter_responses_grouped

    def record(feats, filt, bank=None):
        outs = orig(feats, filt, bank)
        calls.append((feats, filt, bank, [o.clone() for o in outs]))
        return outs

    monkeypatch.setattr(pipeline, "filter_responses_grouped", record)
    det.detect(_vga_frame())
    ((feats, filt, bank, seen),) = calls
    assert bank is dm.filters_split
    before = launch_counts()
    got = conv_cuda.filter_responses_grouped(feats, filt, bank)
    assert launches_since(before)["conv"] == 1
    for x, g, s in zip(feats, got, seen):
        assert torch.equal(g, s)
        want = conv.filter_responses(x, filt)
        bound = CONV_RTOL * conv.filter_responses(x.abs(), filt.abs())
        assert g.shape == want.shape and bool(((g - want).abs() <= bound).all())
    feat = torch.rand((1, 12, 12, 32), device=cuda)
    with pytest.raises(ValueError, match="split bank"):
        conv_cuda.filter_responses_grouped([feat], dm.filters, dm.filters_split[:, :3])


def test_golden_fixture_on_cuda(cuda):
    from partsbaseddetector_tpu_torch import PartsBasedDetector, load_model

    model = load_model(os.path.join(FIX, "golden_model.npz"))
    g = np.load(os.path.join(FIX, "golden_detections.npz"))
    got = PartsBasedDetector(model, max_detections=64, device=cuda).detect(g["image"])
    assert len(got) == len(g["scores"])
    for c, boxes, score in zip(got, g["boxes"], g["scores"]):
        assert abs(c.score - score) < 2e-3
        np.testing.assert_allclose(c.parts, boxes, atol=5e-2)


@pytest.mark.parametrize(
    "bsz,h,w,dlen,step,aux,ints,dead",
    [
        (7, 40, 50, 37, 1, False, False, False),  # y pass
        (7, 50, 40, 45, 1, True, False, False),  # x pass with aux
        (5, 36, 20, 15, 2, False, False, False),  # step 2
        (6, 24, 40, 24, 1, True, True, False),  # integer ties
        (6, 30, 33, 30, 1, True, False, True),  # dead outputs
        (5, 9, 70, 5, 1, False, False, False),  # fewer rows than warps
        (4, 20, 300, 17, 1, True, False, False),  # more strips than warps
        (320, 66, 86, 66, 1, False, False, False),  # person26 240x320 y pass
        (320, 86, 66, 86, 1, True, False, False),  # and its x pass
        (2, 1900, 40, 60, 1, True, False, False),  # too tall for a slab
    ],
)
def test_dt_backward_kernel_matches_plain(cuda, bsz, h, w, dlen, step, aux, ints, dead):
    """K4 against dt1d_bwd_order_plain bit for bit (its own order of the
    sums, at the layout it states), the same bits on a second run,
    and against dt1d_bwd_plain within 1e-5 * sum|g| per source and 1e-5
    * sum|g*d^2|, sum|g*d| per map; the tallest map takes the kernel's
    global-memory path."""
    from partsbaseddetector_tpu_torch import kernels
    from partsbaseddetector_tpu_torch.ops import dt_cuda

    gen = torch.Generator().manual_seed(bsz * h + w)
    if ints:
        src = torch.randint(-4, 5, (bsz, h, w), generator=gen).float()
        a = -torch.randint(1, 3, (bsz,), generator=gen).float()
        b = torch.randint(-2, 3, (bsz,), generator=gen).float()
        g = torch.randint(-3, 4, (bsz, dlen, w), generator=gen).float()
    else:
        src = torch.randn((bsz, h, w), generator=gen) * 3
        a = -(0.01 + 0.05 * torch.rand((bsz,), generator=gen))
        b = 0.3 * torch.randn((bsz,), generator=gen)
        g = torch.randn((bsz, dlen, w), generator=gen)
    nv = torch.full((bsz,), h, dtype=torch.int32)
    if dead:
        nv[::2] = 0
    sh = torch.randint(-3, 4, (bsz,), generator=gen).float()
    ax = torch.randint(0, 4096, (bsz, h, w), generator=gen, dtype=torch.int32) if aux else None
    src, a, b, sh, nv, g = (t.to(cuda) for t in (src, a, b, sh, nv, g))
    ax = ax.to(cuda) if aux else None
    out, ptr = dt_cuda.dt1d(src, a, b, sh, dlen, step, nvalid=nv, aux=ax)
    assert bool((out == -torch.inf).any()) == dead
    before = launch_counts()
    got = dt_cuda.dt1d_bwd(g, out, ptr, sh, h, step, aux)
    again = dt_cuda.dt1d_bwd(g, out, ptr, sh, h, step, aux)
    assert launches_since(before)["dt1d_bwd"] == 2
    lib = kernels.library()
    strips, segments = lib.pbd_dt1d_bwd_strips(h, w, dlen), lib.pbd_dt1d_bwd_segments(h, w, dlen)
    assert (strips == 0) == (h == 1900)
    exact = dt_cuda.dt1d_bwd_order_plain(g, out, ptr, sh, h, step, aux, max(1, strips), segments)
    for x, y, z in zip(got, exact, again):
        assert torch.equal(x, y)
        assert torch.equal(x, z)
    want = dt_cuda.dt1d_bwd_plain(g, out, ptr, sh, h, step, aux)
    # g_src within 1e-5 * sum|g| per source, g_a and g_b within 1e-5 *
    # sum|g*d^2| and sum|g*d| per map: the kernel sums in another order
    scale = dt_cuda.dt1d_bwd_magnitudes(g, out, ptr, sh, h, step, aux)
    for x, y, m in zip(got, want, scale):
        assert x.shape == y.shape
        assert bool(((x - y).abs() <= DT_BWD_RTOL * m).all())


def test_dt_autograd_on_cuda_matches_cpu(cuda):
    """dt1d(differentiable=True) launches the forward and the backward
    kernel on the card and gives the CPU path's gradients."""
    from partsbaseddetector_tpu_torch.ops import dt_cuda

    gen = torch.Generator().manual_seed(5)
    src = torch.randn((3, 4, 21, 17), generator=gen)
    a = -(0.01 + 0.05 * torch.rand((4,), generator=gen))
    b = 0.3 * torch.randn((4,), generator=gen)
    cot = torch.randn((3, 4, 19, 17), generator=gen)
    grads = []
    for dev in ("cpu", cuda):
        leaves = [t.to(dev).clone().requires_grad_() for t in (src, a, b)]
        before = launch_counts()
        out, _ = dt_cuda.dt1d(*leaves, torch.zeros((), device=dev), 19, 1,
                              differentiable=True)
        (out * cot.to(dev)).sum().backward()
        assert launches_since(before)["dt1d_bwd"] == (dev != "cpu")
        grads.append([t.grad.cpu() for t in leaves])
    for x, y in zip(*grads):
        torch.testing.assert_close(y, x, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("aux", [False, True])
@pytest.mark.parametrize(
    "h,w,dlen,ints,ab",
    [
        (40, 50, 37, False, None),  # y pass
        (50, 40, 45, False, None),  # x pass shape
        (24, 40, 24, True, None),  # integer ties
        (30, 33, 30, False, (0.0, 0.0)),  # flat penalty
        (30, 33, 30, False, (0.0, 0.5)),  # linear penalty
        (126, 166, 126, False, None),  # person26 VGA finest bucket
    ],
)
def test_window_kernel_matches_plain_and_k1(cuda, h, w, dlen, ints, ab, aux):
    from partsbaseddetector_tpu_torch.ops import dt_cuda

    gen = torch.Generator().manual_seed(h * w + dlen)
    bsz = 9
    if ints:
        src = torch.randint(-4, 5, (bsz, h, w), generator=gen).float()
        a = -torch.randint(1, 3, (bsz,), generator=gen).float()
        b = torch.randint(-2, 3, (bsz,), generator=gen).float()
    else:
        src = torch.randn((bsz, h, w), generator=gen) * 3
        a = -(0.01 + 0.05 * torch.rand((bsz,), generator=gen))
        b = 0.3 * torch.randn((bsz,), generator=gen)
    if ab is not None:
        a.fill_(ab[0])
        b.fill_(ab[1])
    nv = torch.randint(0, h + 1, (bsz,), generator=gen, dtype=torch.int32)
    nv[0] = h
    nv[1] = 0  # an all-dead map
    src = torch.where(torch.arange(h)[None, :, None] < nv[:, None, None], src, -torch.inf)
    sh = torch.randint(-3, 4, (bsz,), generator=gen).float()
    ov = torch.randint(0, dlen + 1, (bsz, w), generator=gen, dtype=torch.int32)
    ov[:, 0], ov[:, 1] = 0, dlen
    ax = torch.randint(0, 4096, (bsz, h, w), generator=gen, dtype=torch.int32) if aux else None
    src, a, b, sh, nv, ov = (t.to(cuda) for t in (src, a, b, sh, nv, ov))
    ax = ax.to(cuda) if aux else None
    before = launch_counts()
    got_v, got_p = dt_cuda.dt1d_window(src, a, b, sh, dlen, ov, nvalid=nv, aux=ax)
    assert launches_since(before)["dt1d_window"] == 1
    want_v, want_p = dt_cuda.dt1d_window_plain(src, a, b, sh, nv, ov, dlen, ax)
    assert torch.equal(got_v, want_v)
    assert torch.equal(got_p, want_p)
    k1_v, k1_p = dt_cuda.dt1d(src, a, b, sh, dlen, 1, nvalid=nv, aux=ax)
    inside = torch.arange(dlen, device=cuda)[None, :, None] < ov[:, None, :]
    assert torch.equal(got_v[inside], k1_v[inside])
    assert torch.equal(got_p[inside], k1_p[inside])
    assert bool((got_v[~inside] == -torch.inf).all()) and bool((got_p[~inside] == 0).all())


@pytest.mark.parametrize(
    "name,bsz,h,w,dlen,ov,shift,aux",
    [
        ("out_valid_all_zero", 6, 40, 50, 37, "zero", "int", True),
        ("out_valid_all_dlen", 6, 40, 50, 37, "full", "int", False),
        ("out_valid_ragged", 6, 40, 50, 37, "ragged", "int", True),
        ("out_valid_one_column_live", 6, 60, 70, 60, "one", "int", False),
        ("streamed_tall_map", 2, 1100, 40, 70, "ragged", "int", True),
        ("streamed_tall_map_all_dead", 2, 1100, 40, 70, "zero", "int", False),
        ("shift_beyond_2_22", 5, 40, 33, 37, "ragged", "huge", True),
    ],
)
def test_window_kernel_extents_tall_maps_and_large_shifts(cuda, name, bsz, h, w, dlen,
                                                          ov, shift, aux):
    """K5 on K1's core where the window form changes what runs: blocks
    and warps with no live row (out_valid all 0, one live column), no
    don't-care output at all (all dlen, K1's work), the streamed path of
    maps taller than stay resident, and integral shifts beyond 2^22,
    which take the general path. Bit for bit against its plain version,
    equal to K1 inside out_valid."""
    from partsbaseddetector_tpu_torch.ops import dt_cuda

    gen = torch.Generator().manual_seed(h * w + dlen + len(name))
    src = torch.randn((bsz, h, w), generator=gen) * 3
    nv = torch.randint(1, h + 1, (bsz,), generator=gen, dtype=torch.int32)
    nv[0], nv[1] = h, 0
    src = torch.where(torch.arange(h)[None, :, None] < nv[:, None, None], src, -torch.inf)
    a = -(0.01 + 0.05 * torch.rand((bsz,), generator=gen))
    b = 0.3 * torch.randn((bsz,), generator=gen)
    sh = torch.randint(-3, 4, (bsz,), generator=gen).float()
    if shift == "huge":
        sh = sh + float(2**22 + 5)
    ovt = {
        "zero": torch.zeros((bsz, w), dtype=torch.int32),
        "full": torch.full((bsz, w), dlen, dtype=torch.int32),
        "ragged": torch.randint(0, dlen + 1, (bsz, w), generator=gen, dtype=torch.int32),
        "one": torch.zeros((bsz, w), dtype=torch.int32).index_fill_(1, torch.tensor([w // 2]), dlen),
    }[ov]
    ax = torch.randint(0, 4096, (bsz, h, w), generator=gen, dtype=torch.int32) if aux else None
    src, a, b, sh, nv, ovt = (t.to(cuda) for t in (src, a, b, sh, nv, ovt))
    ax = ax.to(cuda) if aux else None
    got_v, got_p = dt_cuda.dt1d_window(src, a, b, sh, dlen, ovt, nvalid=nv, aux=ax)
    want_v, want_p = dt_cuda.dt1d_window_plain(src, a, b, sh, nv, ovt, dlen, ax)
    assert torch.equal(got_v, want_v)
    assert torch.equal(got_p, want_p)
    k1_v, k1_p = dt_cuda.dt1d(src, a, b, sh, dlen, 1, nvalid=nv, aux=ax)
    inside = torch.arange(dlen, device=cuda)[None, :, None] < ovt[:, None, :]
    assert torch.equal(got_v[inside], k1_v[inside])
    assert torch.equal(got_p[inside], k1_p[inside])
    assert bool((got_v[~inside] == -torch.inf).all()) and bool((got_p[~inside] == 0).all())


def test_window_kernel_on_a_window_detects_passes(cuda):
    """K5 on the y and x passes of the largest group of a person26 VGA
    detect with PBD_DT_WINDOW=1, with the consumer extents the detect
    gave it (tools/kernel_variants.py::window_passes): bit for bit its
    plain version, K1 inside out_valid, (-inf, 0) beyond."""
    from partsbaseddetector_tpu_torch import PartsBasedDetector, make_person_like_model
    from partsbaseddetector_tpu_torch.ops import dt_cuda
    from partsbaseddetector_tpu_torch.tools.kernel_variants import window_passes

    det = PartsBasedDetector(make_person_like_model(), buckets_per_octave=2, device=cuda)
    for src, a, b, sh, nv, ov, dlen, ax in window_passes(torch, det, _vga_frame()):
        got_v, got_p = dt_cuda.dt1d_window(src, a, b, sh, dlen, ov, nvalid=nv, aux=ax)
        want_v, want_p = dt_cuda.dt1d_window_plain(src, a, b, sh, nv, ov, dlen, ax)
        assert torch.equal(got_v, want_v) and torch.equal(got_p, want_p)
        k1_v, k1_p = dt_cuda.dt1d(src, a, b, sh, dlen, 1, nvalid=nv, aux=ax)
        inside = torch.arange(dlen, device=cuda)[None, :, None] < ov[:, None, :]
        assert bool(inside.any()) and bool((~inside).any())
        assert torch.equal(got_v[inside], k1_v[inside])
        assert torch.equal(got_p[inside], k1_p[inside])
        assert bool((got_v[~inside] == -torch.inf).all()) and bool((got_p[~inside] == 0).all())


def _same_candidates(got, want, score_tol=0.0, box_tol=0.0):
    assert len(got) == len(want) > 0
    for x, y in zip(got, want):
        assert abs(x.score - y.score) <= score_tol
        assert float(np.abs(x.parts - y.parts).max()) <= box_tol
        assert x.component == y.component
        np.testing.assert_array_equal(x.mixtures, y.mixtures)


def _person_frame():
    from partsbaseddetector_tpu_torch import make_person_like_model

    model = make_person_like_model()
    model.thresh = -1e9
    im = (np.random.RandomState(0).rand(120, 160, 3) * 255).astype(np.uint8)
    return model, im


def test_window_detect_equals_default_on_cuda(cuda, monkeypatch):
    from partsbaseddetector_tpu_torch import PartsBasedDetector
    from partsbaseddetector_tpu_torch.ops import dt_cuda

    model, im = _person_frame()
    det = PartsBasedDetector(model, max_detections=32, buckets_per_octave=2, device=cuda)
    want = det.detect(im)
    monkeypatch.setenv("PBD_DT_WINDOW", "1")
    before = launch_counts()
    got = det.detect(im)
    assert launches_since(before)["dt1d_window"] > 0
    _same_candidates(got, want)


def _vga_frame(seed=0):
    """A seeded uint8 frame of VGA size, as the benchmark's frames are
    drawn (uniform noise)."""
    return torch.randint(0, 256, (*VGA, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(seed)).numpy()


def _shifted(im, n):
    """n distinct frames: im shifted by 0..n-1 grey levels."""
    return [np.clip(im.astype(np.int16) + i, 0, 255).astype(np.uint8) for i in range(n)]


def _depth_mm(shape, seed):
    """A seeded uint16 depth frame of 1-2 m, in millimetres."""
    return ((1.0 + np.random.RandomState(seed).rand(*shape)) * 1000.0).astype(np.uint16)


def _launched(before, launched=(), zero=()):
    """The hand kernels' launches since `before` (a launch_counts()
    reading): every family of `launched` ran, none of `zero` did."""
    got = launches_since(before)
    assert all(got[k] > 0 for k in launched), got
    assert not any(got[k] for k in zero), got
    return got


def _same_dense(got, want):
    for field in ("boxes", "scores", "components", "valid", "mixtures", "depth_keep"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


def _face68():
    """The frontal face's part count (68 landmarks) at the face model's
    shape: 3 mixtures, 5x5 filters, sbin 4, interval 5; F = 204 filters,
    two N blocks of K2."""
    from partsbaseddetector_tpu_torch.models.model import make_synthetic_model

    return make_synthetic_model(name="face68", nparts=68, nmix=3, fsize=(5, 5), sbin=4,
                                interval=5, thresh=0.25, seed=0)


def _detect_profile(name):
    """(model, detector options, the hand kernels its detect launches) of
    each detect profile; it launches no other."""
    from partsbaseddetector_tpu_torch import make_face_like_model, make_person_like_model
    from partsbaseddetector_tpu_torch.depth import DepthGate

    person = dict(buckets_per_octave=2, max_detections=32)
    face = dict(buckets_per_octave=1, max_detections=32)
    with_k2 = ("dt1d", "dt1d_aux", "conv", "transpose")
    no_k2 = ("dt1d", "dt1d_aux", "transpose")
    make, kw, launched = {
        "f32": (make_person_like_model, person, with_k2),
        "fourier": (make_person_like_model, dict(person, conv_engine="fourier"), no_k2),
        "rgbd": (make_person_like_model,
                 dict(person, max_detections=16, device_depth_filter=True,
                      depth_gate=DepthGate(object_width_m=0.6, fx=10.0, tolerance=0.5)),
                 with_k2),
        "nms": (make_person_like_model, dict(person, nms_overlap=0.3), with_k2),
        "hybrid": (make_person_like_model, dict(person, dtype=torch.bfloat16), with_k2),
        # cuDNN's bf16 conv2d where the JAX package runs lax.conv: no K2
        "bf16_plain": (make_person_like_model,
                       dict(person, dtype=torch.bfloat16, rerank_fp32=False), no_k2),
        "face39": (make_face_like_model, face, with_k2),
        "face68": (_face68, face, with_k2),
    }[name]
    model = make()
    model.thresh = -1e9
    return model, kw, launched


DETECT_PROFILES = ["f32", "fourier", "rgbd", "nms", "hybrid", "bf16_plain", "face39", "face68"]


@pytest.mark.parametrize("profile", DETECT_PROFILES)
def test_every_detect_profile_on_the_card_matches_cpu(cuda, profile):
    """Each detect profile on a VGA frame: its hand kernels launched
    (and no other), the same counts and the same dense outputs at a
    shape's eager, captured and replayed call, finite candidates of the
    model's part count; at 120x160 the CPU path's candidates: scores
    within 1e-4 and boxes 1e-3, the hybrid's within 1e-5 x its top score
    and 1e-4, the plain bf16's 80% by box (0.75 px) with scores within
    0.05, and the depth profile's keep mask equal. Fourier: the spatial
    engine's valid mask at VGA and scores within 5e-3. Device NMS: it
    suppresses, and its keep mask over 8 VGA frames is host part_nms's."""
    from partsbaseddetector_tpu_torch import PartsBasedDetector

    model, kw, launched = _detect_profile(profile)
    zero = [k for k in HAND_FAMILIES if k not in launched]
    im = _vga_frame()
    depth = _depth_mm(VGA, 1) if profile == "rgbd" else None
    det = PartsBasedDetector(model, device=cuda, **kw)
    runs, counts = [], []
    for _ in range(3):  # eager, captured, replayed
        before = launch_counts()
        runs.append(det.detect_dense(im, depth))
        counts.append(_launched(before, launched, zero))
    assert counts[0] == counts[1] == counts[2]
    for run in runs[1:]:
        _same_dense(run, runs[0])
    first = runs[0]
    assert first.valid.any() and np.isfinite(first.scores[first.valid]).all()
    for c in first.to_candidates():
        assert c.parts.shape == (len(model.parentid[c.component]), 4)
        assert np.isfinite(c.parts).all()

    h, w = SMALL
    small = im[:h, :w]
    dsmall = None if depth is None else depth[:h, :w]
    got = det.detect_dense(small, dsmall)
    want = PartsBasedDetector(model, device="cpu", **kw).detect_dense(small, dsmall)
    if profile == "bf16_plain":
        nq, nm, dmax = _match_boxes(want.boxes, want.scores, want.valid,
                                    got.boxes, got.scores, got.valid)
        assert nm >= max(1, int(0.8 * nq)) and dmax <= 0.05, (nm, nq, dmax)
    else:
        if depth is not None:
            np.testing.assert_array_equal(got.depth_keep, want.depth_keep)
        tol = (1e-4, 1e-3)
        if profile == "hybrid":
            tol = (1e-5 * max(1.0, abs(float(want.scores[0]))), 1e-4)
        _same_candidates(got.to_candidates(), want.to_candidates(), *tol)

    if profile == "hybrid":
        # the f32 re-rank's parity at 240x320: the top-1 boxes within
        # 0.75 px and its score within 1e-3 of f32's, 80% of the
        # candidates box-matched; rerank_fp32 at f32 gives plain f32's
        mid = im[:240, :320]
        f32 = dict(buckets_per_octave=2, max_detections=16, device=cuda)
        o32 = PartsBasedDetector(model, **f32).detect_dense(mid)
        ohy = PartsBasedDetector(model, dtype=torch.bfloat16, **f32).detect_dense(mid)
        assert o32.valid[0] and ohy.valid[0]
        assert float(np.abs(o32.boxes[0] - ohy.boxes[0]).max()) <= 0.75
        assert abs(float(o32.scores[0]) - float(ohy.scores[0])) <= 1e-3
        nq, nm, _ = _match_boxes(o32.boxes, o32.scores, o32.valid,
                                 ohy.boxes, ohy.scores, ohy.valid)
        assert nm >= max(1, int(0.8 * nq)), (nm, nq)
        _same_candidates(PartsBasedDetector(model, rerank_fp32=True, **f32).detect(mid),
                         PartsBasedDetector(model, **f32).detect(mid), 2e-5, 1e-4)
    if profile == "fourier":
        spatial = PartsBasedDetector(model, device=cuda, **dict(kw, conv_engine="spatial"))
        ref = spatial.detect_dense(im)
        np.testing.assert_array_equal(first.valid, ref.valid)
        assert float(np.abs(first.scores - ref.scores)[first.valid].max()) <= 5e-3
    if profile == "nms":
        from partsbaseddetector_tpu_torch.ops import nms

        plain = PartsBasedDetector(model, device=cuda, **dict(kw, nms_overlap=None))
        assert 0 < len(got.to_candidates()) < len(plain.detect(small))
        frames = torch.as_tensor(np.stack(_shifted(im, 8)), device=cuda)
        boxes, scores, _, valid, _ = plain.detect_batch_fn(VGA, 8)(frames)
        keep = nms.part_nms_device(boxes, scores, valid, 0.3).cpu().numpy()
        for i in range(8):
            live = np.flatnonzero(valid[i].cpu().numpy())
            host = live[nms.part_nms(boxes[i].cpu().numpy()[live],
                                     scores[i].cpu().numpy()[live], 0.3)]
            np.testing.assert_array_equal(np.sort(host), np.flatnonzero(keep[i]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize(
    "shape",
    [(1, 1, 1), (3, 33, 31), (80, 126, 166), (2, 5, 40, 64), (70000, 3, 2)],
)
def test_transpose_kernel_matches_plain(cuda, shape, dtype):
    """T2 bit for bit, including ragged tiles and more maps than one
    grid axis of 65,535 blocks would hold."""
    from partsbaseddetector_tpu_torch.ops import transpose_cuda as tc

    gen = torch.Generator().manual_seed(sum(shape))
    if dtype == torch.float32:
        x = torch.randn(shape, generator=gen)
        x.view(-1)[::7] = -torch.inf
    else:
        x = torch.randint(-2**31, 2**31 - 1, shape, generator=gen, dtype=torch.int32)
    x = x.to(cuda)
    before = launch_counts()
    got = tc.transpose_last2(x)
    assert launches_since(before)["transpose"] == 1
    want = tc.transpose_last2_plain(x)
    assert got.shape == want.shape and got.is_contiguous()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize(
    "shape",
    [(1, 1, 1), (3, 33, 31), (80, 126, 166), (80, 166, 126), (2, 5, 40, 64),
     (7, 65, 130), (70000, 3, 2)],
)
def test_transpose_pair_kernel_matches_plain(cuda, shape):
    """A float32 + int32 pair in one launch, bit for bit: ragged tiles,
    one word past a tile (65, 130), more maps than one grid axis of
    65,535 blocks would hold."""
    from partsbaseddetector_tpu_torch.ops import transpose_cuda as tc

    gen = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(shape, generator=gen)
    x.view(-1)[::7] = -torch.inf
    y = torch.randint(-2**31, 2**31 - 1, shape, generator=gen, dtype=torch.int32)
    x, y = x.to(cuda), y.to(cuda)
    before = launch_counts()
    xt, yt = tc.transpose_last2_pair(x, y)
    assert launches_since(before)["transpose"] == 1
    for got, src in ((xt, x), (yt, y)):
        want = tc.transpose_last2_plain(src)
        assert got.dtype == src.dtype and got.shape == want.shape and got.is_contiguous()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_transpose_pair_kernel_edges_and_gradient(cuda):
    """Empty tensors launch nothing; mismatched shapes are refused; the
    pair's backward transposes the values' cotangent in one launch."""
    from partsbaseddetector_tpu_torch.ops import transpose_cuda as tc

    before = launch_counts()
    xt, yt = tc.transpose_last2_pair(
        torch.empty((0, 4, 5), device=cuda),
        torch.empty((0, 4, 5), dtype=torch.int32, device=cuda))
    assert xt.shape == yt.shape == (0, 5, 4) and launch_counts() == before
    with pytest.raises(ValueError, match="shapes .* differ"):
        tc.transpose_last2_pair(torch.zeros((2, 3, 4), device=cuda),
                                torch.zeros((2, 4, 3), device=cuda))
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((4, 37, 45), generator=gen).to(cuda).requires_grad_()
    y = torch.randint(0, 99, (4, 37, 45), generator=gen, dtype=torch.int32).to(cuda)
    cot = torch.randn((4, 45, 37), generator=gen).to(cuda)
    before = launch_counts()
    xt, yt = tc.transpose_last2_pair(x, y)
    (xt * cot).sum().backward()
    assert launches_since(before)["transpose"] == 2  # the pair forward, one backward
    assert torch.equal(x.grad, tc.transpose_last2_plain(cot))
    assert torch.equal(yt, tc.transpose_last2_plain(y))


def test_transpose_kernel_gradient(cuda):
    from partsbaseddetector_tpu_torch.ops import transpose_cuda as tc

    gen = torch.Generator().manual_seed(3)
    x = torch.randn((4, 37, 45), generator=gen).to(cuda).requires_grad_()
    cot = torch.randn((4, 45, 37), generator=gen).to(cuda)
    before = launch_counts()
    (tc.transpose_last2(x) * cot).sum().backward()
    assert launches_since(before)["transpose"] == 2  # forward and backward
    assert torch.equal(x.grad, tc.transpose_last2_plain(cot))


def test_transpose_pair_kernel_on_a_detects_and_a_microbatchs_pairs(cuda, monkeypatch):
    """T2 bit for bit on every x-pass transpose pair of one person26 VGA
    detect and of one microbatch-8 program (the maps of 8 images folded
    together), recorded at each shape's first, eager, call."""
    from partsbaseddetector_tpu_torch import PartsBasedDetector, make_person_like_model
    from partsbaseddetector_tpu_torch.ops import distance_transform as dtm
    from partsbaseddetector_tpu_torch.ops import transpose_cuda as tc

    det = PartsBasedDetector(make_person_like_model(), buckets_per_octave=2, device=cuda)
    im = _vga_frame()
    pairs = {}
    orig = dtm.transpose_last2_pair
    for run, key in ((lambda: det.detect(im), "detect"),
                     (lambda: det.detect_many(_shifted(im, 8), microbatch=8), "microbatch 8")):
        calls = pairs.setdefault(key, [])
        with monkeypatch.context() as m:
            m.setattr(dtm, "transpose_last2_pair",
                      lambda x, y, calls=calls: (calls.append((x, y)), orig(x, y))[1])
            run()
    assert pairs["detect"] and pairs["microbatch 8"]
    for key, calls in pairs.items():
        for i, (x, y) in enumerate(calls):
            before = launch_counts()
            xt, yt = tc.transpose_last2_pair(x, y)
            assert launches_since(before)["transpose"] == 1
            for got, src in ((xt, x), (yt, y)):
                want = tc.transpose_last2_plain(src)
                assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (key, i)


def _serving_tol(s):
    """The serving tolerance against detect: 1e-5 x the top score, 1e-4."""
    return 1e-5 * max(1.0, abs(s[0].score)), 1e-4


def _serving_match(got, singles, top=None):
    """Each frame's candidates are its detect's (cut to the best `top`)
    within the serving tolerance, or both are empty."""
    assert len(got) == len(singles) and singles[0]
    for g, s in zip(got, singles):
        if s:
            _same_candidates(g, s[:top], *_serving_tol(s))
        else:
            assert g == []


@pytest.mark.parametrize("profile", ["f32", "hybrid", "rgbd_stream", "f32_vga", "hybrid_vga"])
def test_serving_apis_on_cuda_match_detect(cuda, profile):
    """f32 and the hybrid profile: detect_batch, detect_many (pipelined,
    microbatch 3 with padding) and detect_stream on the card give
    detect's candidates, the per-frame paths exactly (f32: detect_batch
    too, the packed readback exact), the batched ones within the serving
    tolerance. rgbd_stream: detect_stream over 12 VGA frames, RGB and
    (RGB, uint16 depth) mixed, the depth gate and the device depth filter
    on, lookahead 4, 2 workers, readback_batch 3: detect's candidates in
    order. f32_vga and hybrid_vga: person26 at its own threshold on 16
    VGA frames, detect_many(microbatch=8) through K1, K2 and T2 within
    the serving tolerance of detect; f32_vga also the pipelined path
    with prefetch 6 and the readback cut to the best 64."""
    from partsbaseddetector_tpu_torch import PartsBasedDetector, make_person_like_model
    from partsbaseddetector_tpu_torch.depth import DepthGate

    if profile.endswith("_vga"):
        kw = {"dtype": torch.bfloat16} if profile == "hybrid_vga" else {}
        det = PartsBasedDetector(make_person_like_model(), buckets_per_octave=2,
                                 device=cuda, **kw)
        frames = _shifted(_vga_frame(), 16)
        singles = [det.detect(f) for f in frames]
        before = launch_counts()
        got = det.detect_many(frames, microbatch=8)
        _launched(before, ("dt1d", "conv", "transpose"))
        _serving_match(got, singles)
        if profile == "f32_vga":
            before = launch_counts()
            got = det.detect_many(frames, prefetch=6, readback_top=64)
            _launched(before, ("dt1d", "conv", "transpose"))
            _serving_match(got, singles, top=64)
        return
    model, im = _person_frame()
    if profile == "rgbd_stream":
        det = PartsBasedDetector(
            model, max_detections=16, buckets_per_octave=2, device=cuda,
            device_depth_filter=True,
            depth_gate=DepthGate(object_width_m=0.6, fx=10.0, tolerance=0.5))
        frames = [f if i % 3 == 2 else (f, _depth_mm(VGA, 6 + i))
                  for i, f in enumerate(_shifted(_vga_frame(), 12))]
        args = lambda f: f if isinstance(f, tuple) else (f,)
        want = [det.detect(*args(f)) for f in frames]
        got = list(det.detect_stream(frames, lookahead=4, workers=2, readback_batch=3))
        assert len(got) == len(want) and any(want)
        for g, w in zip(got, want):
            if w:
                _same_candidates(g, w)
            else:
                assert g == []
        return
    kw = {"dtype": torch.bfloat16} if profile == "hybrid" else {}
    det = PartsBasedDetector(model, max_detections=16, buckets_per_octave=2,
                             device=cuda, **kw)
    ims = [np.clip(im.astype(np.int32) + i, 0, 255).astype(np.uint8) for i in range(4)]
    singles = [det.detect(x) for x in ims]
    for got in (det.detect_many(ims, prefetch=2),
                list(det.detect_stream(ims, lookahead=2, workers=1))):
        for g, s in zip(got, singles):
            _same_candidates(g, s)
    for g, s in zip(det.detect_batch(ims), singles):
        _same_candidates(g, s, *((0.0, 0.0) if profile == "f32" else _serving_tol(s)))
    for g, s in zip(det.detect_many(ims, microbatch=3), singles):
        _same_candidates(g, s, *_serving_tol(s))


def _seed0_frames():
    """The first draw of a seed-0 generator at 480x640, frames clip(im + i)."""
    im = torch.randint(0, 256, (480, 640, 3), dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(0)).numpy()
    return [np.clip(im.astype(np.int16) + i, 0, 255).astype(np.uint8)
            for i in range(8)]


def test_microbatch8_matches_detect_on_the_seed0_vga_frame(cuda):
    """person26 at 480x640 on the seed-0 frames: every frame of the
    microbatch-8 program has detect's candidates within the serving
    tolerance (frame 1 lost 0.03996 before the pyramid's sums were made
    independent of the batch)."""
    from partsbaseddetector_tpu_torch import PartsBasedDetector, make_person_like_model

    frames = _seed0_frames()
    det = PartsBasedDetector(make_person_like_model(), buckets_per_octave=2,
                             device=cuda)
    singles = [det.detect(f) for f in frames]
    for g, s in zip(det.detect_many(frames, microbatch=8), singles):
        _same_candidates(g, s, 1e-5 * max(1.0, abs(s[0].score)), 1e-4)


def _person26_plan(imsize):
    from partsbaseddetector_tpu_torch import make_person_like_model
    from partsbaseddetector_tpu_torch.models.model import pack_model
    from partsbaseddetector_tpu_torch.ops import pyramid

    packed = pack_model(make_person_like_model())
    fh, fw = packed.filters.shape[1:3]
    return packed.spec, pyramid.build_plan(imsize, packed.spec, fh, fw,
                                           buckets_per_octave=2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_pyramid_features_batch_invariant_on_cuda(cuda, dtype):
    """The seed-0 VGA frames 0-7, in f32 and in bf16 (the plain bf16
    profile's pyramid): every bucket's features of each frame are the
    same bits alone (B = 1) as inside the batch of 8."""
    from partsbaseddetector_tpu_torch.ops import pyramid

    frames = _seed0_frames()
    spec, plan = _person26_plan(frames[0].shape[:2])
    batch = torch.as_tensor(np.stack(frames), device=cuda).to(dtype)
    together = pyramid.build_pyramid_features(batch, plan, spec)
    for i in range(8):
        alone = pyramid.build_pyramid_features(batch[i : i + 1], plan, spec)
        for b, (x, y) in enumerate(zip(alone, together)):
            assert torch.equal(x[0], y[i]), f"frame {i}, bucket {b}"


def test_pyramid_resized_images_and_hog_choices_equal_cpu(cuda):
    """Seed-0 frame 1: every scale's resized image, its HOG colour and
    orientation choices and every bucket's features are the CPU's bits;
    and detect on the card gives the CPU path's candidates."""
    from partsbaseddetector_tpu_torch import PartsBasedDetector, make_person_like_model
    from partsbaseddetector_tpu_torch.ops import hog, pyramid

    frame = _seed0_frames()[1]
    spec, plan = _person26_plan(frame.shape[:2])
    host = torch.as_tensor(frame[None]).float()
    card = pyramid._scale_images(host.to(cuda), plan, spec)
    cpu = pyramid._scale_images(host, plan, spec)
    for s, (x, y) in enumerate(zip(card, cpu)):
        assert torch.equal(x.cpu(), y), f"scale {s}: resized image"
        for got, want in zip(hog.hog_choices(x, spec.sbin)[:2],
                             hog.hog_choices(y, spec.sbin)[:2]):
            assert torch.equal(got.cpu(), want), f"scale {s}: HOG choices"
    for b, (x, y) in enumerate(zip(pyramid.build_pyramid_features(host.to(cuda), plan, spec),
                                   pyramid.build_pyramid_features(host, plan, spec))):
        torch.testing.assert_close(x.cpu(), y, rtol=1e-6, atol=1e-6, msg=f"bucket {b}")
    model = make_person_like_model()
    got = PartsBasedDetector(model, buckets_per_octave=2, device=cuda).detect(frame)
    want = PartsBasedDetector(model, buckets_per_octave=2, device="cpu").detect(frame)
    _same_candidates(got, want, 1e-4, 1e-3)


@pytest.mark.parametrize(
    "s,h,w,f,toh",
    [(5, 126, 166, 104, 1), (5, 126, 166, 104, 2), (5, 126, 166, 104, 4),
     (5, 126, 166, 104, 8), (2, 12, 40, 70, 3), (1, 7, 21, 7, 128)],
)
def test_conv_proto_kernel_matches_plain_and_k2(cuda, s, h, w, f, toh):
    from partsbaseddetector_tpu_torch.ops import conv_cuda
    from partsbaseddetector_tpu_torch.ops import conv_proto_cuda as cp

    gen = torch.Generator().manual_seed(s * h + toh)
    feat = torch.randn((s, h, w, 32), generator=gen).to(cuda)
    filt = torch.randn((f, 5, 5, 32), generator=gen).to(cuda)
    feat_t = feat.permute(0, 1, 3, 2).contiguous()
    w2 = cp.weights_k_major(filt)
    before = launch_counts()
    got = cp.conv_proto(feat_t, w2, f, toh)
    assert launches_since(before)["conv"] == 1
    want = cp.conv_proto_plain(feat_t, w2, f)
    bound = CONV_RTOL * cp.conv_proto_plain(feat_t.abs(), w2.abs(), f)
    assert got.shape == want.shape == (s, h - 4, w - 4, f)
    assert bool(((got - want).abs() <= bound).all())
    # the same (i, j, c) FMA order as K2
    assert torch.equal(got, conv_cuda.filter_responses_infer(feat, filt))


def _sgd_steps(model, imsize, batch, device, seed, nsteps=2):
    """nsteps latent SGD steps (make_train_step) on a seeded batch, one GT
    box an image: (pools, losses); the loss and pools finite and the defs
    projection held at every step."""
    from partsbaseddetector_tpu_torch import train
    from partsbaseddetector_tpu_torch.models.model import pack_model

    packed = pack_model(model)
    rng = np.random.RandomState(seed)
    imgs = torch.as_tensor((rng.rand(batch, *imsize, 3) * 255.0).astype(np.float32),
                           device=device)
    labels = np.array([1.0, -1.0] * (batch // 2), np.float32)
    h, w = imsize
    box = [w / 8, h / 6, w * 7 / 8, h * 5 / 6]
    masks = [m.to(device) for m in train.batch_root_masks(packed, imsize,
                                                           np.tile(box, (batch, 1)))]
    step, make_opt = train.make_train_step(packed, imsize, latent=True)
    params = train.model_params(model, device)
    opt = make_opt(params.values())
    losses = []
    for _ in range(nsteps):
        params, opt, loss = step(params, opt, imgs, masks, labels)
        losses.append(float(loss))
        assert math.isfinite(losses[-1])
        assert all(bool(torch.isfinite(v).all()) for v in params.values())
        d = params["defs"].detach()
        assert not bool((d[:, 0] < 0.01).any()) and not bool((d[:, 2] < 0.01).any())
    return {k: v.detach().cpu() for k, v in params.items()}, losses


def _engine_steps(model, imsize, batch, device, engine, nsteps=2, seed=0):
    """nsteps non-latent SGD steps through LatentHingeLoss with `engine`'s
    conv: (losses, each step's gradients)."""
    from partsbaseddetector_tpu_torch import train
    from partsbaseddetector_tpu_torch.models.model import pack_model

    rng = np.random.RandomState(seed)
    imgs = torch.as_tensor((rng.rand(batch, *imsize, 3) * 255.0).astype(np.float32),
                           device=device)
    labels = np.array([1.0, -1.0] * (batch // 2), np.float32)
    loss_fn = train.LatentHingeLoss(pack_model(model), imsize, 1e-4, 1.0, latent=False,
                                    engine=engine)
    params = train.model_params(model, device)
    opt = train.sgd_momentum(params.values())
    losses, grads = [], []
    for _ in range(nsteps):
        loss, g = loss_fn.value_and_grad(params, imgs, labels)
        grads.append({k: v.detach().cpu().clone() for k, v in g.items()})
        opt.step()
        train.project_defs(params)
        losses.append(float(loss))
    return losses, grads


def _worst(got, want, rtol, atol):
    """The largest |got - want| over atol + rtol * |want|, across tensors."""
    return max(float(((x - y).abs() / (atol + rtol * y.abs())).max())
               for x, y in zip(got, want))


def _same_placements(got, want, score_tol=0.0, box_tol=0.0):
    """Two miners' detections: the same placements (level, component, grid
    coordinates, mixtures), scores and boxes within the tolerances."""
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g["level"], g["component"]) == (w["level"], w["component"])
        for key in ("xs", "ys", "mixtures"):
            np.testing.assert_array_equal(g[key], w[key])
        assert abs(g["score"] - w["score"]) <= score_tol
        assert float(np.abs(g["boxes"] - w["boxes"]).max()) <= box_tol


def _root_key(d):
    """A mined placement's root: level, component and the root's grid
    coordinates (in bf16 the other parts sit on score plateaus)."""
    return (d["level"], d["component"], int(d["xs"][0]), int(d["ys"][0]))


TRAINER_ROUTES = ["sgd_spatial", "sgd_fourier", "miner", "miner_bf16", "set_model",
                  "latent_qp_round"]


@pytest.mark.parametrize("route", TRAINER_ROUTES)
def test_every_trainer_on_the_card_matches_cpu(cuda, route, monkeypatch):
    """The trainers on the card against the port's CPU path, person26.
    sgd_spatial: two latent steps at batch 2, 120x160, launching K1 and
    K4, pools and losses within TRAIN_TOL. sgd_fourier: two Fourier-engine
    steps launching K1, K4 and T2 and no K2, losses and gradients within
    5e-3 of the spatial engine's and rtol = atol = 1e-4 of the CPU's
    Fourier steps (the FFT libraries round differently). miner: the
    QP trainers' miner launches K1, K3, K2 and T2 and gives the CPU
    miner's plain, latent and fixed-mixtures latent placements (scores
    1e-4, boxes 1e-3), the latent top-1 the plain top-1, and a new weight
    set keeps the plans. miner_bf16: launches no K2, mines the same twice,
    finds the f32 miner's top-1 root at VGA among a quarter shared, and
    80% of the CPU bf16 miner's roots. set_model: perturbed weights give a
    fresh miner's placements bit for bit with no new plan. latent_qp_round:
    one latent.train round at 240x320 on the card's miner and pyramid
    moves finite weights, plans at interval 2 and restores the interval."""
    from partsbaseddetector_tpu_torch import make_person_like_model
    from partsbaseddetector_tpu_torch.train import detect_tpu

    model = make_person_like_model()
    small = _vga_frame()[: SMALL[0], : SMALL[1]]
    before = launch_counts()
    if route == "sgd_spatial":
        got, glosses = _sgd_steps(model, SMALL, 2, cuda, seed=1)
        _launched(before, ("dt1d", "dt1d_bwd"))
        want, wlosses = _sgd_steps(model, SMALL, 2, "cpu", seed=1)
        for k in want:
            torch.testing.assert_close(got[k], want[k], **TRAIN_TOL)
        dloss = max(abs(a - b) for a, b in zip(glosses, wlosses))
        assert dloss <= TRAIN_TOL["atol"] + TRAIN_TOL["rtol"] * max(map(abs, wlosses))
    elif route == "sgd_fourier":
        fl, fg = _engine_steps(model, SMALL, 2, cuda, "fourier")
        _launched(before, ("dt1d", "dt1d_bwd", "transpose"), ("conv",))
        sl, sg = _engine_steps(model, SMALL, 2, cuda, "spatial")
        cl, cg = _engine_steps(model, SMALL, 2, "cpu", "fourier")
        assert all(math.isfinite(x) for x in fl)
        for (rl, rg), tol in (((sl, sg), 5e-3), ((cl, cg), 1e-4)):
            assert _worst([torch.tensor(fl)], [torch.tensor(rl)], tol, tol) <= 1
            for k in fg[0]:
                assert _worst([g[k] for g in fg], [g[k] for g in rg], tol, tol) <= 1, k
    elif route == "miner":
        card = detect_tpu.TPUMiner(model, max_det=32, device=cuda)
        cpu = detect_tpu.TPUMiner(model, max_det=32, device="cpu")
        got = card.detect(small, thresh=-1e8)
        _launched(before, ("dt1d", "dt1d_aux", "conv", "transpose"))
        want = cpu.detect(small, thresh=-1e8)
        top = want[0]
        lat = dict(part_boxes=top["boxes"], overlap=0.7)
        fixed = dict(lat, fixed_mixtures=top["mixtures"])
        got_l, want_l = card.detect(small, thresh=-1e8, **lat), cpu.detect(small, thresh=-1e8, **lat)
        got_f = card.detect(small, thresh=-1e8, **fixed)
        want_f = cpu.detect(small, thresh=-1e8, **fixed)
        assert len(got_l) == len(got_f) == 1
        for g, w in ((got, want), (got_l, want_l), (got_f, want_f)):
            _same_placements(g, w, 1e-4, 1e-3)
        _same_placements(got_l, got[:1], math.inf, math.inf)
        _same_placements(got_f, got[:1], math.inf, math.inf)
        plans = dict(card._plans)
        card.set_model(model)
        card.detect(small, thresh=-1e8)
        assert card._plans.keys() == plans.keys()
    elif route == "miner_bf16":
        m16 = detect_tpu.TPUMiner(model, max_det=32, dtype=torch.bfloat16, device=cuda)
        d16 = m16.detect(small, thresh=-1e8)
        _launched(before, ("dt1d", "dt1d_aux", "transpose"), ("conv",))
        _same_placements(m16.detect(small, thresh=-1e8), d16)
        want = detect_tpu.TPUMiner(model, max_det=32, dtype=torch.bfloat16,
                                   device="cpu").detect(small, thresh=-1e8)
        shared = {_root_key(d) for d in d16} & {_root_key(d) for d in want}
        assert len(shared) >= int(0.8 * len(want)), (len(shared), len(want))
        vga = _vga_frame()
        k16 = {_root_key(d) for d in detect_tpu.TPUMiner(
            model, max_det=64, dtype=torch.bfloat16, device=cuda).detect(vga, thresh=-1e8)}
        d32 = detect_tpu.TPUMiner(model, max_det=64, device=cuda).detect(vga, thresh=-1e8)
        assert _root_key(d32[0]) in k16
        assert len(k16 & {_root_key(d) for d in d32}) >= len(d32) // 4
    elif route == "set_model":
        miner = detect_tpu.TPUMiner(model, max_det=32, device=cuda)
        miner.detect(small, thresh=-1e8)
        plans = len(miner._plans)
        rng = np.random.RandomState(1)
        moved = dataclasses.replace(model)
        moved.filters = [f + rng.randn(*f.shape).astype(f.dtype) * 0.05 for f in model.filters]
        moved.biases = model.biases + 0.1
        miner.set_model(moved)
        fresh = detect_tpu.TPUMiner(moved, max_det=32, device=cuda)
        _same_placements(miner.detect(small, thresh=-1e8), fresh.detect(small, thresh=-1e8))
        assert len(miner._plans) == plans
    else:
        from partsbaseddetector_tpu_torch.train import latent

        miners = []

        class Recorded(detect_tpu.TPUMiner):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                miners.append(self)

        gen = torch.Generator().manual_seed(9)
        frames = [torch.randint(0, 256, (240, 320, 3), generator=gen,
                                dtype=torch.uint8).numpy() for _ in range(4)]
        minsize = float(np.prod(np.asarray(model.effective_maxsize()) * model.sbin))
        probe = detect_tpu.TPUMiner(model, max_det=64, device=cuda)
        positives = []
        for im in frames[:2]:
            boxes = [d["boxes"] for d in probe.detect(im, thresh=-1e8)]
            b = next(b for b in boxes
                     if ((b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1) >= minsize).all())
            positives.append({"im": im, "points": None, "boxes": b})
        negatives = [{"im": im} for im in frames[2:]]
        monkeypatch.setattr(detect_tpu, "TPUMiner", Recorded)
        before = launch_counts()
        trained = latent.train(copy.deepcopy(model), positives, negatives, warp=False,
                               iters=1, nmax=300, max_neg_per_image=64, device=cuda)
        _launched(before, ("dt1d", "dt1d_aux", "conv", "transpose"))
        pools = [*trained.filters, trained.biases, *trained.defs]
        assert all(np.isfinite(p).all() for p in pools) and np.isfinite(trained.thresh)
        trained.validate()
        assert len(miners) == 1 and (240, 320, 2) in miners[0]._plans
        assert trained.interval == model.interval
        assert max(float(np.abs(a - b).max())
                   for a, b in zip(trained.filters, model.filters)) > 0


def test_cuda_miner_warns_on_the_shared_filter_route(cuda):
    """A card miner whose model shares a filter between two parts mines
    latent positives with detect_reference on the host, as the JAX
    package does, and says so."""
    from partsbaseddetector_tpu_torch.models.model import make_synthetic_model
    from partsbaseddetector_tpu_torch.train.detect_tpu import TPUMiner

    model = make_synthetic_model(
        nparts=3, nmix=1, fsize=(3, 3), sbin=8, interval=2, thresh=-1e9,
        seed=5,
    )
    model.filterid[0][2] = model.filterid[0][1].copy()
    im = (np.random.RandomState(0).rand(96, 104, 3) * 255).astype(np.float64)
    boxes = np.asarray([[24.0, 24.0, 56.0, 56.0]] * 3)
    miner = TPUMiner(model, max_det=8, device=cuda)
    with pytest.warns(UserWarning, match="on the host"):
        got = miner.detect(im, thresh=-1e8, part_boxes=boxes, overlap=0.3)
    assert len(got) == 1 and miner._plans == {}


def test_xml_loaded_person26_detects_as_the_in_memory_model(cuda, tmp_path):
    """person26 written to .xml (and .mat) and read back detects on the
    card bit for bit as the in-memory model."""
    from partsbaseddetector_tpu_torch import (
        PartsBasedDetector,
        load_model,
        make_person_like_model,
    )
    from partsbaseddetector_tpu_torch.models import FileStorageModel, MatlabIOModel

    model = make_person_like_model()
    im = (np.random.RandomState(12).rand(240, 320, 3) * 255).astype(np.uint8)
    want = PartsBasedDetector(model, buckets_per_octave=2, device=cuda).detect(im)
    assert want
    for fmt, writer in (("xml", FileStorageModel), ("mat", MatlabIOModel)):
        path = str(tmp_path / f"p.{fmt}")
        writer.write(model, path)
        got = PartsBasedDetector(load_model(path), buckets_per_octave=2,
                                 device=cuda).detect(im)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.score == w.score and g.component == w.component
            assert np.array_equal(g.parts, w.parts)
            assert np.array_equal(g.mixtures, w.mixtures)


def test_process_stream_equals_sorted_nms_detect(cuda, tmp_path):
    """apps.stream.DetectionStream.process_stream on two RGB-D VGA frames
    (uint16 depth) gives sorted, NMS'd detect's candidates bit for bit,
    through K1, K2 and T2."""
    from partsbaseddetector_tpu_torch import make_person_like_model
    from partsbaseddetector_tpu_torch.apps.pipeline import PipelineConfig, build
    from partsbaseddetector_tpu_torch.models import FileStorageModel
    from partsbaseddetector_tpu_torch.types import Candidate

    path = str(tmp_path / "p.xml")
    FileStorageModel.write(make_person_like_model(), path)
    node = build(PipelineConfig(model_file=path, max_overlap=0.1,
                                camera=dict(fx=525.0, fy=525.0, cx=319.5, cy=239.5)),
                 device=cuda, buckets_per_octave=2)
    rng = np.random.RandomState(13)
    frames = [((rng.rand(480, 640, 3) * 255).astype(np.uint8),
               ((1.0 + rng.rand(480, 640)) * 1000.0).astype(np.uint16)) for _ in range(2)]
    before = launch_counts()
    results = list(node.process_stream(frames, lookahead=2, workers=2))
    _launched(before, ("dt1d", "conv", "transpose"))
    assert len(results) == 2
    for r, (rgb, depth) in zip(results, frames):
        want = Candidate.non_maxima_suppression(
            rgb.shape[:2], Candidate.sort(node.detector.detect(rgb, depth)), 0.1)
        assert len(r.candidates) == len(want) > 0
        for g, w in zip(r.candidates, want):
            assert g.score == w.score and np.array_equal(g.parts, w.parts)


def _cut_at_gap(model, scores, lo=20, hi=40):
    """A copy of the model whose threshold keeps lo-hi of these best-first
    scores: halfway across the widest gap between neighbours there, so
    that rounding cannot move a candidate across."""
    k = max(range(min(lo, len(scores) - 1), min(hi, len(scores) - 1) + 1),
            key=lambda i: scores[i - 1] - scores[i])
    cut = copy.deepcopy(model)
    cut.thresh = (scores[k - 1] + scores[k]) / 2
    return cut, k


def _matched_within(a, b, score_tol, box_tol):
    """Each candidate of a has its own candidate in b within the
    tolerances, taken best first: near-equal scores may swap places."""
    if len(a) != len(b):
        return False
    free = list(range(len(b)))
    for x in a:
        j = next((j for j in free if abs(x.score - b[j].score) < score_tol
                  and float(np.abs(x.parts - b[j].parts).max()) < box_tol), None)
        if j is None:
            return False
        free.remove(j)
    return True


SURFACES = ["eval", "pictures", "cpu_detector", "rgbd_serving_demo", "training_demo"]


@pytest.mark.parametrize("surface", SURFACES)
def test_the_surfaces_on_the_card_match_cpu(cuda, surface):
    """person26's 120x160 corners of four VGA frames. eval: test_model on
    the card against ground truth from the CPU path's best candidates
    (after part NMS) gives PCK 1.0 at every part. pictures:
    visualize_model and hog_picture at the JAX package's shapes, and the
    card's candidates draw the CPU's canvases. cpu_detector: the native
    CPUPartsBasedDetector (built on the card's machine) matches the card
    within 2e-3 / 5e-2 on a 4-part model cut to keep 20-40 candidates.
    The two examples on the card: the RGB-D serving demo finds candidates
    in its 3 frames through K1, K2 and T2; the training demo (--fast)
    mines through K1 and K2 and reaches a held-out PCK@0.5 of at least 0.5
    at every part."""
    from partsbaseddetector_tpu_torch import (
        CPUPartsBasedDetector, PartsBasedDetector, Visualize, make_person_like_model,
        make_synthetic_model, native,
    )
    from partsbaseddetector_tpu_torch import visualize_model as vm
    from partsbaseddetector_tpu_torch.eval import metrics
    from partsbaseddetector_tpu_torch.ops.nms import part_nms
    from partsbaseddetector_tpu_torch.types import Candidate

    h, w = SMALL
    smalls = [f[:h, :w] for f in _shifted(_vga_frame(), 4)]
    model = make_person_like_model()
    before = launch_counts()
    if surface in ("eval", "pictures"):
        card = PartsBasedDetector(model, buckets_per_octave=2, device=cuda)
        cpu = PartsBasedDetector(model, buckets_per_octave=2, device="cpu")
        wants = [cpu.detect(s) for s in smalls]
        assert all(wants)
    if surface == "eval":
        gts = []
        for cands in wants:
            boxes = np.stack([c.parts for c in cands])
            best = cands[int(part_nms(boxes, np.array([c.score for c in cands]), 0.3)[0])]
            gts.append(metrics.boxes_to_keypoints(best.parts)[None])
        pck = metrics.test_model(card, smalls, gts)
        assert (pck == 1.0).all(), pck
    elif surface == "pictures":
        mosaic, glyph = vm.visualize_model(model), vm.hog_picture(model.filters[0])
        assert mosaic.shape == PERSON26_MOSAIC_SHAPE and glyph.shape == HOG_GLYPH_SHAPE
        assert mosaic.max() > 0 and glyph.max() > 0
        vis = Visualize(card.name)
        for small, want in zip(smalls, wants):
            np.testing.assert_array_equal(vis.candidates(small, card.detect(small)),
                                          vis.candidates(small, want))
    elif surface == "cpu_detector":
        assert native.available()
        m4 = make_synthetic_model(nparts=4, nmix=2, fsize=(4, 4), sbin=8, interval=2,
                                  thresh=1.0, seed=40)
        scores = [c.score for c in Candidate.sort(CPUPartsBasedDetector(m4).detect(smalls[0]))]
        m4, k = _cut_at_gap(m4, scores)
        want = Candidate.sort(CPUPartsBasedDetector(m4).detect(smalls[0]))
        got = PartsBasedDetector(m4, max_detections=512, device=cuda).detect(smalls[0])
        assert len(want) == k and _matched_within(want, got, 2e-3, 5e-2)
    elif surface == "rgbd_serving_demo":
        from partsbaseddetector_tpu_torch.examples import rgbd_serving_demo

        with contextlib.redirect_stdout(io.StringIO()):
            frames = rgbd_serving_demo.main(["--device", "cuda"])
        _launched(before, ("dt1d", "conv", "transpose"))
        assert len(frames) == 3 and sum(len(f.candidates) for f in frames) > 0
    else:
        from partsbaseddetector_tpu_torch.examples import training_demo

        with contextlib.redirect_stdout(io.StringIO()):
            trained, pck = training_demo.main(["--fast", "--device", "cuda"])
        _launched(before, ("dt1d", "conv"))
        trained.validate()
        assert float(np.min(pck)) >= 0.5, pck


@pytest.mark.parametrize("case", ["shift_step1", "shift_step2", "anchored"])
def test_the_public_dts_on_the_card_equal_cpu(cuda, case):
    """ops.shift_distance_transform_2d (steps 1 and 2) and
    ops.distance_transform_2d at person26 VGA's finest bucket, 4 parts x
    5 scales x 4 mixtures of 126x166 maps, per-part and per-mixture
    weights and shifts: K1 twice (K3 once) and T2 twice a call, values and
    pointers the CPU path's bit for bit, (Ix, Iy) the packed pointer's
    fields."""
    from partsbaseddetector_tpu_torch.ops import distance_transform as dtm

    gen = torch.Generator().manual_seed(16)
    score = 3 * torch.randn((4, 5, 4, 126, 166), generator=gen)
    wdef = 0.01 + 0.05 * torch.rand((4, 1, 4, 4), generator=gen)
    wdef[..., 1::2] = 0.02 * torch.randn((4, 1, 4, 2), generator=gen)
    sx = torch.randint(-3, 4, (4, 1, 4), generator=gen)
    sy = torch.randint(-3, 4, (4, 1, 4), generator=gen)
    shx, shy, dlx, dly, step = {"shift_step1": (sx, sy, 160, 120, 1),
                                "shift_step2": (sx, sy, 83, 63, 2),
                                "anchored": (sy, sx, 166, 126, 1)}[case]

    def call(dev):
        args = (score.to(dev), wdef.to(dev), shx, shy)
        if case == "anchored":
            return dtm.distance_transform_2d(*args)
        return dtm.shift_distance_transform_2d(*args, dlx, dly, step)

    before = launch_counts()
    got = call(cuda)
    counted = launches_since(before)
    assert (counted["dt1d"], counted["dt1d_aux"], counted["transpose"]) == (2, 1, 2)
    for g, w in zip(got, call("cpu")):
        assert g.shape == w.shape and torch.equal(g.cpu(), w)
    _, packed = dtm.shift_distance_transform_2d_packed(
        score.to(cuda), wdef.to(cuda), shx, shy, dlx, dly, step)
    assert torch.equal(got[1], packed & 0xFFF) and torch.equal(got[2], packed >> 12)


def test_world1_nccl_parallel_detect_and_train_step(cuda):
    """One process over NCCL (world size 1, a single-rank group over an
    in-memory store): the mesh's batched detect gives detect_batch_fn's
    outputs bit for bit with either engine (the spatial one through K2,
    the Fourier one without), and the sharded train step's loss and
    pools make_train_step's within loss rtol 1e-4, pools TRAIN_TOL,
    through K1 and K4. NCCL is not replaced by another backend."""
    import torch.distributed as dist

    from partsbaseddetector_tpu_torch import PartsBasedDetector, parallel
    from partsbaseddetector_tpu_torch.models.model import make_synthetic_model, pack_model
    from partsbaseddetector_tpu_torch.train import sgd

    assert not dist.is_initialized()
    model = make_synthetic_model(nparts=3, nmix=2, fsize=(3, 3), sbin=8,
                                 interval=2, thresh=-5.0, seed=3)
    try:
        mesh = parallel.make_mesh(device="cuda")
        assert dist.get_backend() == "nccl" and mesh.shape == (1, 1)
        batch = torch.from_numpy(
            np.random.RandomState(2).rand(4, 80, 80, 3).astype(np.float32) * 255
        ).cuda()
        for engine in ("spatial", "fourier"):
            det = PartsBasedDetector(model, max_detections=16, conv_engine=engine,
                                     device="cuda")
            want = det.detect_batch_fn((80, 80), 4)(batch)
            before = launch_counts()
            got = parallel.batched_detect_fn(det, (80, 80), mesh)(batch)
            k2 = ("conv",)
            _launched(before, ("dt1d", "transpose") + (k2 if engine == "spatial" else ()),
                      () if engine == "spatial" else k2)
            for g, w in zip(got, want):
                assert torch.equal(g.full_tensor(), w)
        packed = pack_model(model)
        rng = np.random.RandomState(1)
        images = torch.from_numpy(rng.rand(2, 80, 80, 3).astype(np.float32) * 255).cuda()
        labels = np.array([1.0, -1.0], np.float32)
        step, make_opt, shard = parallel.sharded_train_step(packed, (80, 80), mesh)
        params = shard(sgd.model_params(model, device="cuda"))
        before = launch_counts()
        _, _, loss = step(params, make_opt(params.values()), images, labels)
        _launched(before, ("dt1d", "dt1d_bwd"))
        ref_step, ref_opt = sgd.make_train_step(packed, (80, 80))
        ref = sgd.model_params(model, device="cuda")
        ref, _, ref_loss = ref_step(ref, ref_opt(ref.values()), images, labels)
        np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-4)
        for k, v in shard.gather(params).items():
            np.testing.assert_allclose(v.cpu().numpy(), ref[k].detach().cpu().numpy(),
                                       **TRAIN_TOL)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_profiled_windows_of_lone_launches_are_complete(cuda):
    """utils/profiling.py::profiled: windows of one bare K1 launch, one
    T2 launch and one torch kernel each record the launches the wrappers
    counted (a lost event raises RuntimeError), and device_ms with
    launches= holds its window the same way."""
    from partsbaseddetector_tpu_torch.ops import dt_cuda, transpose_cuda
    from partsbaseddetector_tpu_torch.utils.profiling import device_ms, profiled

    gen = torch.Generator().manual_seed(4)
    src, a, b, sh = (t.to(cuda) for t in (
        torch.randn((8, 40, 50), generator=gen), torch.full((8,), -0.05),
        torch.zeros(8), torch.zeros(8)))
    nv = torch.full((8,), 40, dtype=torch.int32, device=cuda)
    x = torch.randn((8, 40, 50), generator=gen).to(cuda)
    for _ in range(10):
        got = profiled(lambda: dt_cuda._dt1d_cuda(src, a, b, sh, nv, 40, 1, None))
        assert got["launches"]["dt1d"] == 1 and got["families"]["dt1d"] > 0
        assert profiled(lambda: transpose_cuda._transpose_cuda(x))["launches"]["transpose"] == 1
        assert profiled(lambda: x.add_(1.0))["launches"]["transpose"] == 0
    assert device_ms(lambda: transpose_cuda.transpose_last2(x), reps=5,
                     launches={"transpose": 1}) > 0


def test_a_span_holds_its_launchs_runtime_record(cuda):
    """utils/profiling.py::span: a span around one torch.cuda._sleep
    launch holds that launch's cudaLaunchKernel record on torch.profiler's
    clock, and the kernel's device event carries the record's
    correlation id: span times and the CUDA runtime's records share one
    clock."""
    from torch.profiler import ProfilerActivity, profile

    from partsbaseddetector_tpu_torch.utils.profiling import recording, span

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with recording() as rec:
            with span("sleep"):
                torch.cuda._sleep(100_000)
        torch.cuda.synchronize()
    (s,) = rec.spans
    events = prof.profiler.kineto_results.events()
    (launch,) = [e for e in events if e.name() == "cudaLaunchKernel"]
    (kernel,) = [e for e in events if e.device_type() == torch.autograd.DeviceType.CUDA
                 and "spin_kernel" in e.name()]
    assert s.start_ns <= launch.start_ns() <= launch.end_ns() <= s.end_ns
    assert launch.correlation_id() != 0
    assert launch.correlation_id() in (kernel.correlation_id(),
                                       kernel.linked_correlation_id())
    assert kernel.start_ns() >= launch.start_ns()
