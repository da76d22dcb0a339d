"""The torch port's CUDA kernels on the card, against their plain
versions. Every test here needs a CUDA device (and nvcc to build the
kernels): without one it skips. On the card, run

    python -m pytest tests/test_torch_cuda.py -m cuda -q

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

import os

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


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
    before = (dt_cuda.launches, dt_cuda.aux_launches)
    got_v, got_p = dt_cuda.dt1d(*args[:4], dlen, step, nvalid=args[4], aux=axd)
    want_v, want_p = dt_cuda.dt1d_plain(*args, dlen, step, aux=axd)
    assert (dt_cuda.launches, dt_cuda.aux_launches) == (before[0] + 1, before[1] + bool(aux))
    assert torch.equal(got_v, want_v)
    live = torch.isfinite(want_v)
    assert torch.equal(got_p[live], want_p[live])


@pytest.mark.parametrize(
    "name,bsz,h,w,dlen,step,aux,shift,ab",
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
    ],
)
def test_dt_kernel_edge_shapes_match_plain(cuda, name, bsz, h, w, dlen, step,
                                           aux, shift, ab):
    """The redesigned K1 (register-blocked rows, shared penalties at
    integral shifts, chunk pruning) bit for bit against dt1d_plain where
    its paths change: the general path (fractional shift, step 2), a = 0
    and a > 0, tiles and runs that the map does not fill, the streamed
    path of tall maps, -inf tails and a dead map in every case."""
    from partsbaseddetector_tpu_torch.ops import dt_cuda

    gen = torch.Generator().manual_seed(h * w + dlen)
    src = torch.randn((bsz, h, w), generator=gen) * 3
    nv = torch.randint(1, h + 1, (bsz,), generator=gen, dtype=torch.int32)
    nv[0], nv[1] = h, 0
    src = torch.where(torch.arange(h)[None, :, None] < nv[:, None, None], src, -torch.inf)
    a = -(0.01 + 0.05 * torch.rand((bsz,), generator=gen))
    b = 0.3 * torch.randn((bsz,), generator=gen)
    if ab is not None:
        a.fill_(ab[0])
        b.fill_(ab[1])
    if shift == "frac":
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
# table shape; C = 12 is no multiple of 8 (zero channels in the k8 steps)
@pytest.mark.parametrize(
    "s,h,w,c,f,fh,fw",
    [(3, 40, 53, 32, 70, 5, 4), (1, 30, 31, 32, 3, 12, 12), (2, 9, 20, 8, 130, 2, 3),
     (5, 130, 170, 32, 104, 5, 5), (2, 17, 19, 12, 9, 3, 3)],
)
def test_conv_kernel_matches_plain(cuda, s, h, w, c, f, fh, fw):
    from partsbaseddetector_tpu_torch.ops import conv, conv_cuda

    gen = torch.Generator().manual_seed(s * f)
    feat = torch.rand((s, h, w, c), generator=gen).to(cuda)
    filt = (0.1 * torch.randn((f, fh, fw, c), generator=gen)).to(cuda)
    before = conv_cuda.launches
    got = conv_cuda.filter_responses_infer(feat, filt)
    assert conv_cuda.launches == before + 1
    want = conv.filter_responses(feat, filt)
    bound = 1e-5 * conv.filter_responses(feat.abs(), filt.abs())
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
    before = conv_cuda.launches
    got = conv_cuda.filter_responses_grouped(feats, filt)
    assert conv_cuda.launches == before + 2  # 20 stacks: 16 + 4
    for g, x in zip(got, feats):
        assert torch.equal(g, conv_cuda.filter_responses_infer(x, filt))


def test_detect_passes_the_bank_split_once_per_model(cuda, monkeypatch):
    """to_device splits the filter bank into its TF32 pieces once; a
    detect's one grouped conv call stages that split; a bank of another
    shape is refused."""
    from partsbaseddetector_tpu_torch import PartsBasedDetector, make_person_like_model
    from partsbaseddetector_tpu_torch import pipeline
    from partsbaseddetector_tpu_torch.ops import conv_cuda

    det = PartsBasedDetector(make_person_like_model(), buckets_per_octave=2, device=cuda)
    im = np.random.RandomState(0).randint(0, 256, (120, 160, 3)).astype(np.uint8)
    dm = det._dmodel
    assert torch.equal(dm.filters_split, conv_cuda.split_bank(dm.filters))
    seen = []
    orig = pipeline.filter_responses_grouped

    def record(feats, filt, bank=None):
        seen.append(bank)
        return orig(feats, filt, bank)

    monkeypatch.setattr(pipeline, "filter_responses_grouped", record)
    det.detect(im)
    assert len(seen) == 1 and seen[0] is dm.filters_split
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
    before = dt_cuda.bwd_launches
    got = dt_cuda.dt1d_bwd(g, out, ptr, sh, h, step, aux)
    again = dt_cuda.dt1d_bwd(g, out, ptr, sh, h, step, aux)
    assert dt_cuda.bwd_launches == before + 2
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
        assert bool(((x - y).abs() <= 1e-5 * m).all())


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
        before = dt_cuda.bwd_launches
        out, _ = dt_cuda.dt1d(*leaves, torch.zeros((), device=dev), 19, 1,
                              differentiable=True)
        (out * cot.to(dev)).sum().backward()
        assert dt_cuda.bwd_launches == before + (dev != "cpu")
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
    before = dt_cuda.window_launches
    got_v, got_p = dt_cuda.dt1d_window(src, a, b, sh, dlen, ov, nvalid=nv, aux=ax)
    assert dt_cuda.window_launches == before + 1
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
    before = dt_cuda.window_launches
    got = det.detect(im)
    assert dt_cuda.window_launches > before
    _same_candidates(got, want)


@pytest.mark.parametrize("kind", ["fourier", "rgbd"])
def test_fourier_and_rgbd_detect_on_cuda_match_cpu(cuda, kind):
    from partsbaseddetector_tpu_torch import PartsBasedDetector
    from partsbaseddetector_tpu_torch.depth import DepthGate

    model, im = _person_frame()
    kw = dict(max_detections=16, buckets_per_octave=2)
    depth = None
    if kind == "fourier":
        kw["conv_engine"] = "fourier"
    else:
        kw.update(device_depth_filter=True,
                  depth_gate=DepthGate(object_width_m=0.6, fx=10.0, tolerance=0.5))
        depth = ((1.0 + np.random.RandomState(1).rand(120, 160)) * 1000).astype(np.uint16)
    got = PartsBasedDetector(model, device=cuda, **kw).detect_dense(im, depth)
    want = PartsBasedDetector(model, device="cpu", **kw).detect_dense(im, depth)
    if depth is not None:
        np.testing.assert_array_equal(got.depth_keep, want.depth_keep)
    _same_candidates(got.to_candidates(), want.to_candidates(), 1e-4, 1e-3)


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
    before = tc.launches
    got = tc.transpose_last2(x)
    assert tc.launches == before + 1
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
    before = tc.launches
    xt, yt = tc.transpose_last2_pair(x, y)
    assert tc.launches == before + 1
    for got, src in ((xt, x), (yt, y)):
        want = tc.transpose_last2_plain(src)
        assert got.dtype == src.dtype and got.shape == want.shape and got.is_contiguous()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_transpose_pair_kernel_edges_and_gradient(cuda):
    """Empty tensors launch nothing; mismatched shapes are refused; the
    pair's backward transposes the values' cotangent in one launch."""
    from partsbaseddetector_tpu_torch.ops import transpose_cuda as tc

    before = tc.launches
    xt, yt = tc.transpose_last2_pair(
        torch.empty((0, 4, 5), device=cuda),
        torch.empty((0, 4, 5), dtype=torch.int32, device=cuda))
    assert xt.shape == yt.shape == (0, 5, 4) and tc.launches == before
    with pytest.raises(ValueError, match="shapes .* differ"):
        tc.transpose_last2_pair(torch.zeros((2, 3, 4), device=cuda),
                                torch.zeros((2, 4, 3), device=cuda))
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((4, 37, 45), generator=gen).to(cuda).requires_grad_()
    y = torch.randint(0, 99, (4, 37, 45), generator=gen, dtype=torch.int32).to(cuda)
    cot = torch.randn((4, 45, 37), generator=gen).to(cuda)
    before = tc.launches
    xt, yt = tc.transpose_last2_pair(x, y)
    (xt * cot).sum().backward()
    assert tc.launches == before + 2  # the pair forward, one backward
    assert torch.equal(x.grad, tc.transpose_last2_plain(cot))
    assert torch.equal(yt, tc.transpose_last2_plain(y))


def test_transpose_kernel_gradient(cuda):
    from partsbaseddetector_tpu_torch.ops import transpose_cuda as tc

    gen = torch.Generator().manual_seed(3)
    x = torch.randn((4, 37, 45), generator=gen).to(cuda).requires_grad_()
    cot = torch.randn((4, 45, 37), generator=gen).to(cuda)
    before = tc.launches
    (tc.transpose_last2(x) * cot).sum().backward()
    assert tc.launches == before + 2  # forward and backward
    assert torch.equal(x.grad, tc.transpose_last2_plain(cot))


def test_serving_apis_on_cuda_match_detect(cuda):
    """detect_batch, detect_many (pipelined, microbatch 3 with padding)
    and detect_stream on the card give detect's candidates; the packed
    readback is exact."""
    from partsbaseddetector_tpu_torch import PartsBasedDetector

    model, im = _person_frame()
    det = PartsBasedDetector(model, max_detections=16, buckets_per_octave=2,
                             device=cuda)
    ims = [np.clip(im.astype(np.int32) + i, 0, 255).astype(np.uint8) for i in range(4)]
    singles = [det.detect(x) for x in ims]
    for got in (det.detect_batch(ims), det.detect_many(ims, prefetch=2),
                list(det.detect_stream(ims, lookahead=2, workers=1))):
        for g, s in zip(got, singles):
            _same_candidates(g, s)
    for g, s in zip(det.detect_many(ims, microbatch=3), singles):
        _same_candidates(g, s, 1e-5 * max(1.0, abs(s[0].score)), 1e-4)


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


def test_pyramid_features_batch_invariant_on_cuda(cuda):
    """The seed-0 VGA frames 0-7: every bucket's features of each frame
    are the same bits alone (B = 1) as inside the batch of 8."""
    from partsbaseddetector_tpu_torch.ops import pyramid

    frames = _seed0_frames()
    spec, plan = _person26_plan(frames[0].shape[:2])
    batch = torch.as_tensor(np.stack(frames), device=cuda).float()
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
    before = cp.launches
    got = cp.conv_proto(feat_t, w2, f, toh)
    assert cp.launches == before + 1
    want = cp.conv_proto_plain(feat_t, w2, f)
    bound = 1e-5 * cp.conv_proto_plain(feat_t.abs(), w2.abs(), f)
    assert got.shape == want.shape == (s, h - 4, w - 4, f)
    assert bool(((got - want).abs() <= bound).all())
    # the same (i, j, c) FMA order as K2
    assert torch.equal(got, conv_cuda.filter_responses_infer(feat, filt))


def test_hybrid_detect_on_cuda_matches_cpu(cuda):
    """The bf16 + fp32-rescore profile on the card runs K1, K2 and T2
    and gives the CPU path's candidates."""
    from partsbaseddetector_tpu_torch import PartsBasedDetector
    from partsbaseddetector_tpu_torch.ops import conv_cuda, dt_cuda
    from partsbaseddetector_tpu_torch.ops import transpose_cuda as tc

    model, im = _person_frame()
    kw = dict(max_detections=32, buckets_per_octave=2, dtype=torch.bfloat16)
    before = (dt_cuda.launches, conv_cuda.launches, tc.launches)
    got = PartsBasedDetector(model, device=cuda, **kw).detect(im)
    after = (dt_cuda.launches, conv_cuda.launches, tc.launches)
    assert all(a > b for a, b in zip(after, before))
    want = PartsBasedDetector(model, device="cpu", **kw).detect(im)
    _same_candidates(got, want, 1e-5 * max(1.0, abs(want[0].score)), 1e-4)


def test_miner_on_cuda_matches_cpu(cuda):
    """The QP trainers' miner on the card runs K1, K2 and T2 and gives
    the CPU miner's placements, plain and latent (scores within 1e-4,
    boxes within 1e-3); set_model keeps the plan."""
    from partsbaseddetector_tpu_torch.ops import conv_cuda, dt_cuda
    from partsbaseddetector_tpu_torch.ops import transpose_cuda as tc
    from partsbaseddetector_tpu_torch.train.detect_tpu import TPUMiner

    model, im = _person_frame()
    before = (dt_cuda.launches, conv_cuda.launches, tc.launches)
    card = TPUMiner(model, max_det=32, device=cuda)
    cpu = TPUMiner(model, max_det=32, device="cpu")
    got, want = card.detect(im, thresh=-1e8), cpu.detect(im, thresh=-1e8)
    after = (dt_cuda.launches, conv_cuda.launches, tc.launches)
    assert all(a > b for a, b in zip(after, before))
    kw = dict(thresh=-1e8, part_boxes=want[0]["boxes"], overlap=0.7)
    got_l, want_l = card.detect(im, **kw), cpu.detect(im, **kw)
    assert len(got_l) == 1
    for g_all, w_all in ((got, want), (got_l, want_l)):
        assert len(g_all) == len(w_all) > 0
        for g, w in zip(g_all, w_all):
            assert abs(g["score"] - w["score"]) <= 1e-4
            assert (g["level"], g["component"]) == (w["level"], w["component"])
            for key in ("xs", "ys", "mixtures"):
                np.testing.assert_array_equal(g[key], w[key])
            np.testing.assert_allclose(g["boxes"], w["boxes"], atol=1e-3)
    plans = dict(card._plans)
    card.set_model(model)
    card.detect(im, thresh=-1e8)
    assert card._plans.keys() == plans.keys()


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
    from partsbaseddetector_tpu_torch.ops import conv_cuda, dt_cuda
    from partsbaseddetector_tpu_torch.ops import transpose_cuda as tc
    from partsbaseddetector_tpu_torch.types import Candidate

    path = str(tmp_path / "p.xml")
    FileStorageModel.write(make_person_like_model(), path)
    node = build(PipelineConfig(model_file=path, max_overlap=0.1,
                                camera=dict(fx=525.0, fy=525.0, cx=319.5, cy=239.5)),
                 device=cuda, buckets_per_octave=2)
    rng = np.random.RandomState(13)
    frames = [((rng.rand(480, 640, 3) * 255).astype(np.uint8),
               ((1.0 + rng.rand(480, 640)) * 1000.0).astype(np.uint16)) for _ in range(2)]
    before = (dt_cuda.launches, conv_cuda.launches, tc.launches)
    results = list(node.process_stream(frames, lookahead=2, workers=2))
    after = (dt_cuda.launches, conv_cuda.launches, tc.launches)
    assert all(a > b for a, b in zip(after, before))
    assert len(results) == 2
    for r, (rgb, depth) in zip(results, frames):
        want = Candidate.non_maxima_suppression(
            rgb.shape[:2], Candidate.sort(node.detector.detect(rgb, depth)), 0.1)
        assert len(r.candidates) == len(want) > 0
        for g, w in zip(r.candidates, want):
            assert g.score == w.score and np.array_equal(g.parts, w.parts)


def test_world1_nccl_parallel_detect_and_train_step(cuda):
    """One process over NCCL (world size 1, a single-rank group over an
    in-memory store): the mesh's batched detect gives detect_batch_fn's
    outputs bit for bit, and the sharded train step's loss and pools
    make_train_step's within loss rtol 1e-4, pools rtol 1e-4, atol 1e-5.
    NCCL is not replaced by another backend."""
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
        det = PartsBasedDetector(model, max_detections=16, device="cuda")
        batch = torch.from_numpy(
            np.random.RandomState(2).rand(4, 80, 80, 3).astype(np.float32) * 255
        ).cuda()
        want = det.detect_batch_fn((80, 80), 4)(batch)
        for g, w in zip(parallel.batched_detect_fn(det, (80, 80), mesh)(batch), want):
            assert torch.equal(g.full_tensor(), w)
        packed = pack_model(model)
        rng = np.random.RandomState(1)
        images = torch.from_numpy(rng.rand(2, 80, 80, 3).astype(np.float32) * 255).cuda()
        labels = np.array([1.0, -1.0], np.float32)
        step, make_opt, shard = parallel.sharded_train_step(packed, (80, 80), mesh)
        params = shard(sgd.model_params(model, device="cuda"))
        _, _, loss = step(params, make_opt(params.values()), images, labels)
        ref_step, ref_opt = sgd.make_train_step(packed, (80, 80))
        ref = sgd.model_params(model, device="cuda")
        ref, _, ref_loss = ref_step(ref, ref_opt(ref.values()), images, labels)
        np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-4)
        for k, v in shard.gather(params).items():
            np.testing.assert_allclose(v.cpu().numpy(), ref[k].detach().cpu().numpy(),
                                       rtol=1e-4, atol=1e-5)
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
