"""The torch port's CUDA kernels on the card, against their plain
versions. Every test here needs a CUDA device (and nvcc to build the
kernels): without one it skips. On the card, run

    python -m pytest tests/test_torch_cuda.py -m cuda -q

The kernels are held to: the DT bit for bit (values, and pointers at
live outputs); the conv within 1e-5 * sum|x*w|; the DT's backward (K4)
within 1e-5 * sum|g| per source and 1e-5 * sum|g*d^2|, sum|g*d| per map;
the adaptive-window DT (K5) bit for bit against its plain version, and
against K1 inside out_valid. Detect with the window DT gives the default
detect's candidates bit for bit; the Fourier and RGB-D detectors give the
CPU path's candidates. The transpose (T2) is exact for float32 and int32,
and so is its gradient; the serving APIs give detect's candidates. T1's
port (conv_proto) is within 1e-5 * sum|x*w| of its plain version and
equal to K2 bit for bit at every toh; the hybrid bf16 profile gives the
CPU path's candidates through K1, K2 and T2.
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


# (12, 12) filters need more than 48 KB of shared memory per block
@pytest.mark.parametrize(
    "s,h,w,c,f,fh,fw",
    [(3, 40, 53, 32, 70, 5, 4), (1, 30, 31, 32, 3, 12, 12), (2, 9, 20, 8, 130, 2, 3)],
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
        (320, 66, 86, 66, 1, False, False, False),  # person26 240x320 y pass
    ],
)
def test_dt_backward_kernel_matches_plain(cuda, bsz, h, w, dlen, step, aux, ints, dead):
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
    assert dt_cuda.bwd_launches == before + 1
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
        (30, 33, 30, False, (0.0, 0.0)),  # flat penalty: exitable
        (30, 33, 30, False, (0.0, 0.5)),  # linear penalty: full scan
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
