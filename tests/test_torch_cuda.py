"""The torch port's CUDA kernels on the card, against their plain
versions. Every test here needs a CUDA device (and nvcc to build the
kernels): without one it skips. On the card, run

    python -m pytest tests/test_torch_cuda.py -m cuda -q

The kernels are held to: the DT bit for bit (values, and pointers at
live outputs); the conv within 1e-5 * sum|x*w|.
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
    before = dt_cuda.launches
    got_v, got_p = dt_cuda.dt1d(*args[:4], dlen, step, nvalid=args[4], aux=axd)
    want_v, want_p = dt_cuda.dt1d_plain(*args, dlen, step, aux=axd)
    assert dt_cuda.launches == before + 1
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
