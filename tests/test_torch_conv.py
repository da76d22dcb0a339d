"""The torch port's filter responses against the JAX package.

`filter_responses` (what the conv wrapper runs on a CPU tensor, and what
the CUDA kernel is held against on the card) must match the JAX
package's Pallas implicit-GEMM kernel (in the interpreter) and its XLA
conv to 1e-5 relative: all three sum K = fh*fw*C f32 products, in
different orders.
"""

import numpy as np
import pytest
import torch

from partsbaseddetector_tpu.ops.conv import filter_responses as jax_conv
from partsbaseddetector_tpu.ops.conv_pallas import filter_responses_pallas
from partsbaseddetector_tpu_torch.ops.conv import filter_responses
from partsbaseddetector_tpu_torch.ops.conv_cuda import filter_responses_infer


def _rand(rng, shape):
    return rng.randn(*shape).astype(np.float32)


def _bank_with_zero_rows(rng, f, fh, fw, c):
    """A padded bank: every third filter is smaller, its extra taps zero."""
    bank = _rand(rng, (f, fh, fw, c)) * 0.1
    bank[::3, max(fh - 2, 1):, :, :] = 0.0
    bank[1::3, :, max(fw - 2, 1):, :] = 0.0
    return bank


@pytest.mark.parametrize(
    "s,h,w,c,f,fh,fw",
    [
        (2, 18, 22, 32, 7, 5, 5),
        (1, 9, 31, 32, 3, 3, 4),  # non-square filter
        (1, 6, 6, 8, 1, 2, 2),  # minimal
        (3, 14, 20, 32, 13, 5, 5),
    ],
)
def test_filter_responses_match_jax(s, h, w, c, f, fh, fw):
    rng = np.random.RandomState(s * 100 + f)
    feat = _rand(rng, (s, h, w, c))
    filt = _bank_with_zero_rows(rng, f, fh, fw, c)
    got = filter_responses(torch.from_numpy(feat), torch.from_numpy(filt))
    assert got.shape == (s, h - fh + 1, w - fw + 1, f)
    want_xla = np.asarray(jax_conv(feat, filt))
    want_pallas = np.asarray(filter_responses_pallas(feat, filt, interpret=True))
    np.testing.assert_allclose(got.numpy(), want_xla, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want_pallas, rtol=1e-5, atol=1e-5)


def test_zero_padded_bank_rows_contribute_nothing():
    """A filter zero-padded into a larger bank gives its own valid
    correlation on the shared top-left-anchored grid."""
    rng = np.random.RandomState(1)
    feat = torch.from_numpy(_rand(rng, (1, 10, 14, 32)))
    small = torch.from_numpy(_rand(rng, (1, 3, 3, 32)))
    bank = torch.zeros((2, 5, 5, 32))
    bank[0, :3, :3] = small[0]
    bank[1] = torch.from_numpy(_rand(rng, (5, 5, 32)))
    got = filter_responses(feat, bank)
    own = filter_responses(feat, small)
    torch.testing.assert_close(got[..., 0], own[:, :6, :10, 0], rtol=1e-5, atol=1e-5)


def test_infer_wrapper_uses_plain_version_on_cpu():
    rng = np.random.RandomState(2)
    feat = torch.from_numpy(_rand(rng, (2, 12, 13, 32)))
    filt = torch.from_numpy(_rand(rng, (5, 4, 4, 32)))
    assert torch.equal(filter_responses_infer(feat, filt), filter_responses(feat, filt))


def test_infer_wrapper_refuses_other_devices():
    feat = torch.empty((1, 8, 8, 32), device="meta")
    filt = torch.empty((2, 3, 3, 32), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        filter_responses_infer(feat, filt)


# --- the 3xTF32 rule of the K2 kernel, stated in torch ------------------

from partsbaseddetector_tpu_torch.ops.conv import (  # noqa: E402
    filter_responses_3xtf32_plain,
    split_tf32,
)


@pytest.mark.parametrize("lo,hi", [(-3, 3), (-30, 30)])
def test_split_tf32_reconstructs_to_2_pow_minus_22(lo, hi):
    """big + small equals x to 2^-22 relative over a wide range of
    exponents, and both pieces are TF32 (low 13 bits zero)."""
    rng = np.random.RandomState(hi)
    x = rng.randn(20000) * np.exp2(rng.uniform(lo, hi, 20000))
    x = torch.from_numpy(x.astype(np.float32))
    big, small = split_tf32(x)
    for piece in (big, small):
        assert int((piece.view(torch.int32) & 0x1FFF).abs().max()) == 0
    err = (x.double() - big.double() - small.double()).abs()
    assert bool((err <= 2.0**-22 * x.double().abs()).all())
    # x - big is exact, so big carries x to 2^-11 relative
    assert bool(((x.double() - big.double()).abs() <= 2.0**-11 * x.double().abs()).all())


def test_split_tf32_rounds_to_nearest_ties_away():
    """cvt.rna.tf32.f32: a tie at the 11th significant bit rounds away
    from zero, in either sign; below a tie it rounds down."""
    one_ulp = 2.0**-10
    x = torch.tensor([1 + one_ulp / 2, -(1 + one_ulp / 2), 1 + one_ulp / 2 - 2.0**-23,
                      1 + 1.5 * one_ulp, 3.0], dtype=torch.float32)
    big, _ = split_tf32(x)
    assert big.tolist() == [1 + one_ulp, -(1 + one_ulp), 1.0, 1 + 2 * one_ulp, 3.0]


def _person26_case():
    """The person26 model's real filter bank on the HOG features of a
    seeded 120x160 frame (the finest scale)."""
    from partsbaseddetector_tpu_torch import make_person_like_model
    from partsbaseddetector_tpu_torch.models.model import pack_model
    from partsbaseddetector_tpu_torch.ops.hog import hog_features

    im = (np.random.RandomState(0).rand(1, 120, 160, 3) * 255).astype(np.float32)
    feat = hog_features(torch.from_numpy(im), 4)
    filt = torch.from_numpy(pack_model(make_person_like_model()).filters)
    return feat, filt


def _rule_case(kind):
    rng = np.random.RandomState(7)
    if kind == "person26":
        return _person26_case()
    if kind == "random":
        return (torch.from_numpy(rng.rand(3, 14, 20, 32).astype(np.float32)),
                torch.from_numpy(0.1 * rng.randn(13, 5, 5, 32).astype(np.float32)))
    if kind == "wide_range":
        # full 24-bit mantissas over 2^-20..2^20, so every split is inexact
        def draw(shape):
            x = rng.uniform(1, 2, shape) * np.exp2(rng.randint(-20, 21, shape))
            return torch.from_numpy((x * rng.choice([-1, 1], shape)).astype(np.float32))
        return draw((2, 12, 16, 32)), draw((9, 4, 4, 32))
    # cancelling: each filter is +w on even taps and -w on odd ones, the
    # features nearly constant, so the sums nearly vanish against sum|x*w|
    feat = 1.0 + 1e-4 * rng.randn(2, 12, 16, 32)
    w = rng.rand(9, 1, 1, 32).repeat(4, 1).repeat(4, 2)
    w[:, 1::2, :, :] *= -1
    w[:, :, 1::2, :] *= -1
    return (torch.from_numpy(feat.astype(np.float32)),
            torch.from_numpy(w.astype(np.float32)))


@pytest.mark.parametrize("kind", ["random", "wide_range", "cancelling", "person26"])
def test_3xtf32_plain_within_1e_5_of_sum_abs(kind):
    """The K2 kernel's arithmetic (3xTF32, each tap's three partial
    products summed in f32, then added to the total) stays within
    1e-5 * sum|x*w| of the f32 correlation, output by output."""
    feat, filt = _rule_case(kind)
    got = filter_responses_3xtf32_plain(feat, filt)
    want = filter_responses(feat.double(), filt.double())
    scale = filter_responses(feat.abs().double(), filt.abs().double())
    assert got.shape == want.shape
    err = (got.double() - want).abs()
    assert bool((err <= 1e-5 * scale).all())
    # and it is the same function as filter_responses to that rule
    plain = filter_responses(feat, filt).double()
    assert bool(((got.double() - plain).abs() <= 1e-5 * scale).all())


def test_grouped_wrapper_uses_plain_version_per_stack_on_cpu():
    from partsbaseddetector_tpu_torch.ops.conv_cuda import filter_responses_grouped

    rng = np.random.RandomState(3)
    filt = torch.from_numpy(_rand(rng, (5, 3, 3, 32)))
    feats = [torch.from_numpy(_rand(rng, (s, h, w, 32)))
             for s, h, w in ((2, 12, 13), (1, 7, 9), (3, 4, 3))]
    got = filter_responses_grouped(feats, filt)
    assert len(got) == 3
    for g, x in zip(got, feats):
        assert torch.equal(g, filter_responses(x, filt))
