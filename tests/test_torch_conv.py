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
