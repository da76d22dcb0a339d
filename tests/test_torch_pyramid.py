"""The pyramid's rounding does not depend on the batch.

The resize maps and the HOG tent maps are fixed-order elementwise sums
(`ops/resize.py::apply_banded`), the resize in float64 rounded to f32
once, so an image gives the same bits alone as inside a batch of any
size, and the same bits on the CPU and on the card (the card's side is
in tests/test_torch_cuda.py). Here: the CPU at B = 1, 2 and 8, and the
maps against their dense matrices.
"""

import numpy as np
import pytest
import torch

from partsbaseddetector_tpu_torch import make_person_like_model
from partsbaseddetector_tpu_torch.models.model import pack_model
from partsbaseddetector_tpu_torch.ops import hog, pyramid, resize


def _frames(n, h=90, w=120):
    im = (np.random.RandomState(0).rand(h, w, 3) * 255).astype(np.uint8)
    return [np.clip(im.astype(np.int16) + 7 * i, 0, 255).astype(np.uint8) for i in range(n)]


@pytest.mark.parametrize("bsz", [2, 8])
def test_pyramid_features_bit_identical_at_any_batch(bsz):
    """Three seeded frames: every bucket's features of each frame are the
    same bits at B = 1 as inside a batch of bsz (the other slots hold
    other frames)."""
    packed = pack_model(make_person_like_model())
    spec = packed.spec
    fh, fw = packed.filters.shape[1:3]
    frames = _frames(8)
    plan = pyramid.build_plan(frames[0].shape[:2], spec, fh, fw, buckets_per_octave=2)
    batch = torch.from_numpy(np.stack(frames[:bsz])).float()
    together = pyramid.build_pyramid_features(batch, plan, spec)
    for i in range(min(3, bsz)):
        alone = pyramid.build_pyramid_features(batch[i : i + 1], plan, spec)
        for b, (x, y) in enumerate(zip(alone, together)):
            assert torch.equal(x[0], y[i]), f"frame {i}, bucket {b}"


@pytest.mark.parametrize("op", ["resize", "reduce"])
def test_resize_is_the_float64_product_rounded_once(op):
    """Each resized pixel is the float64 dense product of the exact
    weights, rounded to f32 once."""
    im = np.random.RandomState(3).rand(1, 37, 53, 3).astype(np.float32) * 255
    t = torch.from_numpy(im)
    if op == "resize":
        got = resize.resize_image(t, 0.8)
        wh = resize.resize_matrix(37, got.shape[1])
        ww = resize.resize_matrix(53, got.shape[2])
    else:
        got = resize.reduce_image(t)
        wh, ww = resize.reduce_matrix(37), resize.reduce_matrix(53)
    want = np.einsum("ah,bw,hwc->abc", wh, ww, im[0].astype(np.float64))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got[0].numpy(), want.astype(np.float32))


def test_hog_tent_maps_equal_the_dense_products():
    """The banded tent sums give the dense histogram products' values to
    f32 rounding, in either axis."""
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.rand(2, 48, 40, 18).astype(np.float32))
    for dim, n in ((1, 48), (2, 40)):
        blocks = n // 4
        got = resize.apply_banded(x, dim, hog._hist_matrix, blocks, n, 4)
        m = torch.from_numpy(hog._hist_matrix(blocks, n, 4)).double()
        want = torch.movedim(torch.tensordot(m, x.double(), dims=([1], [dim])), 0, dim)
        torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=1e-6)


def test_the_known_near_tie_against_the_jax_package():
    """Seed-0 VGA frame 1 (the first draw of a seed-0 generator, plus 1),
    scales 11 (224x299) and 31 (56x75), where the JAX package's f32
    resize products and the port's float64 ones decide a HOG choice at a
    near-tie differently. On scale 11 one gradient pixel, (71, 252) of
    the visible grid's interior, picks blue (channel 2) on the JAX
    package's image and red on the port's: the two channels' squared
    gradients lie within 2e-6 relative on both images. Every other
    choice on both scales agrees (scale 31's orientation near-tie falls
    the JAX package's way)."""
    from partsbaseddetector_tpu.ops import resize as jresize

    im = torch.randint(0, 256, (480, 640, 3), dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(0)).numpy()
    frame = np.clip(im.astype(np.int16) + 1, 0, 255).astype(np.float32)
    sc = 2.0 ** 0.1
    jim, pim = {}, {}
    a = np.asarray(jresize.resize_image(frame, 1 / sc))
    b = resize.resize_image(torch.from_numpy(frame)[None], 1 / sc)
    for s in (11, 21, 31):
        a = np.asarray(jresize.reduce_image(a))
        b = resize.reduce_image(b)
        jim[s], pim[s] = a, b
    for s in (11, 31):
        cj, oj, gj = hog.hog_choices(torch.from_numpy(np.array(jim[s]))[None], 4)
        cp, op, gp = hog.hog_choices(pim[s], 4)
        flips = ((cj != cp) | (oj != op)).nonzero().tolist()
        if s == 31:
            assert flips == []
            continue
        assert flips == [[0, 71, 252]]
        assert (int(cj[0, 71, 252]), int(cp[0, 71, 252])) == (2, 0)
        for img in (jim[s], pim[s][0].numpy()):
            t = torch.from_numpy(np.array(img)).double()
            dy = t[73, 253] - t[71, 253]
            dx = t[72, 254] - t[72, 252]
            v3 = dx * dx + dy * dy
            assert abs(float(v3[0] - v3[2])) < 2e-6 * float(v3[0])
