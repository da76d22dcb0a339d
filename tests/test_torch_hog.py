"""The torch port's resampling, HOG and pyramid against the JAX package.

Resampling and HOG sum f32 products in another order than XLA (and the
rsqrt may round differently), so features agree to 1e-5; the plan, the
valid extents and the -inf masking are integer/boolean logic and must be
identical. The port's ops take a leading image axis: a batch of one
here.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from partsbaseddetector_tpu.models.model import make_synthetic_model, pack_model
from partsbaseddetector_tpu.ops import hog as jhog
from partsbaseddetector_tpu.ops import pyramid as jpyr
from partsbaseddetector_tpu.ops import resize as jresize
from partsbaseddetector_tpu_torch.models.convert import model_from_jax
from partsbaseddetector_tpu_torch.models.model import pack_model as tpack
from partsbaseddetector_tpu_torch.ops import hog as thog
from partsbaseddetector_tpu_torch.ops import pyramid as tpyr
from partsbaseddetector_tpu_torch.ops import resize as tresize


def _image(seed, h, w):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.float32)


@pytest.mark.parametrize("h,w", [(37, 45), (64, 80), (41, 29)])
def test_resize_and_reduce_match_jax(h, w):
    im = _image(h, h, w)
    t = torch.from_numpy(im)[None]
    for scale in (0.87, 0.5):
        np.testing.assert_allclose(
            tresize.resize_image(t, scale)[0].numpy(),
            np.asarray(jresize.resize_image(im, scale)), rtol=1e-5, atol=1e-3,
        )
    np.testing.assert_allclose(
        tresize.reduce_image(t)[0].numpy(), np.asarray(jresize.reduce_image(im)),
        rtol=1e-5, atol=1e-3,
    )


@pytest.mark.parametrize("h,w,sbin", [(64, 80, 8), (53, 71, 8), (45, 38, 4)])
def test_hog_features_match_jax(h, w, sbin):
    im = _image(h + w, h, w)
    got = thog.hog_features(torch.from_numpy(im)[None], sbin)[0].numpy()
    want = np.asarray(jhog.hog_features(im, sbin))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_hog_strongest_channel_first_wins_ties():
    """Equal gradient magnitude in all channels: R must be picked (the
    MATLAB order), exactly as in the JAX package."""
    rng = np.random.RandomState(4)
    g = (rng.rand(40, 48, 1) * 255).astype(np.float32)
    im = np.concatenate([g, g, g], axis=2)
    got = thog.hog_features(torch.from_numpy(im)[None], 8)[0].numpy()
    want = np.asarray(jhog.hog_features(im, 8))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _models(border="matlab", **kw):
    jm = make_synthetic_model(**kw)
    return pack_model(jm, border=border), tpack(model_from_jax(jm), border=border)


@pytest.mark.parametrize("border", ["matlab", "cpp"])
@pytest.mark.parametrize("h,w,bpo", [(64, 80, 1), (67, 83, 2)])
def test_pyramid_features_match_jax(border, h, w, bpo):
    jp, tp = _models(
        border, nparts=3, nmix=2, sbin=8, interval=4, fsizes=[(5, 5), (3, 4)],
    )
    fh, fw = jp.filters.shape[1:3]
    jplan = jpyr.build_plan((h, w), jp.spec, fh, fw, bpo)
    tplan = tpyr.build_plan((h, w), tp.spec, fh, fw, bpo)
    for jx, tx in zip(jplan.buckets + jplan.scales, tplan.buckets + tplan.scales):
        assert dataclasses.astuple(jx) == dataclasses.astuple(tx)
    assert len(jplan.scales) == len(tplan.scales)
    im = _image(7, h, w)
    want = jpyr.build_pyramid_features(im, jplan, jp.spec)
    got = tpyr.build_pyramid_features(torch.from_numpy(im)[None], tplan, tp.spec)
    assert len(got) == len(want)
    for g, wnt in zip((g[0] for g in got), want):
        assert g.shape == wnt.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("border", ["matlab", "cpp"])
def test_valid_extents_and_masking_match_jax(border):
    jp, tp = _models(
        border, nparts=4, nmix=2, sbin=8, interval=3, fsizes=[(5, 5), (3, 4), (4, 2)],
    )
    fh, fw = jp.filters.shape[1:3]
    jplan = jpyr.build_plan((70, 90), jp.spec, fh, fw)
    tplan = tpyr.build_plan((70, 90), tp.spec, fh, fw)
    rng = np.random.RandomState(9)
    for jb, tb in zip(jplan.buckets, tplan.buckets):
        jvh, jvw = jpyr.response_valid_extents(jplan, jb, jp.filter_sizes, border)
        tvh, tvw = tpyr.response_valid_extents(tplan, tb, tp.filter_sizes, border)
        np.testing.assert_array_equal(jvh, tvh)
        np.testing.assert_array_equal(jvw, tvw)
        resp = rng.randn(
            len(tb.scale_indices), tb.resp_h, tb.resp_w, tp.filters.shape[0]
        ).astype(np.float32)
        want = np.asarray(jpyr.mask_responses(resp, jvh, jvw))
        got = tpyr.mask_responses(torch.from_numpy(resp), tvh, tvw, -math.inf)
        np.testing.assert_array_equal(got.numpy(), want)
