"""The torch port's tree DP and backtracking against the JAX package.

Both packages get the same masked response stacks (NumPy, from a seed).
The JAX side runs its default CPU path (the XLA distance transform),
whose arithmetic the port's plain DT reproduces bit for bit, so root
scores, root mixtures and the packed (Ik << 24 | Iy << 12 | Ix) pointer
tables must be identical wherever they are live: a table entry is live
where the parent's own response is finite (elsewhere the parent score
is -inf whatever the message, and the JAX package's XLA path and the
port's kernel skip different dead rows).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partsbaseddetector_tpu.models.model import make_synthetic_model, pack_model
from partsbaseddetector_tpu.ops import dp as jdp
from partsbaseddetector_tpu.ops import pyramid as jpyr
from partsbaseddetector_tpu.train.builder import merge_models
from partsbaseddetector_tpu_torch.models.convert import model_from_jax
from partsbaseddetector_tpu_torch.models.model import pack_model as tpack
from partsbaseddetector_tpu_torch.models.model import to_device
from partsbaseddetector_tpu_torch.ops import dp as tdp


def _setup(jm, imsize, bpo=1, seed=0):
    jp = pack_model(jm)
    tp = tpack(model_from_jax(jm))
    dm = to_device(tp, "cpu")
    fh, fw = jp.filters.shape[1:3]
    plan = jpyr.build_plan(imsize, jp.spec, fh, fw, bpo)
    rng = np.random.RandomState(seed)
    resps, vhs, vws = [], [], []
    for bucket in plan.buckets:
        vh, vw = jpyr.response_valid_extents(plan, bucket, jp.filter_sizes)
        r = rng.randn(
            len(bucket.scale_indices), bucket.resp_h, bucket.resp_w,
            jp.filters.shape[0],
        ).astype(np.float32)
        resps.append(np.array(jpyr.mask_responses(r, vh, vw)))
        vhs.append(vh)
        vws.append(vw)
    return jp, tp, dm, plan, resps, vhs, vws


def _parent_live(comp, p, vhs, vws, b, bpo, s, shape):
    """(S, L, Hp, Wp) mask: the parent's own response is finite."""
    par = int(comp.parentid[p])
    bb = b - int(comp.ds_total[par]) * bpo
    fid = comp.filterid[par]
    vh = vhs[bb][:s][:, fid]
    vw = vws[bb][:s][:, fid]
    _, _, hp, wp = shape
    return (
        (np.arange(hp)[None, None, :, None] < vh[:, :, None, None])
        & (np.arange(wp)[None, None, None, :] < vw[:, :, None, None])
    )


def _jax_dp(jp, resps, vhs, vws, b, bpo, c=0):
    return jdp.tree_min_sum(
        [jnp.asarray(r) for r in resps], jp.components[c], valid_extents=(vhs, vws),
        bucket_index=b, buckets_per_octave=bpo,
    )


def _run_both(jp, tp, dm, plan, resps, vhs, vws, b, bpo):
    """The JAX DP on one image's stacks and the port's on a batch of
    one (a leading image axis)."""
    comp = jp.components[0]
    jr = _jax_dp(jp, resps, vhs, vws, b, bpo)
    tr = tdp.tree_min_sum(
        [torch.from_numpy(r)[None] for r in resps], tp.components[0],
        dm.components[0], valid_extents=(vhs, vws), bucket_index=b,
        buckets_per_octave=bpo,
    )
    return comp, jr, tr


def _assert_dp_equal(comp, jr, tr, vhs, vws, b, bpo):
    jv, ji, jt = (np.asarray(jr[0]), np.asarray(jr[1]), jr[2])
    tv, ti = tr[0][0].numpy(), tr[1][0].numpy()
    tt = {p: t[0] for p, t in tr[2].items()}
    np.testing.assert_array_equal(tv, jv)  # -inf included
    assert np.isfinite(tv).any()
    live = np.isfinite(jv)
    np.testing.assert_array_equal(ti[live], ji[live])
    assert sorted(tt) == sorted(jt)
    for p, tbl in tt.items():
        want = np.asarray(jt[p])
        assert tbl.shape == want.shape
        mask = _parent_live(comp, p, vhs, vws, b, bpo, tv.shape[0], want.shape)
        assert mask.any()
        np.testing.assert_array_equal(tbl.numpy()[mask], want[mask])


@pytest.mark.parametrize("bpo", [1, 2])
def test_tree_min_sum_matches_jax(bpo):
    jm = make_synthetic_model(
        nparts=6, nmix=3, sbin=8, interval=4, seed=3,
        fsizes=[(5, 5), (3, 4), (4, 3)],
    )
    jp, tp, dm, plan, resps, vhs, vws = _setup(jm, (72, 88), bpo)
    for b in range(len(plan.buckets)):
        comp, jr, tr = _run_both(jp, tp, dm, plan, resps, vhs, vws, b, bpo)
        _assert_dp_equal(comp, jr, tr, vhs, vws, b, bpo)


def _forest_model():
    """Three trees over one pool: 6 parts x 3 mixtures (depth <= 5), a
    7-part chain x 3 (depth 6), and 4 parts x 2 with part 2's subtree
    one octave finer (ds = 1, step 2). The first two share groups."""
    a = make_synthetic_model(nparts=6, nmix=3, sbin=4, interval=2, seed=3,
                             fsizes=[(5, 5), (3, 4), (4, 3)])
    b = make_synthetic_model(nparts=7, nmix=3, sbin=4, interval=2, seed=4,
                             chain=True, fsizes=[(4, 4), (3, 3)])
    c = make_synthetic_model(nparts=4, nmix=2, sbin=4, interval=2, seed=8)
    for d in c.defid[0][2]:
        c.anchors[int(d)][2] = 1
    return merge_models([a, b, c])


def _forest(tp, dm, resps, vhs, vws, b, bpo):
    """The components bucket b scores, run as one forest: {c: (rootv,
    rooti, tables)} on a batch of one."""
    comps = [c for c, comp in enumerate(tp.components) if b >= comp.max_ds * bpo]
    plan = tdp.dp_plan(
        [torch.from_numpy(r)[None] for r in resps], [tp.components[c] for c in comps],
        [dm.components[c] for c in comps], (vhs, vws), b, bpo,
    )
    got = tdp.forest_min_sum([torch.from_numpy(r)[None] for r in resps], plan)
    return dict(zip(comps, got)), plan


@pytest.mark.parametrize("bpo", [1, 2])
def test_a_forest_of_three_trees_matches_jax_tree_by_tree(bpo):
    jp, tp, dm, plan, resps, vhs, vws = _setup(_forest_model(), (48, 64), bpo, seed=4)
    assert [c.max_ds for c in tp.components] == [0, 0, 1]
    assert [c.maxmix for c in tp.components] == [3, 3, 2]
    shared = 0
    for b in range(len(plan.buckets)):
        got, fplan = _forest(tp, dm, resps, vhs, vws, b, bpo)
        assert sorted(got) == ([0, 1, 2] if b >= bpo else [0, 1])
        shared += sum(len({c for c, _ in g.members}) > 1 for g in fplan.groups)
        for c, tr in got.items():
            jr = _jax_dp(jp, resps, vhs, vws, b, bpo, c)
            _assert_dp_equal(jp.components[c], jr, tr, vhs, vws, b, bpo)
    assert shared > 0


@pytest.mark.parametrize("bpo", [1, 2])
def test_a_tree_in_a_forest_is_the_tree_alone_bit_for_bit(bpo):
    """Every table entry, live or not, and the root maps: a tree's DP
    reads nothing of the other trees of its forest."""
    _, tp, dm, plan, resps, vhs, vws = _setup(_forest_model(), (48, 64), bpo, seed=5)
    stacks = [torch.from_numpy(r)[None] for r in resps]
    for b in range(len(plan.buckets)):
        got, _ = _forest(tp, dm, resps, vhs, vws, b, bpo)
        for c, (rootv, rooti, tables) in got.items():
            want = tdp.tree_min_sum(stacks, tp.components[c], dm.components[c],
                                    (vhs, vws), b, bpo)
            assert torch.equal(rootv, want[0]) and torch.equal(rooti, want[1])
            assert tables.keys() == want[2].keys()
            for p, tbl in tables.items():
                assert tbl.shape == want[2][p].shape and torch.equal(tbl, want[2][p])


def test_backtrack_merged_matches_jax():
    jm = make_synthetic_model(nparts=5, nmix=2, sbin=8, interval=4, seed=5)
    jp, tp, dm, plan, resps, vhs, vws = _setup(jm, (72, 88), bpo=2, seed=1)
    outs = [_run_both(jp, tp, dm, plan, resps, vhs, vws, b, 2)
            for b in range(len(plan.buckets))]
    comp = jp.components[0]
    scales = [
        np.asarray([plan.scales[s].box_scale for s in bk.scale_indices], np.float32)
        for bk in plan.buckets
    ]
    kw = dict(box_off_x=-jp.spec.padx, box_off_y=-jp.spec.pady,
              thresh=-1e9, max_det=40)
    want = jdp.backtrack_merged(
        [o[1][0] for o in outs], [o[1][1] for o in outs],
        [o[1][2] for o in outs], comp, [jnp.asarray(s) for s in scales], **kw,
    )
    got = tdp.backtrack_merged(
        [o[2][0] for o in outs], [o[2][1] for o in outs],
        [o[2][2] for o in outs], tp.components[0], dm.components[0],
        [torch.from_numpy(s) for s in scales], **kw,
    )
    boxes, vals, mix, valid = (x[0] for x in got[:4])
    coords = [c[0] for c in got[4]]
    assert bool(valid.all()) and vals.shape == (40,)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(boxes.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(mix.numpy(), np.asarray(want[2]))
    for g, w in zip(coords, want[4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_octave_offset_dp_and_backtrack_match_jax():
    """A part one octave below its parent reads the bucket one octave
    finer and runs the DT with step 2; `backtrack` walks it."""
    jm = make_synthetic_model(nparts=4, nmix=2, sbin=4, interval=2, seed=8)
    for d in jm.defid[0][2]:  # part 2 (and its subtree) one octave down
        jm.anchors[int(d)][2] = 1
    jp, tp, dm, plan, resps, vhs, vws = _setup(jm, (64, 80), bpo=1, seed=2)
    comp = jp.components[0]
    assert comp.max_ds == 1 and len(plan.buckets) >= 2
    b = len(plan.buckets) - 1
    comp, jr, tr = _run_both(jp, tp, dm, plan, resps, vhs, vws, b, 1)
    _assert_dp_equal(comp, jr, tr, vhs, vws, b, 1)
    scales = np.asarray(
        [plan.scales[s].box_scale for s in plan.buckets[b].scale_indices],
        np.float32,
    )
    kw = dict(box_off_x=-jp.spec.padx, box_off_y=-jp.spec.pady,
              thresh=-1e9, max_det=24)
    want = jdp.backtrack(jr[0], jr[1], jr[2], comp, jnp.asarray(scales), **kw)
    got = tdp.backtrack(
        tr[0], tr[1], tr[2], tp.components[0], dm.components[0],
        torch.from_numpy(scales), **kw,
    )
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))
    for g, w in zip(got[4], want[4]):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))


def test_stable_top_k_keeps_index_order_on_ties():
    x = torch.tensor([1.0, 3.0, 3.0, -math.inf, 2.0, 3.0])
    vals, idx = tdp.stable_top_k(x, 4)
    assert idx.tolist() == [1, 2, 5, 4]
    assert vals.tolist() == [3.0, 3.0, 3.0, 2.0]
