"""The torch port's differentiable distance transform (K4's backward)
against the JAX package.

The same seeded inputs go through the port's `dt1d(...,
differentiable=True)` (its plain backward `dt1d_bwd_plain` on the CPU)
and through the JAX package's two gradients: the interpreted Pallas
kernel's custom VJP (`_diff_dt`, K4) and autodiff of the XLA path. The
port's DT runs along axis -2, the JAX one along the last axis, so the
port sees the transposed maps. The tolerance is rtol/atol 1e-5, as in
tests/test_pallas_dt.py's custom-VJP check: the terms of g_a and g_b are
rounded alike, their sums run in another order.
"""

import os
import stat
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partsbaseddetector_tpu.models.model import make_synthetic_model, pack_model
from partsbaseddetector_tpu.ops import distance_transform as jdt
from partsbaseddetector_tpu.ops import dp as jdp
from partsbaseddetector_tpu.ops import pyramid as jpyr
from partsbaseddetector_tpu.ops.pallas_dt import dt1d_pallas
from partsbaseddetector_tpu.train.sgd import model_params
from partsbaseddetector_tpu_torch import kernels
from partsbaseddetector_tpu_torch.models.convert import model_from_jax, params_from_jax
from partsbaseddetector_tpu_torch.models.model import pack_model as tpack
from partsbaseddetector_tpu_torch.models.model import to_device
from partsbaseddetector_tpu_torch.ops import distance_transform as tdt
from partsbaseddetector_tpu_torch.ops import dp as tdp
from partsbaseddetector_tpu_torch.ops import dt_cuda

TOL = dict(rtol=1e-5, atol=1e-5)


def _dt_case(seed, bsz, n, w):
    rng = np.random.RandomState(seed)
    src = (rng.randn(bsz, w, n) * 3).astype(np.float32)  # JAX layout
    a = -(0.01 + 0.05 * rng.rand(bsz)).astype(np.float32)
    b = (0.3 * rng.randn(bsz)).astype(np.float32)
    sh = rng.randint(-3, 4, bsz).astype(np.float32)
    aux = rng.randint(0, 4096, (bsz, w, n)).astype(np.int32)
    return rng, src, a, b, sh, aux


def _port_grads(src, a, b, sh, aux, dlen, step, cot):
    """Port grads of sum(out * cot) with the maps transposed to axis -2."""
    ts = torch.tensor(np.swapaxes(src, -1, -2).copy(), requires_grad=True)
    ta = torch.tensor(a, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    out, _ = dt_cuda.dt1d(
        ts, ta, tb, torch.from_numpy(sh), dlen, step,
        aux=None if aux is None else torch.from_numpy(np.swapaxes(aux, -1, -2).copy()),
        differentiable=True,
    )
    (out * torch.from_numpy(np.swapaxes(cot, -1, -2).copy())).sum().backward()
    return np.swapaxes(ts.grad.numpy(), -1, -2), ta.grad.numpy(), tb.grad.numpy()


@pytest.mark.parametrize("with_aux", [False, True])
@pytest.mark.parametrize("n,dlen,step", [(21, 19, 1), (24, 11, 2)])
def test_dt1d_grads_match_jax(n, dlen, step, with_aux):
    bsz, w = 4, 5
    rng, src, a, b, sh, aux = _dt_case(n + step, bsz, n, w)
    aux = aux if with_aux else None
    cot = rng.randn(bsz, w, dlen).astype(np.float32)
    got = _port_grads(src, a, b, sh, aux, dlen, step, cot)

    a2, b2, sh2 = (jnp.asarray(x)[:, None] for x in (a, b, sh))

    def loss_pallas(s, a_, b_):
        out, _ = dt1d_pallas(
            s, a_, b_, sh2, dlen, step, interpret=True, differentiable=True,
            aux=None if aux is None else jnp.asarray(aux),
        )
        return jnp.sum(out * cot)

    def loss_xla(s, a_, b_):
        out, _ = jdt._dt1d(s, a_, b_, sh2, dlen, step, use_pallas=False)
        return jnp.sum(out * cot)

    for loss in (loss_pallas, loss_xla):
        want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(src), a2, b2)
        for g, w_ in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w_).reshape(g.shape), **TOL)


def test_dt1d_bwd_plain_by_hand():
    """One map, integer data: the scatter, the tie rule and the g*d sums
    written out; a -inf output passes no gradient."""
    src = torch.tensor([[[0.0], [3.0], [2.0], [-np.inf]]])  # (1, 4, 1)
    a, b, sh = torch.tensor([-1.0]), torch.tensor([0.0]), torch.tensor([0.0])
    out, ptr = dt_cuda.dt1d(src, a, b, sh, 4, 1, nvalid=torch.tensor([3]))
    # out[q] = max_v src[v] - (q - v)^2; at q = 2, v = 1 and v = 2 tie at
    # 2 and the smaller source wins
    assert out[0, :, 0].tolist() == [2.0, 3.0, 2.0, 1.0]
    assert ptr[0, :, 0].tolist() == [1, 1, 1, 2]
    g = torch.tensor([[[1.0], [2.0], [3.0], [4.0]]])
    g_src, g_a, g_b = dt_cuda.dt1d_bwd_plain(g, out, ptr, sh, 4, 1, False)
    # d = q - v* = [-1, 0, 1, 1]
    assert g_src[0, :, 0].tolist() == [0.0, 6.0, 4.0, 0.0]
    assert g_a.tolist() == [8.0] and g_b.tolist() == [6.0]
    out_dead = out.clone()
    out_dead[0, 3, 0] = -np.inf
    g_src, g_a, g_b = dt_cuda.dt1d_bwd_plain(g, out_dead, ptr, sh, 4, 1, False)
    assert g_src[0, :, 0].tolist() == [0.0, 6.0, 0.0, 0.0]
    assert g_a.tolist() == [4.0] and g_b.tolist() == [2.0]


def test_dt1d_backward_refuses_other_devices():
    meta = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        dt_cuda.dt1d_bwd(meta(1, 3, 2), meta(1, 3, 2),
                         meta(1, 3, 2, dt=torch.int32), meta(1), 3, 1, False)


def _dt2d_train_inputs(seed):
    """Training-like maps: finite everywhere, -1e10 outside a valid
    extent (no live counts are passed to either package)."""
    rng = np.random.RandomState(seed)
    G, S, M, H, W = 2, 2, 2, 12, 10
    score = (rng.randn(G, S, M, H, W) * 4).astype(np.float32)
    for g in range(G):
        for s in range(S):
            for m in range(M):
                score[g, s, m, rng.randint(6, H + 1):, :] = -1e10
                score[g, s, m, :, rng.randint(5, W + 1):] = -1e10
    wdef = (np.abs(rng.randn(G, 1, M, 4)) * 0.05 + 0.01).astype(np.float32)
    sx = rng.randint(-2, 3, (G, 1, M)).astype(np.float32)
    sy = rng.randint(-2, 3, (G, 1, M)).astype(np.float32)
    return rng, score, wdef, sx, sy


@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("step,dlen_y,dlen_x", [(1, 11, 9), (2, 6, 5)])
def test_dt2d_grads_match_jax(impl, step, dlen_y, dlen_x, monkeypatch):
    monkeypatch.setenv("PBD_DT_IMPL", impl)
    rng, score, wdef, sx, sy = _dt2d_train_inputs(20 + step)
    cot = rng.randn(2, 2, 2, dlen_y, dlen_x).astype(np.float32)

    def jloss(sc, wd):
        msg, _ = jdt.shift_distance_transform_2d_packed(
            sc, wd, jnp.asarray(sx), jnp.asarray(sy), dlen_x=dlen_x,
            dlen_y=dlen_y, step=step, differentiable=True,
        )
        return jnp.sum(msg * cot), msg

    (jl, jmsg), (jg_s, jg_w) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True
    )(jnp.asarray(score), jnp.asarray(wdef))

    ts = torch.tensor(score, requires_grad=True)
    tw = torch.tensor(wdef, requires_grad=True)
    msg, _ = tdt.shift_distance_transform_2d_packed(
        ts, tw, torch.from_numpy(sx), torch.from_numpy(sy), dlen_x, dlen_y,
        step, differentiable=True,
    )
    (msg * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(msg.detach().numpy(), np.asarray(jmsg), rtol=1e-6)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(jg_s), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jg_w), **TOL)


def _tiny_dp_setup(seed=0):
    jm = make_synthetic_model(
        nparts=4, nmix=2, fsize=(3, 3), sbin=8, interval=2, seed=seed
    )
    jp = pack_model(jm)
    tp = tpack(model_from_jax(jm))
    fh, fw = jp.filters.shape[1:3]
    plan = jpyr.build_plan((64, 72), jp.spec, fh, fw, 1)
    rng = np.random.RandomState(seed)
    resps, vhs, vws = [], [], []
    for bucket in plan.buckets:
        vh, vw = jpyr.response_valid_extents(plan, bucket, jp.filter_sizes)
        r = rng.randn(
            len(bucket.scale_indices), bucket.resp_h, bucket.resp_w,
            jp.filters.shape[0],
        ).astype(np.float32)
        resps.append(np.array(jpyr.mask_responses(r, vh, vw, -1e10)))
        vhs.append(vh)
        vws.append(vw)
    return jm, jp, tp, plan, resps, vhs, vws, rng


def test_tree_min_sum_with_tensors_matches_jax():
    """rootv and the gradients of a weighted root-map sum w.r.t. the
    responses, defs and biases, for the trainable DP (JAX XLA path, op
    by op: under jit XLA:CPU contracts the DT's a*d + b into an FMA,
    which can move an argmax at a near-tie)."""
    jm, jp, tp, plan, resps, vhs, vws, rng = _tiny_dp_setup()
    b = len(plan.buckets) - 1
    jparams = {k: v for k, v in model_params(jm).items() if k != "filters"}
    comp = jp.components[0]
    cot = None

    def jloss(resps_j, prm):
        rv, _, _ = jdp.tree_min_sum(
            resps_j, comp, comp.tensors(prm), valid_extents=(vhs, vws),
            bucket_index=b,
        )
        return jnp.sum(rv * cot), rv

    rv_shape = (len(plan.buckets[b].scale_indices), plan.buckets[b].resp_h,
                plan.buckets[b].resp_w)
    cot = rng.rand(*rv_shape).astype(np.float32)
    (_, jrv), (jg_r, jg_p) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True
    )([jnp.asarray(r) for r in resps], jparams)

    tparams = params_from_jax(model_params(jm), device="cpu")
    tres = [torch.tensor(r, requires_grad=True) for r in resps]
    dm = to_device(tp, "cpu")
    rv, ri, tables = tdp.tree_min_sum(
        [r[None] for r in tres], tp.components[0], dm.components[0],
        valid_extents=(vhs, vws), bucket_index=b,
        tensors=tp.components[0].tensors(tparams),
    )
    rv = rv[0]  # a batch of one image
    assert sorted(tables) == [1, 2, 3]
    np.testing.assert_allclose(rv.detach().numpy(), np.asarray(jrv), rtol=1e-6)
    assert np.isfinite(rv.detach().numpy()).all()
    (rv * torch.from_numpy(cot)).sum().backward()
    for r, want in zip(tres, jg_r):
        np.testing.assert_allclose(r.grad.numpy(), np.asarray(want), **TOL)
    for k in ("defs", "biases"):
        np.testing.assert_allclose(
            tparams[k].grad.numpy(), np.asarray(jg_p[k]), **TOL
        )


def test_component_tensors_match_jax():
    jm = make_synthetic_model(nparts=5, nmix=3, seed=2)
    jp = pack_model(jm)
    tp = tpack(model_from_jax(jm))
    jparams = model_params(jm)
    tparams = params_from_jax(jparams, device="cpu")
    for want, got in zip(jp.components[0].tensors(jparams),
                         tp.components[0].tensors(tparams)):
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    bias = tp.components[0].tensors(tparams)[1]
    assert (bias.detach().numpy() == np.float32(-1e10)).any()
    assert np.isfinite(bias.detach().numpy()).all()


def test_build_compiles_each_source_then_links(tmp_path, monkeypatch):
    """kernels.build runs one nvcc per source, all started before any is
    waited on, then one link, and keeps every compiler's output in the
    log (a stand-in nvcc records its calls)."""
    calls = tmp_path / "calls"
    fake = tmp_path / "nvcc"
    fake.write_text(textwrap.dedent(f"""\
        #!/bin/sh
        echo "$@" >> {calls}
        out=""; prev=""
        for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done
        echo built > "$out"
        echo "ptxas info : Used 10 registers"
        """))
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    lib = kernels.build()
    assert lib.exists() and lib.parent == tmp_path / "build"
    lines = calls.read_text().splitlines()
    srcs = kernels.sources()
    assert {p.name for p in srcs} >= {"dt1d.cu", "dt1d_bwd.cu", "conv.cu"}
    assert len(lines) == len(srcs) + 1
    assert all(" -c " in l and "-shared" not in l for l in lines[:-1])
    assert "-shared" in lines[-1] and lines[-1].count(".o") == len(srcs)
    log = lib.with_suffix(".log").read_text()
    assert log.count("Used 10 registers") == len(srcs) + 1
    assert kernels.build() == lib  # cached by content
    assert len(calls.read_text().splitlines()) == len(lines)
