"""The port's QP stack (train/layout.py, train/qp.py) against the JAX
package's, on the same seeded inputs.

Mirrors tests/test_qp_sparse.py and the layout and QP tests of
tests/test_training.py: each case runs the same calls through both
packages, keeps the original case's assertions on the port, and asserts
that the two give the same bits (both are the same NumPy code).
"""

import types

import numpy as np
import pytest

import partsbaseddetector_tpu.models.model as jmodel
import partsbaseddetector_tpu.train.latent as jlatent
import partsbaseddetector_tpu.train.layout as jlayout
import partsbaseddetector_tpu.train.qp as jqp
import partsbaseddetector_tpu_torch.models.model as tmodel
import partsbaseddetector_tpu_torch.train.latent as tlatent
import partsbaseddetector_tpu_torch.train.layout as tlayout
import partsbaseddetector_tpu_torch.train.qp as tqp

JAX = types.SimpleNamespace(model=jmodel, layout=jlayout, qp=jqp, latent=jlatent)
PORT = types.SimpleNamespace(model=tmodel, layout=tlayout, qp=tqp, latent=tlatent)


def _both(fn):
    """fn(namespace) for the JAX package and the port; the results must
    be the same bits."""
    want, got = fn(JAX), fn(PORT)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    return got


def _toy_layout(ns, dim):
    return ns.layout.ParamLayout(
        bias_off=np.zeros(0, dtype=np.int64),
        filter_off=np.zeros(0, dtype=np.int64),
        filter_len=np.zeros(0, dtype=np.int64),
        def_off=np.zeros(0, dtype=np.int64),
        length=dim,
        w0=np.zeros(dim),
        wreg=np.ones(dim),
        noneg=np.zeros(0, dtype=np.int64),
    )


def _qp_state(qp):
    return [qp.actual_w(), qp.a[: qp.n], np.array([qp.lb, qp.ub, qp.n])]


def test_layout_roundtrip():
    def run(ns):
        model = ns.model.make_synthetic_model(nparts=4, nmix=2, seed=22)
        layout = ns.layout.ParamLayout.build(model)
        w = layout.model_to_vec(model)
        m2 = ns.model.make_synthetic_model(nparts=4, nmix=2, seed=22)
        for i in range(len(m2.filters)):
            m2.filters[i] = np.zeros_like(m2.filters[i])
        m2 = layout.vec_to_model(w, m2)
        np.testing.assert_allclose(m2.filters[1], model.filters[1], atol=1e-6)
        np.testing.assert_allclose(m2.biases, model.biases, atol=1e-6)
        # def quads have w0 floor and noneg registered
        assert len(layout.noneg) == 2 * len(model.defs)
        assert (layout.w0[layout.noneg] == 0.01).all()
        return [w, layout.w0, layout.wreg, layout.noneg, layout.filter_off,
                layout.def_off, layout.bias_off, *m2.filters, m2.biases,
                *m2.defs]

    _both(run)


@pytest.mark.parametrize("storage", ["dense", "sparse"])
def test_qp_separable_problem(storage):
    """Linearly separable data: the QP finds a separating w with dual <=
    primal and a shrinking duality gap."""

    def run(ns):
        rng = np.random.RandomState(0)
        dim = 10
        w_true = rng.randn(dim)
        qp = ns.qp.QPSolver(
            _toy_layout(ns, dim), nmax=200, cpos=1.0, cneg=1.0, seed=1,
            storage=storage,
        )
        for i in range(100):
            x = rng.randn(dim) * 2
            label = 1 if (x @ w_true) > 0 else -1
            qp.write(x, (label, i, 0, 0), label)
        qp.opt(tol=0.01, iters=2000)
        w = qp.actual_w()
        # a stored row is label*phi (cpos=1, wreg=1, w0=0): w.x > 0 means
        # separated; the sparse cache has no dense x, and score() is x.w
        if storage == "dense":
            correct = sum((qp.x[i] @ w) > 0 for i in range(qp.n))
        else:
            correct = int((qp.score(np.arange(qp.n)) > 0).sum())
        assert correct >= 95, f"only {correct}/100 separated"
        assert qp.lb <= qp.ub + 1e-6
        assert 1 - qp.lb / qp.ub < 0.05
        return _qp_state(qp)

    _both(run)


def test_qp_per_id_constraint():
    """Examples sharing an id share one slack: sum of their alphas <= 1."""

    def run(ns):
        rng = np.random.RandomState(2)
        dim = 6
        qp = ns.qp.QPSolver(_toy_layout(ns, dim), nmax=50, cpos=1.0, cneg=1.0,
                            seed=3)
        for i in range(30):
            qp.write(rng.randn(dim), (-1, i % 5, 0, 0), label=-1)
        qp.opt(tol=0.02, iters=500)
        group_of, ngroups = qp._id_groups()
        for g in range(ngroups):
            assert qp.a[: qp.n][group_of == g].sum() <= 1.0 + 1e-5
        return _qp_state(qp) + [group_of]

    _both(run)


def test_qp_noneg_projection():
    def run(ns):
        layout = _toy_layout(ns, 4)
        layout.noneg = np.array([1, 3])
        qp = ns.qp.QPSolver(layout, nmax=20, cpos=1.0, cneg=1.0)
        rng = np.random.RandomState(4)
        for i in range(15):
            lab = 1 if i % 2 else -1
            qp.write(rng.randn(4), (lab, i, 0, 0), lab)
        qp.opt(tol=0.05)
        assert (qp.w[layout.noneg] >= 0).all()
        return _qp_state(qp) + [qp.w]

    _both(run)


def _sparse_placement_phi(rng, layout, model):
    """A synthetic placement feature with the real sparsity pattern:
    one bias + one filter block + one def block per part."""
    phi = np.zeros(layout.length)
    c = 0
    for p in range(model.nparts(c)):
        bid = int(np.asarray(model.biasid[c][p]).ravel()[0])
        phi[layout.bias_off[bid]] = 1.0
        fid = int(rng.choice(np.asarray(model.filterid[c][p]).ravel()))
        off, ln = layout.filter_off[fid], layout.filter_len[fid]
        phi[off : off + ln] = rng.rand(ln).astype(np.float32)
        if p > 0:
            did = int(np.asarray(model.defid[c][p]).ravel()[0])
            j = layout.def_off[did]
            phi[j : j + 4] = rng.randn(4)
    return phi


def test_person26_budget_fits_5k_examples_in_2gb():
    """A person26-dim layout caches >= 5000 mined examples inside a 2 GB
    budget (train.m:44-67 nmax = budget / sparselen)."""

    def run(ns):
        model = ns.model.make_person_like_model()
        layout = ns.layout.ParamLayout.build(model)
        nnz, nblocks = ns.qp.example_sparselen(model)
        assert nnz < layout.length / 2, (nnz, layout.length)
        qp = ns.qp.QPSolver(layout, memory_gb=2.0, example_nnz=nnz, seed=0)
        assert qp.storage == "sparse"
        assert qp.nmax >= 5000, qp.nmax
        rng = np.random.RandomState(0)
        nsample = 64
        for i in range(nsample):
            assert qp.write(
                _sparse_placement_phi(rng, layout, model), (-1, i, 0, 0),
                label=-1,
            )
        per_ex = qp.cache_bytes / nsample
        assert per_ex * 5000 <= 2.0e9, (per_ex, per_ex * 5000)
        assert 5000 * layout.length * 8 > 2.0e9
        return [np.array([nnz, nblocks, qp.nmax, qp.cache_bytes]),
                layout.filter_off, qp.score(np.arange(qp.n))]

    _both(run)


def test_sparse_solver_matches_dense():
    """f32 block-sparse storage reproduces the dense f64 solver's optimum
    (storage rounds once to f32; accumulation stays f64)."""

    def run(ns):
        rng = np.random.RandomState(1)
        dim = 24
        w_true = rng.randn(dim)
        layout = _toy_layout(ns, dim)
        xs, labels = [], []
        for i in range(80):
            x = rng.randn(dim) * 2
            x[rng.rand(dim) < 0.6] = 0.0
            xs.append(x)
            labels.append(1 if (x @ w_true) > 0 else -1)
        qp_d = ns.qp.QPSolver(layout, nmax=100, cpos=1.0, cneg=1.0, seed=7)
        qp_s = ns.qp.QPSolver(
            layout, nmax=100, cpos=1.0, cneg=1.0, seed=7, storage="sparse"
        )
        for i, (x, lb) in enumerate(zip(xs, labels)):
            qp_d.write(x, (lb, i, 0, 0), lb)
            qp_s.write(x, (lb, i, 0, 0), lb)
        qp_d.opt(tol=0.005, iters=3000)
        qp_s.opt(tol=0.005, iters=3000)
        assert abs(qp_d.lb - qp_s.lb) / max(abs(qp_d.lb), 1e-9) < 5e-3
        np.testing.assert_allclose(
            qp_s.actual_w(), qp_d.actual_w(), rtol=0.05, atol=5e-3
        )
        group_of, ngroups = qp_s._id_groups()
        for g in range(ngroups):
            assert qp_s.a[: qp_s.n][group_of == g].sum() <= 1.0 + 1e-5
        return _qp_state(qp_d) + _qp_state(qp_s)

    _both(run)


def test_sparse_prune_and_refresh():
    """prune() reorders sparse rows correctly and refresh() rebuilds w
    from the surviving alphas."""

    def run(ns):
        rng = np.random.RandomState(3)
        dim = 12
        qp = ns.qp.QPSolver(
            _toy_layout(ns, dim), nmax=30, cpos=1.0, cneg=1.0, seed=5,
            storage="sparse",
        )
        for i in range(30):
            x = rng.randn(dim)
            x[rng.rand(dim) < 0.5] = 0.0
            qp.write(x, (1 if i % 2 else -1, i, 0, 0), 1 if i % 2 else -1)
        assert qp.full
        qp.opt(tol=0.02)
        w_before = qp.actual_w().copy()
        bytes_before = qp.cache_bytes
        n = qp.prune()
        assert 0 < n <= 30
        assert qp.cache_bytes <= bytes_before
        np.testing.assert_allclose(qp.actual_w(), w_before, atol=1e-10)
        qp.opt(tol=0.02)
        assert qp.lb <= qp.ub + 1e-9
        return _qp_state(qp) + [np.array([n, qp.cache_bytes])]

    _both(run)


def test_latent_train_sparse_budget_smoke():
    """train() end to end with the budgeted sparse cache on a small
    synthetic model, both packages with miner='reference' (the NumPy
    detector): the same trained weights, bit for bit."""

    def run(ns):
        model = ns.model.make_synthetic_model(
            nparts=2, nmix=1, fsize=(3, 3), sbin=8, interval=2, thresh=-1e9,
            seed=11,
        )
        rng = np.random.RandomState(4)
        im_pos = (rng.rand(96, 96, 3) * 255).astype(np.float64)
        boxes = np.asarray([[24.0, 24.0, 48.0, 48.0], [40.0, 40.0, 64.0, 64.0]])
        positives = [{"im": im_pos, "points": None, "boxes": boxes}]
        negatives = [{"im": (rng.rand(96, 96, 3) * 255).astype(np.float64)}]
        out = ns.latent.train(
            model, positives, negatives, warp=False, iters=1,
            miner="reference", qp_memory_gb=0.01, max_neg_per_image=8,
        )
        assert out is not None
        assert np.isfinite(out.thresh)
        return [*out.filters, out.biases, *out.defs, np.array(out.thresh)]

    _both(run)
