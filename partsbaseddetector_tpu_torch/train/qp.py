"""Dual coordinate-descent QP for the structural SVM.

NumPy re-expression of the reference's global QP cache and solver
(matlab/learning/qp_write.m, qp_one.m, qp_opt.m, qp_prune.m,
qp_refresh.m and the qp_one_sparse.cc MEX kernel). Semantics kept:

  - standard-form substitution v = (w - w0) * wreg with
    x' = C * (+-phi) / wreg, b' = C * (1 - w0 . (+-phi)) so the dual box
    is alpha in [0, 1] with a per-id linear constraint
    sum_{j in id} alpha_j <= 1 (one slack per id);
  - one pass = randomized coordinate descent over the support set with
    (a) plain projected updates, (b) pairwise alpha exchange when the
    id's linear constraint is active (qp_one.m:96-140), and support
    flag clearing for alpha=0, G>0 examples;
  - non-negativity clamps on v at the deformation quadratic positions
    after every update (qp_one_sparse.cc:247-255);
  - qp_opt: iterate passes until duality gap < tol with the true upper
    bound computed from per-id max slacks (qp_opt.m computeloss);
  - prune: drop non-support examples when the cache fills, keeping
    fixed examples (warped positives) pinned.

Two example storages:

  - "dense": float64 (nmax, dim) rows — exact, the oracle default for
    small layouts and the parity tests.
  - "sparse": the scaling storage matching the reference's engineering.
    train.m:44-67 sizes its cache from a memory budget
    (nmax = round(maxsize*.25e9/sparselen(model)): budget bytes over
    bytes per block-sparse single-precision example) and stores each
    example as float32 block-sparse (sparse2dense.m encodes
    [nblocks; (i1,i2,values...)...]; qp_one_sparse.cc:20-90 score/dot/
    add walk the blocks, accumulating in double). Here each example
    keeps (int32 indices, float32 values) of its nonzero support —
    same 4-byte payloads, same f32-storage/f64-accumulation split —
    because one placement touches only its chosen mixtures' filter,
    def and bias blocks, ~6x fewer entries than the dense person26
    layout. QPSolver(memory_gb=...) reproduces the budget sizing.

A NumPy copy of `partsbaseddetector_tpu/train/qp.py`,
kept verbatim so that the port never imports the JAX package.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .layout import ParamLayout


def example_sparselen(model) -> Tuple[int, int]:
    """Worst-case (nnz, nblocks) of one placement's feature over the
    model's components (train.m:207-239 sparselen): per part, one bias
    entry + one filter block (largest mixture) + one 4-wide def block.
    Used to size the budgeted cache BEFORE any example exists."""
    best_nnz, best_blocks = 1, 1
    for c in range(model.ncomponents):
        filterid = model.filterid[c]
        nnz, nblocks = 0, 0
        for p in range(model.nparts(c)):
            nnz += 1  # bias indicator
            nblocks += 1
            fids = np.asarray(filterid[p]).ravel()
            nnz += max(int(model.filters[int(f)].size) for f in fids)
            nblocks += 1
            if p > 0:
                nnz += 4  # def block
                nblocks += 1
        best_nnz = max(best_nnz, nnz)
        best_blocks = max(best_blocks, nblocks)
    return best_nnz, best_blocks


class _DenseRows:
    """float64 (nmax, dim) example rows — the exact oracle storage."""

    def __init__(self, nmax: int, dim: int):
        self.x = np.zeros((nmax, dim), dtype=np.float64)

    def set(self, i: int, vec: np.ndarray) -> float:
        self.x[i] = vec
        return float(vec @ vec)

    def dot_w(self, i: int, w: np.ndarray) -> float:
        return float(self.x[i] @ w)

    def dot_rows(self, i: int, j: int) -> float:
        return float(self.x[i] @ self.x[j])

    def axpy(self, i: int, coef: float, w: np.ndarray) -> None:
        w += coef * self.x[i]

    def matvec(self, idx: np.ndarray, w: np.ndarray) -> np.ndarray:
        return self.x[idx] @ w

    def accumulate(self, order: np.ndarray, a: np.ndarray) -> np.ndarray:
        return self.x[order].T @ a[order]

    def reorder(self, keep: np.ndarray) -> None:
        self.x[: len(keep)] = self.x[keep]

    @property
    def nbytes(self) -> int:
        return self.x.nbytes


class _SparseRows:
    """float32 values + int32 indices per example — the reference's
    single-precision block-sparse cache (qp_one_sparse.cc) with flat
    index+value payloads; all reductions accumulate in float64."""

    def __init__(self, nmax: int, dim: int):
        self.idx: List[Optional[np.ndarray]] = [None] * nmax
        self.val: List[Optional[np.ndarray]] = [None] * nmax
        self.dim = dim
        self._bytes = 0

    def set(self, i: int, vec: np.ndarray) -> float:
        nz = np.flatnonzero(vec)
        if self.idx[i] is not None:
            self._bytes -= self.idx[i].nbytes + self.val[i].nbytes
        self.idx[i] = nz.astype(np.int32)
        # one rounding to f32 at write time (train.m stores qp.x single)
        self.val[i] = vec[nz].astype(np.float32)
        self._bytes += self.idx[i].nbytes + self.val[i].nbytes
        v = self.val[i].astype(np.float64)
        return float(v @ v)

    def dot_w(self, i: int, w: np.ndarray) -> float:
        return float(w[self.idx[i]] @ self.val[i].astype(np.float64))

    def dot_rows(self, i: int, j: int) -> float:
        # sorted-index intersection, the qp_one_sparse.cc:31-72 dot
        common, ia, ib = np.intersect1d(
            self.idx[i], self.idx[j], assume_unique=True,
            return_indices=True,
        )
        if len(common) == 0:
            return 0.0
        return float(
            self.val[i][ia].astype(np.float64)
            @ self.val[j][ib].astype(np.float64)
        )

    def axpy(self, i: int, coef: float, w: np.ndarray) -> None:
        # indices are unique: fancy in-place add is exact
        w[self.idx[i]] += coef * self.val[i].astype(np.float64)

    def matvec(self, idx: np.ndarray, w: np.ndarray) -> np.ndarray:
        return np.asarray([self.dot_w(int(i), w) for i in idx])

    def accumulate(self, order: np.ndarray, a: np.ndarray) -> np.ndarray:
        w = np.zeros(self.dim)
        for i in order:
            self.axpy(int(i), float(a[i]), w)
        return w

    def reorder(self, keep: np.ndarray) -> None:
        n = len(keep)
        self.idx[:n] = [self.idx[k] for k in keep]
        self.val[:n] = [self.val[k] for k in keep]
        for j in range(n, len(self.idx)):
            if self.idx[j] is not None:
                self._bytes -= self.idx[j].nbytes + self.val[j].nbytes
            self.idx[j] = None
            self.val[j] = None
        self._bytes = sum(
            self.idx[j].nbytes + self.val[j].nbytes
            for j in range(n)
            if self.idx[j] is not None
        )

    @property
    def nbytes(self) -> int:
        return self._bytes


class QPSolver:
    def __init__(
        self,
        layout: ParamLayout,
        nmax: Optional[int] = None,
        cpos: float = 0.002,
        cneg: float = 0.002,
        seed: int = 0,
        storage: str = "dense",
        memory_gb: Optional[float] = None,
        example_nnz: Optional[int] = None,
    ):
        """memory_gb sizes the cache from a budget instead of an example
        count (train.m:44-67): nmax = budget_bytes / bytes-per-example,
        with bytes-per-example = 8 * worst-case nnz (int32 index +
        float32 value per entry; pass example_nnz from
        example_sparselen(model), else a dense row is assumed). Setting
        memory_gb implies storage="sparse"."""
        self.layout = layout
        dim = layout.length
        if memory_gb is not None:
            storage = "sparse"
            nnz = int(example_nnz) if example_nnz else dim
            per_ex = 8 * nnz + 64  # idx+val payload + object overhead
            nmax = max(10, int(memory_gb * 1e9 / per_ex))
        if nmax is None:
            raise ValueError("QPSolver needs nmax or memory_gb")
        if storage not in ("dense", "sparse"):
            raise ValueError(f"unknown QP storage: {storage}")
        self.storage = storage
        self.nmax = int(nmax)
        self.cpos, self.cneg = float(cpos), float(cneg)
        rows_cls = _DenseRows if storage == "dense" else _SparseRows
        self.rows = rows_cls(self.nmax, dim)
        self.b = np.zeros(self.nmax)
        self.d = np.zeros(self.nmax)  # Gram diagonal
        self.a = np.zeros(self.nmax)  # alphas
        self.ids = np.zeros((self.nmax, 5), dtype=np.int64)
        self.sv = np.zeros(self.nmax, dtype=bool)
        self.svfix = np.zeros(self.nmax, dtype=bool)
        self.n = 0
        self.w = np.zeros(dim)  # v, standard form
        self.l = 0.0
        self.lb = -np.inf
        self.ub = np.inf
        self.rng = np.random.RandomState(seed)

    # -- example management ---------------------------------------------------

    @property
    def full(self) -> bool:
        return self.n >= self.nmax

    @property
    def x(self) -> np.ndarray:
        """Dense example matrix (dense storage only; oracle tests)."""
        return self.rows.x

    @property
    def cache_bytes(self) -> int:
        """Bytes held by the example cache (the budget being enforced)."""
        return self.rows.nbytes

    def write(self, phi: np.ndarray, example_id, label: int, fixed=False) -> bool:
        """Add one example; phi is the raw feature, label +-1
        (qp_write.m standard-form substitution)."""
        if self.full:
            return False
        c = self.cpos if label > 0 else self.cneg
        s = phi if label > 0 else -phi
        i = self.n
        self.d[i] = self.rows.set(i, c * s / self.layout.wreg)
        self.b[i] = c * (1.0 - self.layout.w0 @ s)
        self.a[i] = 0.0
        eid = np.asarray(example_id, dtype=np.int64).ravel()
        self.ids[i, : len(eid)] = eid
        self.ids[i, 0] = label
        self.sv[i] = True
        self.svfix[i] = fixed
        self.n += 1
        return True

    # -- weight access ---------------------------------------------------------

    def actual_w(self) -> np.ndarray:
        """Real model weights: w = v / wreg + w0 (qp_w.m)."""
        return self.w / self.layout.wreg + self.layout.w0

    def set_w_from_model_vec(self, wvec: np.ndarray) -> None:
        """Seed v from real model weights: v = (w - w0) * wreg
        (train.m:68-71)."""
        self.w = (wvec - self.layout.w0) * self.layout.wreg

    def score(self, idx) -> np.ndarray:
        return self.rows.matvec(np.asarray(idx, dtype=np.int64), self.w)

    def score_positives(self) -> np.ndarray:
        """Raw (unscaled) scores w.phi of the positive examples
        (qp_scorepos analog): x.v = C*phi.(v/wreg) and
        b = C*(1 - w0.phi), so w.phi = x.v/C + 1 - b/C."""
        idx = np.flatnonzero(self.ids[: self.n, 0] > 0)
        return self.score(idx) / self.cpos + 1.0 - self.b[idx] / self.cpos

    def reset_examples(self) -> None:
        """Drop all cached examples (train.m:75 'qp.n = 0')."""
        self.n = 0
        self.a[:] = 0
        self.sv[:] = False
        self.svfix[:] = False

    # -- solver -----------------------------------------------------------------

    def refresh(self) -> None:
        """Recompute v, l, lb from alphas, small alphas first
        (qp_refresh.m)."""
        idx = np.flatnonzero(self.a[: self.n] > 0)
        if len(idx):
            order = idx[np.argsort(self.a[idx], kind="stable")]
            self.w = self.rows.accumulate(order, self.a)
            self.l = float(self.b[order] @ self.a[order])
        else:
            self.w = np.zeros_like(self.w)
            self.l = 0.0
        nn = self.layout.noneg
        self.w[nn] = np.maximum(self.w[nn], 0)
        self.lb = self.l - 0.5 * float(self.w @ self.w)

    def _id_groups(self) -> Tuple[np.ndarray, np.ndarray]:
        """Group indices [0, n) by example id. Returns (group_of (n,),
        ngroups)."""
        keys = self.ids[: self.n]
        _, group_of = np.unique(keys, axis=0, return_inverse=True)
        return group_of, group_of.max() + 1 if self.n else 0

    def one(self) -> float:
        """One randomized coordinate-descent pass (qp_one.m). Returns
        the estimated loss for the upper bound."""
        idx = np.flatnonzero(self.sv[: self.n])
        assert len(idx) > 0
        self.rng.shuffle(idx)
        group_of, ngroups = self._id_groups()
        c = 1.0
        # per-group alpha sums and an example holding positive alpha
        g_sum = np.zeros(ngroups)
        g_holder = np.full(ngroups, -1, dtype=np.int64)
        for i in range(self.n):
            g = group_of[i]
            g_sum[g] += self.a[i]
            if self.a[i] > 0:
                g_holder[g] = i
        err = np.zeros(ngroups)
        nn = self.layout.noneg

        for i in idx:
            g = group_of[i]
            ci = g_sum[g]
            grad = self.rows.dot_w(i, self.w) - self.b[i]
            err[g] = max(err[g], -grad)

            if self.a[i] == 0 and grad > 0:
                self.sv[i] = False

            if (self.a[i] == 0 and grad >= 0) or (ci >= c and grad <= 0):
                pg = 0.0
            else:
                pg = grad

            if (
                ci >= c
                and grad < -1e-12
                and self.a[i] < c
                and g_holder[g] != i
                and g_holder[g] >= 0
            ):
                # pairwise exchange within the id block (qp_one.m:96-140)
                i2 = int(g_holder[g])
                g2 = self.rows.dot_w(i2, self.w) - self.b[i2]
                numer = grad - g2
                if self.a[i] == 0 and numer > 0:
                    numer = 0.0
                    self.sv[i] = False
                if abs(numer) > 1e-12:
                    denom = self.d[i] + self.d[i2] - 2 * self.rows.dot_rows(
                        i, i2
                    )
                    da = -numer / max(denom, 1e-12)
                    if da > 0:
                        da = min(min(da, c - self.a[i]), self.a[i2])
                    else:
                        da = max(max(da, -self.a[i]), self.a[i2] - c)
                    self.a[i] += da
                    self.a[i2] -= da
                    self.rows.axpy(i, da, self.w)
                    self.rows.axpy(i2, -da, self.w)
                    self.w[nn] = np.maximum(self.w[nn], 0)
                    self.l += da * (self.b[i] - self.b[i2])
            elif abs(pg) > 1e-12:
                old = self.a[i]
                max_a = max(c - (ci - old), 0.0)
                self.a[i] = min(
                    max(old - grad / max(self.d[i], 1e-12), 0.0), max_a
                )
                da = self.a[i] - old
                self.rows.axpy(i, da, self.w)
                self.w[nn] = np.maximum(self.w[nn], 0)
                self.l += da * self.b[i]
                g_sum[g] = min(max(ci + da, 0.0), c)
            if self.a[i] > 0:
                g_holder[g] = i

        self.refresh()
        self.sv[: self.n][self.svfix[: self.n]] = True
        self.ub = 0.5 * float(self.w @ self.w) + float(err.sum())
        return float(err.sum())

    def _true_upper_bound(self) -> float:
        """0.5||v||^2 + sum of per-id max positive slacks
        (qp_opt.m computeloss)."""
        group_of, ngroups = self._id_groups()
        slack = self.b[: self.n] - self.rows.matvec(
            np.arange(self.n), self.w
        )
        loss = 0.0
        for g in range(ngroups):
            m = slack[group_of == g].max(initial=0.0)
            loss += max(m, 0.0)
        return 0.5 * float(self.w @ self.w) + loss

    def opt(self, tol: float = 0.05, iters: int = 1000) -> None:
        """Iterate passes until the relative duality gap < tol
        (qp_opt.m)."""
        if self.n == 0:
            return
        self.refresh()
        ub = self._true_upper_bound()
        self.sv[: self.n] = True
        for _ in range(iters):
            self.one()
            lb = self.lb
            ub_est = min(self.ub, ub)
            if lb > 0 and 1 - lb / ub_est < tol:
                ub = min(ub, self._true_upper_bound())
                if 1 - lb / ub < tol:
                    break
                self.sv[: self.n] = True
        self.ub = ub

    def prune(self) -> int:
        """Keep only support vectors (qp_prune.m); alpha>0 and fixed
        examples survive a full cache."""
        if self.sv[: self.n].all():
            self.sv[: self.n] = self.a[: self.n] > 0
            self.sv[: self.n][self.svfix[: self.n]] = True
        keep = np.flatnonzero(self.sv[: self.n])
        n = len(keep)
        assert n > 0
        self.rows.reorder(keep)
        for arr in (self.b, self.d, self.a, self.ids, self.sv, self.svfix):
            arr[:n] = arr[keep]
        self.a[n:] = 0
        self.sv[:n] = True
        self.sv[n:] = False
        self.svfix[n:] = False
        self.n = n
        self.refresh()
        return n
