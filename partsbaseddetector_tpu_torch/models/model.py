"""Canonical part-model container and its packed device form.

A copy of `partsbaseddetector_tpu/models/model.py` (NumPy only), so the
port never imports the JAX package. `Model` is the plain host-side
container (MATLAB model layout, which SURVEY.md §7 designates
authoritative); `PackedModel` holds dense padded arrays plus static
topology metadata, and `to_device` moves its numeric arrays to torch
tensors on one device (`DeviceModel`). The synthetic generators keep
NumPy's `RandomState`, so a seed gives the same model as in the JAX
package.

Conventions (all 0-based):
  - parts are stored root-first; parentid[p] < p (exploited by the
    leaves->root unrolled message schedule, as in
    src/DynamicProgram.cpp:95 and detect_fast.m:41).
  - defw[k] = [ax, bx, ay, by] positive quadratic deformation costs
    (x pair first, matching shiftdt's argument order).
  - anchors[k] = (ax, ay, ds): part offset relative to its parent in
    feature cells, 0-based (MATLAB stores 1-based; loaders shift), plus
    the octave offset ds (detect_fast.m:93-105).
  - bias tables per part are dense (L_parent, K_child): value added to
    child mixture k's message into parent mixture l
    (detect_fast.m:134-136). The root table is (1, K_root).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops.conv import split_tf32

FLEN = 32
NORIENT = 18


@dataclasses.dataclass
class Model:
    """Canonical host-side model (MATLAB-layout authoritative)."""

    name: str
    interval: int
    sbin: int
    thresh: float
    # global pools
    filters: List[np.ndarray]  # each (fh, fw, flen) float32
    defs: List[np.ndarray]  # each (4,) [ax, bx, ay, by] positive costs
    anchors: List[np.ndarray]  # each (3,) int (ax, ay, ds), 0-based
    biases: np.ndarray  # (nbias,) float32 scalar pool
    # per-component indexing; component c, part p
    parentid: List[np.ndarray]  # [c] -> (P_c,) int, parentid[0] == 0
    filterid: List[List[np.ndarray]]  # [c][p] -> (K,) into filters
    defid: List[List[np.ndarray]]  # [c][p] -> (K,) into defs/anchors
    biasid: List[List[np.ndarray]]  # [c][p] -> (L, K) into biases
    norient: int = NORIENT
    flen: int = FLEN
    maxsize: Optional[Tuple[int, int]] = None  # (my, mx) cells, for padding

    @property
    def ncomponents(self) -> int:
        return len(self.parentid)

    def nparts(self, c: int = 0) -> int:
        return len(self.parentid[c])

    def nmixtures(self, c: int, p: int) -> int:
        return len(self.filterid[c][p])

    def max_filter_size(self) -> Tuple[int, int]:
        fh = max(f.shape[0] for f in self.filters)
        fw = max(f.shape[1] for f in self.filters)
        return fh, fw

    def effective_maxsize(self) -> Tuple[int, int]:
        """maxsize used for virtual padding; defaults to the largest
        filter (MATLAB's model.maxsize is the root template size)."""
        return self.maxsize if self.maxsize is not None else self.max_filter_size()

    def pad(self) -> Tuple[int, int]:
        """(pady, padx) = max(maxsize - 2, 0) (featpyramid.m:11-12)."""
        my, mx = self.effective_maxsize()
        return max(my - 2, 0), max(mx - 2, 0)

    def validate(self) -> None:
        for c in range(self.ncomponents):
            par = self.parentid[c]
            assert par[0] == 0, "root must be its own parent sentinel (0)"
            for p in range(1, len(par)):
                assert 0 <= par[p] < p, "parts must be stored root-first"
            for p in range(len(par)):
                k = len(self.filterid[c][p])
                if p == 0:
                    # the root carries no deformation (buildmodel.m:62)
                    assert len(self.defid[c][0]) in (0, k)
                else:
                    assert len(self.defid[c][p]) == k
                lpar = len(self.filterid[c][par[p]]) if p > 0 else 1
                assert self.biasid[c][p].shape == (lpar, k), (
                    f"bias table for part {p} must be (L_parent={lpar}, K={k}),"
                    f" got {self.biasid[c][p].shape}"
                )
        for f in self.filters:
            assert f.ndim == 3 and f.shape[2] == self.flen


# ---------------------------------------------------------------------------
# Packed device form
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Static hyperparameters the jitted pipeline specializes on.

    border: "matlab" (explicit featpyramid padding + valid conv, the
    authoritative semantics) or "cpp" (the C++ demo's 'same'-size
    responses with one-padded occlusion borders, emulated by placing
    each filter at offset pad - anchor inside the padded bank so all
    responses share one aligned grid)."""

    interval: int
    sbin: int
    thresh: float
    flen: int
    norient: int
    pady: int
    padx: int
    border: str = "matlab"


@dataclasses.dataclass
class PackedComponent:
    """Dense padded per-component arrays (host NumPy; see to_device for
    the torch copies). P parts, mixtures padded to M."""

    parentid: np.ndarray  # (P,) int32
    nmix: np.ndarray  # (P,) int32
    filterid: np.ndarray  # (P, M) int32; invalid mixtures repeat index 0
    mixmask: np.ndarray  # (P, M) bool
    defw: np.ndarray  # (P, M, 4) float32
    anchor: np.ndarray  # (P, M, 3) int32 (ax, ay, ds)
    shift_x: np.ndarray  # (P, M) int32  DT grid origin (anchor - virtpad)
    shift_y: np.ndarray  # (P, M) int32
    step: np.ndarray  # (P,) int32  2**ds
    bias: np.ndarray  # (P, M, M) float32 [l, k]; -inf on invalid k
    root_bias: np.ndarray  # (M,) float32; -inf on invalid mixtures
    fsize: np.ndarray  # (P, M, 2) int32 (fh, fw) true sizes in cells
    # index tables into the global pools (enable training: gather traced
    # parameter pools instead of baked constants)
    defidx: np.ndarray = None  # (P, M) int32 into defs pool
    biasidx: np.ndarray = None  # (P, M, M) int32 into bias pool, -1 invalid
    root_biasidx: np.ndarray = None  # (M,) int32, -1 invalid
    # accumulated octave offset below the root per part (sum of anchor
    # ds down the tree, detect_fast.m:93-105); a part with ds_total=d
    # reads its responses from the bucket d octaves finer
    ds_total: np.ndarray = None  # (P,) int32

    @property
    def max_ds(self) -> int:
        return int(self.ds_total.max()) if self.ds_total is not None else 0

    @property
    def nparts(self) -> int:
        return int(self.parentid.shape[0])

    @property
    def maxmix(self) -> int:
        return int(self.filterid.shape[1])

    def tensors(self, params=None):
        """(defw, bias, root_bias) either as baked host constants or
        gathered from a params dict {'defs', 'biases'} of torch tensors
        for the differentiable training path (gradients flow back into
        the pools). Invalid bias entries are -1e10 there, not -inf:
        -inf arithmetic turns gradients into NaNs."""
        if params is None:
            return self.defw, self.bias, self.root_bias
        biases = params["biases"]
        idx = lambda x: torch.as_tensor(
            np.asarray(x, np.int64), device=biases.device
        )
        defw = params["defs"][idx(self.defidx)]  # (P, M, 4)
        neg = torch.full((), -1e10, dtype=biases.dtype, device=biases.device)

        def gather(ids):
            ids = idx(ids)
            return torch.where(ids >= 0, biases[ids.clamp_min(0)], neg)

        return defw, gather(self.biasidx), gather(self.root_biasidx)


@dataclasses.dataclass
class PackedModel:
    spec: ModelSpec
    filters: np.ndarray  # (F, fh_max, fw_max, flen) zero-padded bank
    filter_sizes: np.ndarray  # (F, 2) int32 true (fh, fw)
    components: List[PackedComponent]
    name: str = ""

    @property
    def max_nparts(self) -> int:
        return max(c.nparts for c in self.components)


@dataclasses.dataclass
class DeviceComponent:
    """The numeric arrays of one PackedComponent as torch tensors.
    Topology (parentid, ds_total, step) stays host-side in the
    PackedComponent, because it drives the Python part schedule."""

    filterid: torch.Tensor  # (P, M) int64
    defw: torch.Tensor  # (P, M, 4) float32
    shift_x: torch.Tensor  # (P, M) float32
    shift_y: torch.Tensor  # (P, M) float32
    bias: torch.Tensor  # (P, M, M) float32
    root_bias: torch.Tensor  # (M,) float32
    fsize: torch.Tensor  # (P, M, 2) int64


@dataclasses.dataclass
class DeviceModel:
    filters: torch.Tensor  # (F, fh_max, fw_max, flen) float32
    components: List[DeviceComponent]
    device: torch.device
    # on CUDA: (2, F, fh_max, fw_max, flen), the filters split into their
    # TF32 big and small pieces, the operand the conv kernel stages
    # (ops/conv_cuda.py::split_bank), made once here; None on the CPU.
    # Replace it with `filters`.
    filters_split: Optional[torch.Tensor] = None


def to_device(packed: PackedModel, device) -> DeviceModel:
    """Copy a PackedModel's numeric arrays to torch tensors on `device`."""
    device = torch.device(device)
    f32 = lambda x: torch.as_tensor(
        np.asarray(x, np.float32), device=device
    )
    i64 = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=device)
    comps = [
        DeviceComponent(
            filterid=i64(c.filterid),
            defw=f32(c.defw),
            shift_x=f32(c.shift_x),
            shift_y=f32(c.shift_y),
            bias=f32(c.bias),
            root_bias=f32(c.root_bias),
            fsize=i64(c.fsize),
        )
        for c in packed.components
    ]
    filters = f32(packed.filters)
    split = torch.stack(split_tf32(filters)) if device.type == "cuda" else None
    return DeviceModel(
        filters=filters, components=comps, device=device, filters_split=split
    )


def pack_model(model: Model, border: str = "matlab") -> PackedModel:
    """Flatten the canonical model into padded dense arrays.

    border="cpp" packs for the C++ demo border semantics: the feature
    pad frame is one filter tall/wide (occlusion ones all through it)
    and every filter sits at offset (pad - cv_anchor) in the bank, so
    the shared valid-conv grid IS the C++ same-size response grid."""
    assert border in ("matlab", "cpp")
    model.validate()
    fh_max, fw_max = model.max_filter_size()
    if border == "cpp":
        # pad frame = pmax on each side (pyramid pads pady+1)
        pady, padx = fh_max - 1, fw_max - 1
    else:
        pady, padx = model.pad()
    spec = ModelSpec(
        interval=int(model.interval),
        sbin=int(model.sbin),
        thresh=float(model.thresh),
        flen=int(model.flen),
        norient=int(model.norient),
        pady=int(pady),
        padx=int(padx),
        border=border,
    )

    nf = len(model.filters)
    if border == "cpp":
        pmax_y, pmax_x = fh_max, fw_max
        dy = np.array(
            [pmax_y - f.shape[0] // 2 for f in model.filters], dtype=np.int64
        )
        dx = np.array(
            [pmax_x - f.shape[1] // 2 for f in model.filters], dtype=np.int64
        )
        bank_h = int(max(dy[i] + f.shape[0] for i, f in enumerate(model.filters)))
        bank_w = int(max(dx[i] + f.shape[1] for i, f in enumerate(model.filters)))
        filters = np.zeros((nf, bank_h, bank_w, model.flen), dtype=np.float32)
        fsizes = np.zeros((nf, 2), dtype=np.int32)
        for i, f in enumerate(model.filters):
            filters[i, dy[i] : dy[i] + f.shape[0], dx[i] : dx[i] + f.shape[1]] = f
            fsizes[i] = f.shape[:2]
    else:
        filters = np.zeros((nf, fh_max, fw_max, model.flen), dtype=np.float32)
        fsizes = np.zeros((nf, 2), dtype=np.int32)
        for i, f in enumerate(model.filters):
            filters[i, : f.shape[0], : f.shape[1], :] = f
            fsizes[i] = f.shape[:2]

    comps: List[PackedComponent] = []
    for c in range(model.ncomponents):
        P = model.nparts(c)
        M = max(model.nmixtures(c, p) for p in range(P))
        parentid = np.asarray(model.parentid[c], dtype=np.int32)
        nmix = np.array([model.nmixtures(c, p) for p in range(P)], dtype=np.int32)
        filterid = np.zeros((P, M), dtype=np.int32)
        mixmask = np.zeros((P, M), dtype=bool)
        defw = np.tile(
            np.array([1.0, 0.0, 1.0, 0.0], np.float32), (P, M, 1)
        )  # benign pad
        anchor = np.zeros((P, M, 3), dtype=np.int32)
        shift_x = np.zeros((P, M), dtype=np.int32)
        shift_y = np.zeros((P, M), dtype=np.int32)
        step = np.ones(P, dtype=np.int32)
        bias = np.full((P, M, M), -np.inf, dtype=np.float32)
        root_bias = np.full(M, -np.inf, dtype=np.float32)
        fsize = np.ones((P, M, 2), dtype=np.int32)
        defidx = np.zeros((P, M), dtype=np.int32)
        biasidx = np.full((P, M, M), -1, dtype=np.int32)
        root_biasidx = np.full(M, -1, dtype=np.int32)
        ds_total = np.zeros(P, dtype=np.int32)

        for p in range(P):
            k = nmix[p]
            fid = np.asarray(model.filterid[c][p], dtype=np.int32)
            filterid[p, :k] = fid
            filterid[p, k:] = fid[0]
            mixmask[p, :k] = True
            fsize[p, :k] = fsizes[fid]
            fsize[p, k:] = fsizes[fid[0]]
            if p == 0:
                root_bias[:k] = model.biases[model.biasid[c][0][0, :k]]
                root_biasidx[:k] = model.biasid[c][0][0, :k]
            else:
                did = np.asarray(model.defid[c][p], dtype=np.int64)
                defw[p, :k] = np.stack([model.defs[d] for d in did])
                defidx[p, :k] = did
                defidx[p, k:] = did[0]
                anchor[p, :k] = np.stack([model.anchors[d] for d in did])
                lpar = nmix[parentid[p]]
                tbl = model.biases[model.biasid[c][p]]  # (L, K)
                bias[p, :lpar, :k] = tbl
                biasidx[p, :lpar, :k] = model.biasid[c][p]
                ds = anchor[p, :k, 2]
                assert np.all(ds == ds[0]), (
                    "all mixtures of a part must share the octave offset"
                )
                ds_total[p] = int(ds[0]) + ds_total[parentid[p]]
                stepk = 1 << int(ds[0])
                step[p] = stepk
                if border == "cpp":
                    assert stepk == 1, (
                        "octave-offset parts are a MATLAB-path capability; "
                        "the C++ border mode has none"
                    )
                virtx = (stepk - 1) * padx
                virty = (stepk - 1) * pady
                # 0-based shiftdt grid origin: anchor - virtpad
                # (detect_fast.m:98-104 with the MEX's -1 already folded
                # into our 0-based anchors)
                shift_x[p, :k] = anchor[p, :k, 0] - virtx
                shift_y[p, :k] = anchor[p, :k, 1] - virty
                shift_x[p, k:] = shift_x[p, 0]
                shift_y[p, k:] = shift_y[p, 0]

        comps.append(
            PackedComponent(
                parentid=parentid,
                nmix=nmix,
                filterid=filterid,
                mixmask=mixmask,
                defw=defw,
                anchor=anchor,
                shift_x=shift_x,
                shift_y=shift_y,
                step=step,
                bias=bias,
                root_bias=root_bias,
                fsize=fsize,
                defidx=defidx,
                biasidx=biasidx,
                root_biasidx=root_biasidx,
                ds_total=ds_total,
            )
        )
    return PackedModel(
        spec=spec,
        filters=filters,
        filter_sizes=fsizes,
        components=comps,
        name=model.name,
    )


# ---------------------------------------------------------------------------
# Canonical npz serialization
# ---------------------------------------------------------------------------


def save_model(model: Model, path: str) -> None:
    """Serialize to a single .npz (the canonical on-disk format)."""
    model.validate()
    data = {
        "name": np.array(model.name),
        "interval": np.array(model.interval),
        "sbin": np.array(model.sbin),
        "thresh": np.array(model.thresh),
        "norient": np.array(model.norient),
        "flen": np.array(model.flen),
        "biases": np.asarray(model.biases, dtype=np.float32),
        "ncomponents": np.array(model.ncomponents),
        "maxsize": np.array(
            model.maxsize if model.maxsize is not None else (-1, -1)
        ),
    }
    for i, f in enumerate(model.filters):
        data[f"filter_{i}"] = np.asarray(f, dtype=np.float32)
    for i, d in enumerate(model.defs):
        data[f"def_{i}"] = np.asarray(d, dtype=np.float32)
        data[f"anchor_{i}"] = np.asarray(model.anchors[i], dtype=np.int32)
    for c in range(model.ncomponents):
        data[f"parentid_{c}"] = np.asarray(model.parentid[c], dtype=np.int32)
        for p in range(model.nparts(c)):
            data[f"filterid_{c}_{p}"] = np.asarray(
                model.filterid[c][p], dtype=np.int32
            )
            data[f"defid_{c}_{p}"] = np.asarray(model.defid[c][p], dtype=np.int32)
            data[f"biasid_{c}_{p}"] = np.asarray(model.biasid[c][p], dtype=np.int32)
    with open(path, "wb") as fh:
        np.savez_compressed(fh, **data)


def load_model(path: str) -> Model:
    """Load from any supported format by extension: .npz (canonical),
    .xml/.yml/.yaml (OpenCV FileStorage; .yml/.yaml need PyYAML), .mat
    (MATLAB v5/v7)."""
    lower = path.lower()
    if lower.endswith((".xml", ".yml", ".yaml")):
        from .filestorage import FileStorageModel

        return FileStorageModel.read(path)
    if lower.endswith(".mat"):
        from .matlabio import MatlabIOModel

        return MatlabIOModel.read(path)
    from .convert import model_from_arrays

    with np.load(path, allow_pickle=False) as z:
        return model_from_arrays(z)


# ---------------------------------------------------------------------------
# Synthetic models (tests + benchmarks; real demo models live in a git
# submodule the reference does not vendor)
# ---------------------------------------------------------------------------


def make_synthetic_model(
    name: str = "synthetic",
    nparts: int = 8,
    nmix: int = 2,
    fsize: Tuple[int, int] = (5, 5),
    sbin: int = 8,
    interval: int = 5,
    thresh: float = -1.0,
    ncomponents: int = 1,
    seed: int = 0,
    chain: bool = False,
    fsizes: Optional[List[Tuple[int, int]]] = None,
) -> Model:
    """Random tree model shaped like the reference's demo models.

    Person-like: nparts=26, nmix=4..6, fsize=(5,5), sbin=4, interval=10.
    Face-like: nparts=68 landmarks. Weights are N(0, 0.1) SVM-like
    filters; deformations positive-quadratic as the trainer initializes
    them (learning/buildmodel.m: def init [0.01 0 0.01 0]).
    fsizes (optional): per-part filter sizes (cycled), exercising the
    mixed-size padding paths.
    """
    rng = np.random.RandomState(seed)
    filters: List[np.ndarray] = []
    defs: List[np.ndarray] = []
    anchors: List[np.ndarray] = []
    biases: List[float] = []
    parentid, filterid, defid, biasid = [], [], [], []

    for c in range(ncomponents):
        par = np.zeros(nparts, dtype=np.int32)
        fid_c, did_c, bid_c = [], [], []
        for p in range(nparts):
            if p > 0:
                par[p] = p - 1 if chain else rng.randint(0, p)
            psize = fsizes[p % len(fsizes)] if fsizes else fsize
            fid = []
            for _ in range(nmix):
                filters.append(
                    (rng.randn(psize[0], psize[1], FLEN) * 0.1).astype(np.float32)
                )
                fid.append(len(filters) - 1)
            fid_c.append(np.array(fid, dtype=np.int32))
            did = []
            for _ in range(nmix):
                a = 0.01 + 0.04 * rng.rand(2)
                b = 0.02 * rng.randn(2)
                defs.append(
                    np.array([a[0], b[0], a[1], b[1]], dtype=np.float32)
                )
                anchors.append(
                    np.array(
                        [rng.randint(0, 2 * fsize[1]), rng.randint(0, 2 * fsize[0]), 0],
                        dtype=np.int32,
                    )
                )
                did.append(len(defs) - 1)
            did_c.append(np.array(did, dtype=np.int32))
            lpar = 1 if p == 0 else nmix
            tbl = np.zeros((lpar, nmix), dtype=np.int32)
            for l in range(lpar):
                for k in range(nmix):
                    biases.append(float(rng.randn() * 0.05))
                    tbl[l, k] = len(biases) - 1
            bid_c.append(tbl)
        parentid.append(par)
        filterid.append(fid_c)
        defid.append(did_c)
        biasid.append(bid_c)

    return Model(
        name=name,
        interval=interval,
        sbin=sbin,
        thresh=thresh,
        filters=filters,
        defs=defs,
        anchors=anchors,
        biases=np.array(biases, dtype=np.float32),
        parentid=parentid,
        filterid=filterid,
        defid=defid,
        biasid=biasid,
        maxsize=fsize,
    )


def make_person_like_model(seed: int = 0) -> Model:
    """26-part person pose model proxy (BASELINE config 2)."""
    return make_synthetic_model(
        name="person26",
        nparts=26,
        nmix=4,
        fsize=(5, 5),
        sbin=4,
        interval=10,
        thresh=0.3,
        seed=seed,
    )


def make_face_like_model(seed: int = 0) -> Model:
    """Face landmark model proxy (BASELINE config 1)."""
    return make_synthetic_model(
        name="face",
        nparts=39,
        nmix=3,
        fsize=(5, 5),
        sbin=4,
        interval=5,
        thresh=0.25,
        seed=seed,
    )
