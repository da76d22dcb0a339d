"""MATLAB .mat model (de)serialization via scipy.io.

Reads the Yang-Ramanan training-stack model struct (the format
matlab/learning/buildmodel.m produces and src/MatlabIOModel.cpp:71-188
consumes through the external cvmatio library):

    model.interval, model.sbin, model.thresh, model.maxsize, model.name
    model.filters(i).w   (fh, fw, flen) filter weights
    model.defs(i).w      (4,) [ax bx ay by], .anchor (3,) 1-based [ax ay ds]
    model.bias(i).w      scalar
    model.components{c}(p).parent / .filterid / .defid / .biasid

Index conversions: MATLAB is 1-based everywhere; anchors' x/y also
shift by 1 (exactly the `zeroIndex` handling in MatlabIOModel.cpp:44-58).
Unlike the C++ reader, we keep the per-part octave offset anchor(3)=ds
and the (L_parent, K_child) bias tables (capabilities the C++ port
dropped; detect_fast.m:93-105,134-136 is authoritative).

`write` produces a .mat the MATLAB stack can load (the reference's
serialize() is unimplemented — src/MatlabIOModel.cpp:191-195).

A copy of `partsbaseddetector_tpu/models/matlabio.py`, so that the
port never imports the JAX package.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .model import Model


def _as_list(obj) -> list:
    """Normalize scipy mat_struct arrays / scalars to a python list."""
    arr = np.atleast_1d(obj)
    return list(arr.ravel())


def _idxvec(obj) -> np.ndarray:
    return np.atleast_1d(np.asarray(obj)).astype(np.int64).ravel()


class MatlabIOModel:
    @staticmethod
    def read(path: str) -> Model:
        import scipy.io as sio

        try:
            data = sio.loadmat(path, squeeze_me=True, struct_as_record=False)
        except Exception as e:
            # scipy's MAT5 parser surfaces assorted internal errors on
            # corrupt bytes (incl. UnboundLocalError); normalize to one
            # clean, documented failure mode
            raise ValueError(f"malformed .mat model file {path!r}: {e}") from e
        if "model" not in data:
            raise KeyError(f"no 'model' variable in {path!r}")
        m = data["model"]

        interval = int(m.interval)
        sbin = int(m.sbin)
        thresh = float(m.thresh)
        name = str(getattr(m, "name", "")) or path.rsplit("/", 1)[-1].split(".")[0]
        maxsize = None
        if hasattr(m, "maxsize"):
            ms = np.atleast_1d(np.asarray(m.maxsize)).astype(int).ravel()
            if ms.size == 2:
                maxsize = (int(ms[0]), int(ms[1]))

        filters = []
        for f in _as_list(m.filters):
            w = np.asarray(f.w, dtype=np.float32)
            if w.ndim == 2:  # single-channel edge case
                w = w[:, :, None]
            filters.append(w)
        flen = filters[0].shape[2]

        defs: List[np.ndarray] = []
        anchors: List[np.ndarray] = []
        for d in _as_list(m.defs):
            defs.append(np.atleast_1d(np.asarray(d.w, dtype=np.float32)).ravel())
            a = _idxvec(d.anchor)
            ds = a[2] if a.size > 2 else 0
            # 1-based grid anchors -> 0-based (MatlabIOModel.cpp zeroIndex)
            anchors.append(np.array([a[0] - 1, a[1] - 1, ds], dtype=np.int32))

        biases = np.array(
            [float(np.asarray(b.w).ravel()[0]) for b in _as_list(m.bias)],
            dtype=np.float32,
        )

        comps_raw = m.components
        if not isinstance(comps_raw, np.ndarray):
            comps_raw = np.atleast_1d(comps_raw)
        # cell array of struct arrays; squeeze can collapse either level
        comp_list = []
        flat = list(np.atleast_1d(comps_raw).ravel())
        if flat and hasattr(flat[0], "parent"):
            comp_list = [flat]  # single component, squeezed
        else:
            comp_list = [_as_list(cell) for cell in flat]

        parentid, filterid, defid, biasid = [], [], [], []
        for parts in comp_list:
            P = len(parts)
            par = np.zeros(P, dtype=np.int32)
            fid_c, did_c, bid_c = [], [], []
            for p, part in enumerate(parts):
                par[p] = int(np.asarray(part.parent)) - 1 if p > 0 else 0
                fid_c.append((_idxvec(part.filterid) - 1).astype(np.int32))
                did_c.append((_idxvec(part.defid) - 1).astype(np.int32))
            for p, part in enumerate(parts):
                k = len(fid_c[p])
                lpar = 1 if p == 0 else len(fid_c[par[p]])
                braw = np.asarray(part.biasid)
                if braw.ndim == 2 and braw.shape == (lpar, k):
                    tbl = braw.astype(np.int64)
                elif braw.ndim == 2 and braw.shape == (k, lpar):
                    tbl = braw.T.astype(np.int64)
                else:
                    v = _idxvec(part.biasid)
                    if v.size == lpar * k:
                        # MATLAB column-major fill of an (L, K) matrix
                        tbl = v.reshape(k, lpar).T
                    elif v.size == k:
                        tbl = np.tile(v[None, :], (lpar, 1))
                    else:
                        raise ValueError(
                            f"cannot interpret biasid of size {v.size} for "
                            f"part {p} (L={lpar}, K={k})"
                        )
                bid_c.append((tbl - 1).astype(np.int32))
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
            biases=biases,
            parentid=parentid,
            filterid=filterid,
            defid=defid,
            biasid=biasid,
            flen=flen,
            maxsize=maxsize,
        )

    @staticmethod
    def write(model: Model, path: str) -> None:
        import scipy.io as sio

        model.validate()
        filters = np.empty(len(model.filters), dtype=object)
        for i, f in enumerate(model.filters):
            filters[i] = {"w": np.asarray(f, dtype=np.float64), "i": i + 1}
        defs = np.empty(len(model.defs), dtype=object)
        for i, (d, a) in enumerate(zip(model.defs, model.anchors)):
            defs[i] = {
                "w": np.asarray(d, dtype=np.float64),
                "i": i + 1,
                "anchor": np.array(
                    [a[0] + 1, a[1] + 1, a[2]], dtype=np.float64
                ),
            }
        bias = np.empty(len(model.biases), dtype=object)
        for i, b in enumerate(model.biases):
            bias[i] = {"w": float(b), "i": i + 1}

        comps = np.empty(model.ncomponents, dtype=object)
        for c in range(model.ncomponents):
            P = model.nparts(c)
            parts = np.empty(P, dtype=object)
            for p in range(P):
                parts[p] = {
                    "parent": int(model.parentid[c][p]) + 1 if p > 0 else 0,
                    "filterid": model.filterid[c][p].astype(np.float64) + 1,
                    "defid": model.defid[c][p].astype(np.float64) + 1,
                    "biasid": model.biasid[c][p].astype(np.float64) + 1,
                }
            comps[c] = parts

        mdl = {
            "name": model.name,
            "interval": float(model.interval),
            "sbin": float(model.sbin),
            "thresh": float(model.thresh),
            "len": float(model.flen),
            "filters": filters,
            "defs": defs,
            "bias": bias,
            "components": comps,
        }
        if model.maxsize is not None:
            mdl["maxsize"] = np.asarray(model.maxsize, dtype=np.float64)
        sio.savemat(path, {"model": mdl}, long_field_names=True)
