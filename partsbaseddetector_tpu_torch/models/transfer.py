"""Model format transfer: Felzenszwalb-VOC / Zhu-Face -> Yang-Pose.

Re-expression of matlab/modelTransfer.m: imports third-party trained
models into the canonical Model.

  - VOC (Felzenszwalb DPM, voc-release grammar models): walk
    rules/symbols/filters of every other start rule (skipping mirrored
    components) into flat star components — root + deformed parts
    (modelTransfer.m:78-159);
  - Face (Zhu-Ramanan): per-component global bias moves from the first
    def to the root bias; pairwise biases fill with one shared zero
    "dummy" bias (modelTransfer.m:163-213).

Both accept the dict trees scipy.io.loadmat produces (mat_struct
attribute access), so `transfer(path, 'VOC')` works directly on
published model files.

A copy of `partsbaseddetector_tpu/models/transfer.py`, so that the
port never imports the JAX package.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .model import Model


def _aslist(x) -> list:
    return list(np.atleast_1d(x).ravel())


def _filter_w(f) -> np.ndarray:
    w = np.asarray(f.w, dtype=np.float32)
    if w.ndim == 2:
        w = w[:, :, None]
    return w


def voc_to_face(m) -> dict:
    """VOC grammar model -> flat Face-style dict (modelTransfer.m:78-159).

    Takes every other component of the start symbol (the unmirrored
    ones); part 1 is the root, the rest hang off it in a star.
    """
    rules = _aslist(m.rules)
    symbols = _aslist(m.symbols)
    filters = _aslist(m.filters)
    start = int(np.asarray(m.start)) - 1
    start_rules = _aslist(rules[start])

    out_defs: List[dict] = []
    out_filters: List[np.ndarray] = []
    components: List[List[dict]] = []

    for c in range(0, len(start_rules), 2):
        rule = start_rules[c]
        comp: List[dict] = []
        # component offset becomes a 1-element "def" (the global bias)
        offset_w = float(np.asarray(rule.offset.w).ravel()[0])
        out_defs.append(dict(w=np.array([offset_w]), anchor=np.zeros(3)))
        def0 = len(out_defs) - 1

        rhs = [int(v) - 1 for v in _aslist(rule.rhs)]
        sym0 = symbols[rhs[0]]
        if str(np.asarray(sym0.type)) == "T":
            root_f = int(np.asarray(sym0.filter)) - 1
        else:
            sub = _aslist(rules[rhs[0]])[0]
            root_f = int(
                np.asarray(symbols[int(np.asarray(sub.rhs)) - 1].filter)
            ) - 1
        out_filters.append(_filter_w(filters[root_f]))
        comp.append(dict(filterid=len(out_filters) - 1, defid=def0, parent=-1))

        anchors = _aslist(rule.anchor)
        for i in range(1, len(rhs)):
            sub = _aslist(rules[rhs[i]])[0]
            out_defs.append(
                dict(
                    w=np.asarray(sub.def_.w if hasattr(sub, "def_") else sub.__dict__["def"].w,
                                 dtype=np.float64).ravel(),
                    anchor=np.asarray(anchors[i], dtype=np.float64).ravel(),
                )
            )
            fi = int(
                np.asarray(symbols[int(np.asarray(sub.rhs)) - 1].filter)
            ) - 1
            out_filters.append(_filter_w(filters[fi]))
            comp.append(
                dict(
                    filterid=len(out_filters) - 1,
                    defid=len(out_defs) - 1,
                    parent=0,
                )
            )
        components.append(comp)

    return dict(
        defs=out_defs,
        filters=out_filters,
        components=components,
        sbin=int(np.asarray(m.sbin)),
        interval=int(np.asarray(m.interval)),
        maxsize=tuple(int(v) for v in np.asarray(m.maxsize).ravel()[:2]),
        thresh=-0.6,
    )


def face_to_pose(face: dict, name: str = "transferred") -> Model:
    """Face-style dict -> canonical Model (modelTransfer.m:163-213)."""
    ncomp = len(face["components"])
    biases: List[float] = []
    # per-component global bias + one shared zero pairwise bias
    for comp in face["components"]:
        b = np.asarray(face["defs"][comp[0]["defid"]]["w"]).ravel()
        assert b.size == 1
        biases.append(float(b[0]))
    biases.append(0.0)  # dummy pairwise bias
    dummy = len(biases) - 1

    filters = [np.asarray(f, dtype=np.float32) for f in face["filters"]]
    defs: List[np.ndarray] = []
    anchors: List[np.ndarray] = []
    parentid, filterid, defid, biasid = [], [], [], []

    for ci, comp in enumerate(face["components"]):
        P = len(comp)
        par = np.zeros(P, dtype=np.int32)
        fid_c, did_c, bid_c = [], [], []
        for j, part in enumerate(comp):
            fid_c.append(np.array([part["filterid"]], dtype=np.int32))
            if j == 0:
                did_c.append(np.zeros(0, dtype=np.int32))
                bid_c.append(np.array([[ci]], dtype=np.int32))
            else:
                par[j] = max(int(part["parent"]), 0)
                d = face["defs"][part["defid"]]
                w = np.asarray(d["w"], dtype=np.float32).ravel()
                assert w.size == 4, "part defs must be quadratic (4,)"
                defs.append(w)
                a = np.asarray(d["anchor"], dtype=np.float64).ravel()
                ds = int(a[2]) if a.size > 2 else 0
                anchors.append(
                    np.array([int(a[0]), int(a[1]), ds], dtype=np.int32)
                )
                did_c.append(np.array([len(defs) - 1], dtype=np.int32))
                bid_c.append(np.array([[dummy]], dtype=np.int32))
        parentid.append(par)
        filterid.append(fid_c)
        defid.append(did_c)
        biasid.append(bid_c)

    model = Model(
        name=name,
        interval=10,
        sbin=int(face["sbin"]),
        thresh=float(face.get("thresh", -0.6)),
        filters=filters,
        defs=defs,
        anchors=anchors,
        biases=np.asarray(biases, dtype=np.float32),
        parentid=parentid,
        filterid=filterid,
        defid=defid,
        biasid=biasid,
        flen=filters[0].shape[2],
        maxsize=face.get("maxsize"),
    )
    model.validate()
    return model


def transfer(path: str, fmt: str, name: str = "transferred") -> Model:
    """Load a third-party .mat model and convert: fmt in {'VOC', 'Face'}."""
    import scipy.io as sio

    data = sio.loadmat(path, squeeze_me=True, struct_as_record=False)
    m = data["model"]
    if fmt.upper() == "VOC":
        return face_to_pose(voc_to_face(m), name)
    if fmt.capitalize() == "Face":
        # Zhu-Ramanan face models follow the Yang layout closely enough
        # that the MatlabIOModel reader handles them; fall through to it.
        from .matlabio import MatlabIOModel

        return MatlabIOModel.read(path)
    raise ValueError(f"unknown source format {fmt!r}; options: VOC, Face")
