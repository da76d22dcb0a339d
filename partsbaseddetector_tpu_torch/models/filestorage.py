"""OpenCV FileStorage XML/YAML model (de)serialization, pure Python.

Implements the exact on-disk schema of the reference's
src/FileStorageModel.cpp:42-159: primitives (name/interval/thresh/sbin/
norient/flen), matrix list `filtersw` (each a (fh, fw*flen)
channel-interleaved cv::Mat), flat `biasw`, `anchors` (flattened x,y
pairs), nested `defs` sequence, and the `indexers/component-N/part-M/
{parentid, filterid, biasid, defid}` tree.

Conversion to the canonical `Model`:
  - filters are de-interleaved (fh, fw*flen) -> (fh, fw, flen),
  - C++ per-part `biasid` start-offset vectors become dense
    (L_parent, K_child) index tables: table[l, k] = biasid[k] + l
    (the layout include/Parts.hpp:172-175 reads from),
  - anchors gain a ds=0 third element (the C++ format drops per-part
    scale offsets).

The writer re-lays the bias pool so offsets stay contiguous, keeping
files readable by the C++ implementation (and cv2.FileStorage, which
tests cross-validate against).

A copy of `partsbaseddetector_tpu/models/filestorage.py`, so that the
port never imports the JAX package. XML goes through `xml.etree`; YAML
imports PyYAML only when a .yml/.yaml file is read.
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET
from typing import List

import numpy as np

from .model import Model


# ---------------------------------------------------------------------------
# Generic FileStorage tree <-> python
# ---------------------------------------------------------------------------


def _parse_numbers(text: str) -> List[float]:
    return [float(t) for t in text.replace("\n", " ").split()] if text else []


class _Node:
    """Parsed FileStorage node: mapping, sequence, matrix, scalar or str."""

    def __init__(self, kind, value):
        self.kind = kind  # 'map' | 'seq' | 'mat' | 'scalar' | 'str'
        self.value = value

    def __getitem__(self, key):
        return self.value[key]

    def get(self, key, default=None):
        return self.value.get(key, default) if self.kind == "map" else default


def _xml_to_node(elem: ET.Element) -> _Node:
    children = list(elem)
    if elem.get("type_id") == "opencv-matrix":
        fields = {c.tag: c for c in children}
        rows = int(fields["rows"].text)
        cols = int(fields["cols"].text)
        dt = fields["dt"].text.strip()
        data = np.array(_parse_numbers(fields["data"].text), dtype=np.float64)
        if dt in ("u", "s", "i"):
            data = data.astype(np.int64)
        return _Node("mat", data.reshape(rows, cols))
    if not children:
        text = (elem.text or "").strip()
        if text.startswith('"'):
            return _Node("str", text.strip('"'))
        nums = _parse_numbers(text)
        if len(nums) == 1:
            return _Node("scalar", nums[0])
        if len(nums) > 1:
            return _Node("seq", [_Node("scalar", v) for v in nums])
        return _Node("str", text)
    tags = [c.tag for c in children]
    if all(t == "_" for t in tags):
        return _Node("seq", [_xml_to_node(c) for c in children])
    return _Node("map", {c.tag: _xml_to_node(c) for c in children})


def _node_numbers(node: _Node) -> np.ndarray:
    """Flatten a seq-of-scalars (or single scalar) node to an array."""
    if node.kind == "scalar":
        return np.array([node.value])
    if node.kind == "seq":
        return np.array([n.value for n in node.value])
    if node.kind == "mat":
        return np.asarray(node.value).ravel()
    if node.kind == "str" and not node.value.strip():
        # an empty element (e.g. <defid></defid> for a root part with
        # no deformation) is an empty numeric list
        return np.array([])
    raise ValueError(f"expected numeric node, got {node.kind}")


def _parse_xml(path: str) -> _Node:
    try:
        root = ET.parse(path).getroot()  # <opencv_storage>
    except ET.ParseError as e:
        raise ValueError(f"malformed FileStorage XML {path!r}: {e}") from e
    return _Node("map", {c.tag: _xml_to_node(c) for c in root})


# --- YAML flavor (OpenCV YAML 1.0) ---


def _parse_yaml(path: str) -> _Node:
    import yaml

    with open(path) as fh:
        text = fh.read()
    text = re.sub(r"^%YAML:[\d.]+\n", "", text)
    text = re.sub(r"^---.*\n", "", text)
    text = text.replace("!!opencv-matrix", "")

    doc = yaml.safe_load(text)

    def convert(obj) -> _Node:
        if isinstance(obj, dict):
            if {"rows", "cols", "dt", "data"} <= set(obj):
                arr = np.array(obj["data"], dtype=np.float64)
                if obj["dt"] in ("u", "s", "i"):
                    arr = arr.astype(np.int64)
                return _Node("mat", arr.reshape(obj["rows"], obj["cols"]))
            return _Node("map", {k: convert(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return _Node("seq", [convert(v) for v in obj])
        if isinstance(obj, str):
            return _Node("str", obj)
        if obj is None:  # empty node (e.g. a no-deformation defid)
            return _Node("str", "")
        return _Node("scalar", float(obj))

    return convert(doc)


# ---------------------------------------------------------------------------
# Model <-> FileStorage schema
# ---------------------------------------------------------------------------


class FileStorageModel:
    """Reader/writer for the reference's XML/YAML model files."""

    @staticmethod
    def read(path: str) -> Model:
        node = (
            _parse_xml(path)
            if path.lower().endswith(".xml")
            else _parse_yaml(path)
        )
        name_node = node["name"]
        name = (
            name_node.value
            if name_node.kind == "str"
            else str(name_node.value)
        )
        interval = int(node["interval"].value)
        thresh = float(node["thresh"].value)
        sbin = int(node["sbin"].value)
        norient = int(node["norient"].value)
        flen = int(node["flen"].value)

        filters = []
        for m in node["filtersw"].value:
            mat = np.asarray(m.value, dtype=np.float32)
            fh, wide = mat.shape
            fw = wide // flen
            filters.append(mat.reshape(fh, fw, flen))

        biasw = _node_numbers(node["biasw"]).astype(np.float32)
        anch_flat = _node_numbers(node["anchors"]).astype(np.int64)
        anchors = [
            np.array([anch_flat[2 * i], anch_flat[2 * i + 1], 0], dtype=np.int32)
            for i in range(len(anch_flat) // 2)
        ]
        defs = [
            _node_numbers(d).astype(np.float32) for d in node["defs"].value
        ]

        comps = node["indexers"]
        ncomp = len(comps.value)
        parentid, filterid, defid, biasid_dense = [], [], [], []
        for c in range(ncomp):
            cnode = comps[f"component-{c}"]
            nparts = len(cnode.value)
            par = np.zeros(nparts, dtype=np.int32)
            fid_c, did_c, offs_c = [], [], []
            for p in range(nparts):
                pnode = cnode[f"part-{p}"]
                par[p] = int(pnode["parentid"].value)
                fid_c.append(_node_numbers(pnode["filterid"]).astype(np.int32))
                bnode = pnode.get("biasid")
                offs_c.append(
                    _node_numbers(bnode).astype(np.int64)
                    if bnode is not None
                    else np.zeros(1, dtype=np.int64)
                )
                dnode = pnode.get("defid")
                # the C++ reader tolerates scalar defid
                # (src/FileStorageModel.cpp:148-152)
                did_c.append(
                    _node_numbers(dnode).astype(np.int32)
                    if dnode is not None
                    else np.zeros(1, dtype=np.int32)
                )
            # densify bias offset vectors -> (L_parent, K) index tables
            bid_c = []
            for p in range(nparts):
                k = len(fid_c[p])
                lpar = 1 if p == 0 else len(fid_c[par[p]])
                offs = offs_c[p]
                if len(offs) < k:
                    offs = np.tile(offs, k)[:k]
                tbl = offs[None, :k] + np.arange(lpar)[:, None]
                bid_c.append(tbl.astype(np.int32))
            parentid.append(par)
            filterid.append(fid_c)
            defid.append(did_c)
            biasid_dense.append(bid_c)

        return Model(
            name=name,
            interval=interval,
            sbin=sbin,
            thresh=thresh,
            filters=filters,
            defs=defs,
            anchors=anchors,
            biases=biasw,
            parentid=parentid,
            filterid=filterid,
            defid=defid,
            biasid=biasid_dense,
            norient=norient,
            flen=flen,
        )

    @staticmethod
    def write(model: Model, path: str) -> None:
        """Write XML in the C++ schema. The bias pool is re-laid out so
        every (part, child-mixture) column is a contiguous run, which is
        the only layout the C++ accessors can address."""
        model.validate()
        biasw: List[float] = []
        offsets = []  # [c][p] -> (K,) start offsets
        for c in range(model.ncomponents):
            offs_c = []
            for p in range(model.nparts(c)):
                tbl = model.biasid[c][p]  # (L, K) indices
                offs = np.zeros(tbl.shape[1], dtype=np.int64)
                for k in range(tbl.shape[1]):
                    offs[k] = len(biasw)
                    biasw.extend(float(model.biases[i]) for i in tbl[:, k])
                offs_c.append(offs)
            offsets.append(offs_c)

        def fmt(v: float) -> str:
            if v == int(v) and abs(v) < 1e16:
                return f"{int(v)}."
            return np.format_float_scientific(v, precision=10)

        lines = ['<?xml version="1.0"?>', "<opencv_storage>"]
        lines.append(f'<name>"{model.name}"</name>')
        lines.append(f"<interval>{model.interval}</interval>")
        lines.append(f"<thresh>{fmt(model.thresh)}</thresh>")
        lines.append(f"<sbin>{model.sbin}</sbin>")
        lines.append(f"<norient>{model.norient}</norient>")
        lines.append(f"<flen>{model.flen}</flen>")

        lines.append("<filtersw>")
        for f in model.filters:
            fh, fw, fl = f.shape
            flat = " ".join(fmt(v) for v in f.reshape(fh, fw * fl).ravel())
            lines.append(
                f'  <_ type_id="opencv-matrix"><rows>{fh}</rows>'
                f"<cols>{fw * fl}</cols><dt>f</dt><data>\n    {flat}</data></_>"
            )
        lines.append("</filtersw>")

        lines.append(
            "<biasw>\n  " + " ".join(fmt(v) for v in biasw) + "</biasw>"
        )
        anch = " ".join(f"{int(a[0])} {int(a[1])}" for a in model.anchors)
        lines.append(f"<anchors>\n  {anch}</anchors>")

        lines.append("<defs>")
        for d in model.defs:
            lines.append("  <_>" + " ".join(fmt(v) for v in d) + "</_>")
        lines.append("</defs>")

        lines.append("<indexers>")
        for c in range(model.ncomponents):
            lines.append(f"<component-{c}>")
            for p in range(model.nparts(c)):
                fid = " ".join(str(int(i)) for i in model.filterid[c][p])
                did = " ".join(str(int(i)) for i in model.defid[c][p])
                bid = " ".join(str(int(i)) for i in offsets[c][p])
                lines.append(
                    f"<part-{p}><parentid>{int(model.parentid[c][p])}"
                    f"</parentid><filterid>{fid}</filterid>"
                    f"<biasid>{bid}</biasid><defid>{did}</defid></part-{p}>"
                )
            lines.append(f"</component-{c}>")
        lines.append("</indexers>")
        lines.append("</opencv_storage>")
        with open(path, "w") as fh:
            fh.write("\n".join(lines) + "\n")
