"""The torch port's model readers and writers (models/filestorage.py,
models/matlabio.py, models/transfer.py, load_model and the
model_transfer CLI) against the JAX package's, on the CPU.

Both packages run the same NumPy code, so everything is exact: the
port's XML writer gives the JAX writer's bytes, each package reads the
other's .xml, .yml and .mat files to equal arrays, and on a damaged file
both readers raise the same exception type (or both read the same
model)."""

import os
import zlib

import numpy as np
import pytest

from partsbaseddetector_tpu.models import FileStorageModel as JaxFS
from partsbaseddetector_tpu.models import MatlabIOModel as JaxMat
from partsbaseddetector_tpu.models import load_model as jax_load
from partsbaseddetector_tpu.models import save_model as jax_save
from partsbaseddetector_tpu.models import transfer as jax_transfer
from partsbaseddetector_tpu.models.model import (
    make_person_like_model,
    make_synthetic_model,
)
from partsbaseddetector_tpu_torch.apps.model_transfer import main as transfer_main
from partsbaseddetector_tpu_torch.models import FileStorageModel, MatlabIOModel
from partsbaseddetector_tpu_torch.models import load_model
from partsbaseddetector_tpu_torch.models import transfer
from partsbaseddetector_tpu_torch.models.convert import model_from_jax

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


def _shared_model():
    """A synthetic model whose parts 1 and 2 share their filters and
    whose part 3 shares part 2's deformations."""
    m = make_synthetic_model(nparts=4, nmix=2, fsize=(3, 4), seed=7)
    m.filterid[0][2] = m.filterid[0][1].copy()
    m.defid[0][3] = m.defid[0][2].copy()
    return m


MODELS = {
    "golden": lambda: jax_load(os.path.join(FIX, "golden_model.npz")),
    "person26": make_person_like_model,
    "shared": _shared_model,
}

FIELDS = ("filters", "defs", "anchors")
NESTED = ("filterid", "defid", "biasid")


def assert_models_equal(a, b):
    """Every field of two models (of either package) exactly equal."""
    for key in ("name", "interval", "sbin", "thresh", "norient", "flen",
                "maxsize", "ncomponents"):
        assert getattr(a, key) == getattr(b, key), key
    np.testing.assert_array_equal(a.biases, b.biases)
    assert a.biases.dtype == b.biases.dtype
    for key in FIELDS:
        xs, ys = getattr(a, key), getattr(b, key)
        assert len(xs) == len(ys), key
        for x, y in zip(xs, ys):
            assert x.dtype == y.dtype and x.shape == y.shape, key
            np.testing.assert_array_equal(x, y)
    for c in range(a.ncomponents):
        np.testing.assert_array_equal(a.parentid[c], b.parentid[c])
        for key in NESTED:
            for x, y in zip(getattr(a, key)[c], getattr(b, key)[c]):
                assert x.dtype == y.dtype and x.shape == y.shape, key
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_xml_writer_gives_the_jax_writers_bytes(tmp_path, name):
    jm = MODELS[name]()
    JaxFS.write(jm, str(tmp_path / "jax.xml"))
    FileStorageModel.write(model_from_jax(jm), str(tmp_path / "port.xml"))
    assert (tmp_path / "port.xml").read_bytes() == (tmp_path / "jax.xml").read_bytes()


def _write(pkg, fmt, model, path):
    if fmt == "xml":
        (JaxFS if pkg == "jax" else FileStorageModel).write(model, path)
    else:
        (JaxMat if pkg == "jax" else MatlabIOModel).write(model, path)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("fmt", ["xml", "mat"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_each_package_reads_the_others_files(tmp_path, name, fmt, writer):
    jm = MODELS[name]()
    path = str(tmp_path / f"m.{fmt}")
    _write(writer, fmt, jm if writer == "jax" else model_from_jax(jm), path)
    got, want = load_model(path), jax_load(path)
    assert_models_equal(got, want)
    assert_models_equal(got, load_model(path))  # a read is repeatable


def _xml_to_opencv_yaml(xml_path, yml_path):
    """Rewrite a one-component FileStorage XML model as YAML with
    OpenCV itself (the same conversion as tests/test_models.py)."""
    import cv2

    fs_in = cv2.FileStorage(xml_path, cv2.FILE_STORAGE_READ)
    fs_out = cv2.FileStorage(yml_path, cv2.FILE_STORAGE_WRITE)
    fs_out.write("name", fs_in.getNode("name").string())
    for key in ("interval", "sbin", "norient", "flen"):
        fs_out.write(key, int(fs_in.getNode(key).real()))
    fs_out.write("thresh", float(fs_in.getNode("thresh").real()))
    fs_out.startWriteStruct("filtersw", cv2.FILE_NODE_SEQ)
    for i in range(fs_in.getNode("filtersw").size()):
        fs_out.write("", fs_in.getNode("filtersw").at(i).mat())
    fs_out.endWriteStruct()
    for key in ("biasw", "anchors"):
        node = fs_in.getNode(key)
        fs_out.startWriteStruct(key, cv2.FILE_NODE_SEQ)
        for i in range(node.size()):
            v = node.at(i).real()
            fs_out.write("", float(v) if key == "biasw" else int(v))
        fs_out.endWriteStruct()
    fs_out.startWriteStruct("defs", cv2.FILE_NODE_SEQ)
    dnode = fs_in.getNode("defs")
    for i in range(dnode.size()):
        sub = dnode.at(i)
        fs_out.startWriteStruct("", cv2.FILE_NODE_SEQ)
        for j in range(sub.size()):
            fs_out.write("", float(sub.at(j).real()))
        fs_out.endWriteStruct()
    fs_out.endWriteStruct()
    fs_out.startWriteStruct("indexers", cv2.FILE_NODE_MAP)
    comp = fs_in.getNode("indexers").getNode("component-0")
    fs_out.startWriteStruct("component-0", cv2.FILE_NODE_MAP)
    for p in range(comp.size()):
        pn = comp.getNode(f"part-{p}")
        fs_out.startWriteStruct(f"part-{p}", cv2.FILE_NODE_MAP)
        fs_out.write("parentid", int(pn.getNode("parentid").real()))
        for key in ("filterid", "biasid", "defid"):
            node = pn.getNode(key)
            fs_out.startWriteStruct(key, cv2.FILE_NODE_SEQ)
            for i in range(node.size()):
                fs_out.write("", int(node.at(i).real()))
            fs_out.endWriteStruct()
        fs_out.endWriteStruct()
    fs_out.endWriteStruct()
    fs_out.endWriteStruct()
    fs_out.release()
    fs_in.release()


# person26's YAML takes PyYAML ~4 s a read; its XML and .mat cases stand
@pytest.mark.parametrize("name", ["golden", "shared"])
def test_opencv_written_yaml_reads_the_same(tmp_path, name):
    pytest.importorskip("cv2")
    jm = MODELS[name]()
    xml_path, yml_path = str(tmp_path / "m.xml"), str(tmp_path / "m.yml")
    FileStorageModel.write(model_from_jax(jm), xml_path)
    _xml_to_opencv_yaml(xml_path, yml_path)
    got = load_model(yml_path)
    assert_models_equal(got, jax_load(yml_path))
    # .yml and .xml hold the same model; YAML floats carry the XML's
    # 11 significant digits, so the weights agree to float32 rounding
    ref = load_model(xml_path)
    for x, y in zip(got.filters, ref.filters):
        np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-7)
    for c in range(ref.ncomponents):
        for x, y in zip(got.biasid[c], ref.biasid[c]):
            np.testing.assert_array_equal(x, y)


# --- damaged files: the same outcome from both readers ------------------


def _outcome(read, path):
    try:
        return "ok", read(path)
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return "raise", type(e)


def _assert_same_outcome(path, fmt):
    port = _outcome(FileStorageModel.read if fmt == "xml" else MatlabIOModel.read, path)
    jax = _outcome(JaxFS.read if fmt == "xml" else JaxMat.read, path)
    assert port[0] == jax[0], (port, jax)
    if port[0] == "raise":
        assert port[1] is jax[1], (port[1], jax[1])
    else:
        assert_models_equal(port[1], jax[1])


def _valid(tmp_path, fmt) -> str:
    model = make_synthetic_model(
        nparts=3, nmix=2, fsize=(3, 3), sbin=8, interval=2, thresh=0.0,
        seed=5 if fmt == "xml" else 6,
    )
    path = str(tmp_path / f"m.{fmt}")
    _write("jax", fmt, model, path)
    return path


def _mutated(tmp_path, data: bytes, fmt: str) -> str:
    bad = str(tmp_path / f"bad.{fmt}")
    with open(bad, "wb") as fh:
        fh.write(data)
    return bad


@pytest.mark.parametrize("fmt,frac", [("xml", 0.1), ("xml", 0.3), ("xml", 0.5),
                                      ("xml", 0.9), ("mat", 0.05), ("mat", 0.4),
                                      ("mat", 0.8)])
def test_truncated_file(tmp_path, fmt, frac):
    data = open(_valid(tmp_path, fmt), "rb").read()
    _assert_same_outcome(_mutated(tmp_path, data[: int(len(data) * frac)], fmt), fmt)


# tests/test_reader_fuzz.py's own flips: (seed, trials, flips per file).
# scipy's MAT5 parser reads memory it never wrote on some other flipped
# files (its exception then changes from call to call, or it crashes), in
# the JAX reader and the port's alike, so no outcome can be compared there.
FLIPS = {"xml": (0, 8, 8), "mat": (1, 6, 12)}


@pytest.mark.parametrize(
    "fmt,trial", [(fmt, t) for fmt, (_, n, _) in FLIPS.items() for t in range(n)]
)
def test_random_byte_flips(tmp_path, fmt, trial):
    seed, _, flips = FLIPS[fmt]
    rng = np.random.RandomState(seed)
    data = bytearray(open(_valid(tmp_path, fmt), "rb").read())
    lo = 0 if fmt == "xml" else 64
    for _ in range(trial + 1):
        bad = bytearray(data)
        for _ in range(flips):
            bad[rng.randint(lo, len(bad))] = rng.randint(256)
    _assert_same_outcome(_mutated(tmp_path, bytes(bad), fmt), fmt)


@pytest.mark.parametrize("field", ["biasw", "defs", "anchors", "filtersw", "thresh"])
def test_xml_field_deleted(tmp_path, field):
    text = open(_valid(tmp_path, "xml")).read()
    start, end = text.find(f"<{field}>"), text.find(f"</{field}>")
    mutated = text[:start] + text[end + len(field) + 3 :]
    _assert_same_outcome(_mutated(tmp_path, mutated.encode(), "xml"), "xml")


@pytest.mark.parametrize("case", ["empty", "junk", "wrong_root", "non_numeric"])
def test_xml_wrong_content(tmp_path, case):
    if case == "empty":
        data = b""
    elif case == "junk":
        data = zlib.compress(b"not xml at all" * 100)
    elif case == "wrong_root":
        data = (b"<?xml version='1.0'?><opencv_storage><foo>1</foo>"
                b"</opencv_storage>")
    else:
        text = open(_valid(tmp_path, "xml")).read()
        data = text.replace("<interval>", "<interval>oops ", 1).encode()
    _assert_same_outcome(_mutated(tmp_path, data, "xml"), "xml")


def test_mat_wrong_magic_and_missing_variable(tmp_path):
    import scipy.io as sio

    data = bytearray(open(_valid(tmp_path, "mat"), "rb").read())
    data[:8] = b"NOTAMAT!"
    _assert_same_outcome(_mutated(tmp_path, bytes(data), "mat"), "mat")
    bad = str(tmp_path / "nomodel.mat")
    sio.savemat(bad, {"something_else": np.zeros(3)})
    _assert_same_outcome(bad, "mat")
    with pytest.raises(KeyError):
        MatlabIOModel.read(bad)


def test_malformed_mat_is_a_value_error(tmp_path):
    """scipy's assorted parser errors on corrupt bytes become one
    ValueError, as in the JAX reader."""
    data = open(_valid(tmp_path, "mat"), "rb").read()
    bad = _mutated(tmp_path, data[:200], "mat")
    with pytest.raises(ValueError, match="malformed .mat"):
        MatlabIOModel.read(bad)
    with pytest.raises(ValueError):
        JaxMat.read(bad)


# --- transfer -------------------------------------------------------------


def _face_tree():
    rng = np.random.RandomState(1)
    return dict(
        sbin=8,
        maxsize=(4, 4),
        thresh=-0.5,
        filters=[rng.randn(4, 4, 32).astype(np.float32) * 0.1 for _ in range(4)],
        defs=[
            dict(w=np.array([0.3]), anchor=np.zeros(3)),
            dict(w=np.array([0.01, 0, 0.02, 0]), anchor=np.array([2, 1, 0])),
            dict(w=np.array([0.4]), anchor=np.zeros(3)),
            dict(w=np.array([0.03, 0, 0.01, 0]), anchor=np.array([1, 3, 0])),
        ],
        components=[
            [dict(filterid=0, defid=0, parent=-1), dict(filterid=1, defid=1, parent=0)],
            [dict(filterid=2, defid=2, parent=-1), dict(filterid=3, defid=3, parent=0)],
        ],
    )


def _voc_mat(path):
    """A two-component (one mirrored) VOC grammar model as
    voc-release's .mat holds it: a start rule per component whose rhs
    names a root terminal and two deformation rules over part
    terminals."""
    import scipy.io as sio

    rng = np.random.RandomState(3)
    filters = np.empty(6, dtype=object)
    for i in range(6):
        filters[i] = {"w": rng.randn(3 + i % 2, 4, 32) * 0.1}
    # symbols 1..6: terminals of filters 1..6; 7..10: nonterminals
    symbols = np.empty(10, dtype=object)
    for i in range(6):
        symbols[i] = {"type": "T", "filter": float(i + 1)}
    for i in range(6, 10):
        symbols[i] = {"type": "N", "filter": 0.0}

    def start_rule(root_sym, part_syms, off):
        anchor = np.empty(3, dtype=object)  # a cell of three vectors
        for i, a in enumerate(([0.0, 0.0, 0.0], [1.0, 2.0, 1.0], [3.0, 0.0, 1.0])):
            anchor[i] = np.array(a)
        return {"offset": {"w": off}, "rhs": np.array([root_sym, *part_syms], float),
                "anchor": anchor}

    def def_rule(sym):
        return {"rhs": float(sym), "def": {"w": rng.rand(4) * 0.1}}

    comps = np.empty(2, dtype=object)
    comps[0] = start_rule(1.0, [7.0, 8.0], 0.25)
    comps[1] = start_rule(4.0, [9.0, 10.0], -0.5)  # the mirror: skipped
    rules = np.empty(11, dtype=object)
    for i in range(11):
        rules[i] = np.empty(0, dtype=object)
    rules[10] = comps
    for nt, sym in ((6, 2), (7, 3), (8, 5), (9, 6)):
        r = np.empty(1, dtype=object)
        r[0] = def_rule(float(sym))
        rules[nt] = r
    sio.savemat(path, {"model": {
        "rules": rules, "symbols": symbols, "filters": filters,
        "start": 11.0, "sbin": 8.0, "interval": 10.0, "maxsize": [5.0, 4.0],
    }}, long_field_names=True)


def test_face_to_pose_and_transfer_give_equal_models(tmp_path):
    assert_models_equal(transfer.face_to_pose(_face_tree()),
                        jax_transfer.face_to_pose(_face_tree()))
    path = str(tmp_path / "voc.mat")
    _voc_mat(path)
    got, want = transfer.transfer(path, "VOC"), jax_transfer.transfer(path, "VOC")
    assert got.ncomponents == 1 and got.nparts(0) == 3
    assert_models_equal(got, want)
    face = str(tmp_path / "face.mat")
    JaxMat.write(make_synthetic_model(nparts=3, nmix=2, seed=9), face)
    assert_models_equal(transfer.transfer(face, "Face"), jax_transfer.transfer(face, "Face"))
    with pytest.raises(ValueError, match="unknown source format"):
        transfer.transfer(face, "DPM")


# --- load_model and the model_transfer CLI --------------------------------


@pytest.mark.parametrize("ext", ["npz", "xml", "mat", "yaml"])
def test_load_model_dispatches_by_extension(tmp_path, ext):
    jm = make_synthetic_model(nparts=3, nmix=2, seed=11)
    path = str(tmp_path / f"m.{ext}")
    if ext == "npz":
        jax_save(jm, path)
    elif ext == "yaml":
        pytest.importorskip("cv2")
        JaxFS.write(jm, str(tmp_path / "m.xml"))
        _xml_to_opencv_yaml(str(tmp_path / "m.xml"), path)
    else:
        _write("jax", ext, jm, path)
    got = load_model(path)
    assert type(got).__module__ == "partsbaseddetector_tpu_torch.models.model"
    assert_models_equal(got, jax_load(path))


def test_model_transfer_cli_round_trips(tmp_path, capsys):
    jm = make_synthetic_model(nparts=3, nmix=2, seed=12)
    src = str(tmp_path / "m.npz")
    jax_save(jm, src)
    xml, npz, mat = (str(tmp_path / n) for n in ("m.xml", "m2.npz", "m.mat"))
    assert transfer_main([src, xml]) == 0
    assert transfer_main([xml, npz]) == 0
    assert transfer_main([npz, mat]) == 0
    assert "converted" in capsys.readouterr().out
    for path in (xml, npz, mat):
        assert_models_equal(load_model(path), jax_load(path))
    # the XML's weights are printed with 11 significant digits
    back = load_model(npz)
    for x, y in zip(back.filters, jm.filters):
        np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-7)
    with pytest.raises(SystemExit):
        transfer_main([src, str(tmp_path / "m.bin")])
