"""T1's port (`ops/conv_proto_cuda.py`) and its harness against the JAX
package's T1, `tools/conv_pallas_proto.py`, on the CPU.

The tool runs in interpret mode in a subprocess (its knobs are
environment variables read at import), once per shape set; its seeded
features, filters, `w2` and Pallas output are saved and compared with
the port's plain version on the same inputs, within 1e-5 * sum|x*w| per
output (the kernel and the matrix product sum in other orders). The
shape sets cover TOH 1, 2 and 4 (a TOH past OH), output widths that do
not divide the kernel's column tile (128 / toh) and filter counts that
are not multiples of its 64-filter tile. The kernel itself runs only on
the card (`tests/test_torch_cuda.py`).
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from partsbaseddetector_tpu_torch.ops import conv, conv_proto_cuda as cp
from partsbaseddetector_tpu_torch.utils.profiling import launch_counts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5

# (PS, PH, PW, PF, TOH): OW 10, 36, 17; F 70, 104, 7; OH 8, 7, 3
SHAPE_SETS = [(2, 12, 14, 70, 1), (1, 11, 40, 104, 2), (2, 7, 21, 7, 4)]

RUN_TOOL = textwrap.dedent(
    """
    import os, runpy, sys
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    out, sets = sys.argv[1], sys.argv[2:]
    for n, spec in enumerate(sets):
        ps, ph, pw, pf, toh = spec.split(",")
        os.environ.update(PS=ps, PH=ph, PW=pw, PF=pf, TOH=toh, INTERP="1")
        g = runpy.run_path(os.path.join("tools", "conv_pallas_proto.py"))
        np.savez(os.path.join(out, f"t1_{n}.npz"), feat=g["feat"],
                 filt=g["filt"], got=g["got"], w2=np.asarray(g["w2"]))
    """
)


@pytest.fixture(scope="module")
def tool_outputs(tmp_path_factory):
    out = tmp_path_factory.mktemp("t1")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT,
               JAX_COMPILATION_CACHE_DIR=str(out / "jax_cache"))
    proc = subprocess.run(
        [sys.executable, "-c", RUN_TOOL, str(out),
         *(",".join(map(str, s)) for s in SHAPE_SETS)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    return [dict(np.load(out / f"t1_{n}.npz")) for n in range(len(SHAPE_SETS))]


def _port_inputs(rec):
    feat = torch.as_tensor(rec["feat"])
    feat_t = feat.permute(0, 1, 3, 2).contiguous()
    return feat, feat_t, cp.weights_k_major(rec["filt"])


@pytest.mark.parametrize("n", range(len(SHAPE_SETS)))
def test_plain_matches_the_tool(tool_outputs, n):
    rec = tool_outputs[n]
    f = rec["filt"].shape[0]
    _, feat_t, w2 = _port_inputs(rec)
    got = cp.conv_proto_plain(feat_t, w2, f)
    want = torch.as_tensor(rec["got"])
    scale = cp.conv_proto_plain(feat_t.abs(), w2.abs(), f)
    assert got.shape == want.shape
    assert bool(((got - want).abs() <= RTOL * scale).all())


@pytest.mark.parametrize("n", range(len(SHAPE_SETS)))
def test_weights_k_major_is_the_tools_w2(tool_outputs, n):
    """The same filters give the tool's w2 exactly: the tool pads F to a
    multiple of 128, the port to its 64-filter tile, and the columns
    between are zero."""
    rec = tool_outputs[n]
    w2 = cp.weights_k_major(rec["filt"]).numpy()
    f = rec["filt"].shape[0]
    assert w2.shape[1] == -(-f // 64) * 64
    np.testing.assert_array_equal(w2, rec["w2"][:, : w2.shape[1]])
    assert not rec["w2"][:, w2.shape[1]:].any()


@pytest.mark.parametrize("n", range(len(SHAPE_SETS)))
def test_plain_matches_the_k2_correlation(tool_outputs, n):
    """T1's function is K2's (ops/conv.py::filter_responses) on the NHWC
    features."""
    rec = tool_outputs[n]
    feat, feat_t, w2 = _port_inputs(rec)
    filt = torch.as_tensor(rec["filt"])
    got = cp.conv_proto_plain(feat_t, w2, filt.shape[0])
    want = conv.filter_responses(feat, filt)
    scale = cp.conv_proto_plain(feat_t.abs(), w2.abs(), filt.shape[0])
    assert bool(((got - want).abs() <= RTOL * scale).all())


@pytest.mark.parametrize("toh", [1, 3, 8])
def test_conv_proto_on_cpu_runs_the_plain_version(toh):
    gen = torch.Generator().manual_seed(toh)
    feat_t = torch.randn((2, 9, 32, 13), generator=gen)
    w2 = cp.weights_k_major(torch.randn((5, 5, 5, 32), generator=gen))
    before = launch_counts()
    got = cp.conv_proto(feat_t, w2, 5, toh)
    assert launch_counts() == before
    assert got.shape == (2, 5, 9, 5)
    assert torch.equal(got, cp.conv_proto_plain(feat_t, w2, 5))


@pytest.mark.parametrize(
    "shape,w2_shape,f,toh",
    [((1, 9, 32, 13), (800, 64), 5, 0),  # toh < 1
     ((1, 9, 32, 13), (800, 70), 5, 1),  # columns not a tile multiple
     ((1, 9, 32, 13), (640, 64), 5, 1),  # K != fh*fw*C
     ((1, 9, 32, 13), (800, 64), 65, 1),  # more filters than columns
     ((1, 4, 32, 13), (800, 64), 5, 1)],  # features smaller than a filter
)
def test_conv_proto_rejects_bad_arguments(shape, w2_shape, f, toh):
    with pytest.raises(ValueError):
        cp.conv_proto(torch.zeros(shape), torch.zeros(w2_shape), f, toh)


def test_harness_runs_on_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "partsbaseddetector_tpu_torch.tools.conv_proto",
         "--s", "2", "--f", "70", "--h", "12", "--w", "40", "--toh", "3",
         "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["device"] == "cpu" and "ms" not in res
    assert res["max_abs_err"] == 0.0  # conv_proto runs conv_proto_plain here
    assert res["max_abs_err_vs_k2_plain"] < 2e-3


def test_harness_defaults_to_the_card(monkeypatch):
    from partsbaseddetector_tpu_torch.tools import conv_proto as harness

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        harness.main(["--s", "1", "--h", "9", "--w", "9", "--f", "3"])
