"""The K2 tuning harness around T1's port (`ops/conv_proto_cuda.py`).

Counterpart of `tools/conv_pallas_proto.py`, with its knobs as
arguments and its defaults (person26's finest bucket):

    python -m partsbaseddetector_tpu_torch.tools.conv_proto \\
        --s 5 --f 104 --h 126 --w 166 --toh 2 [--device cpu]

It draws the tool's seeded inputs in the tool's order (RandomState(0):
randn features (S, H, W, 32), then randn filters (F, 5, 5, 32)), runs
`conv_proto` on the features transposed to (S, H, C, W) and checks it
against `conv_proto_plain` (max |err| < 2e-3, the tool's check, and
|err| <= 1e-5 * sum|x*w| per output) and against the plain K2
correlation `ops/conv.py::filter_responses`; `launches` counts the
kernel launches of that checked call. On the card it then times
T1 with CUDA events (the mean of 20 calls; `device_ms` beside it, the
profiler's device time) and prints ms and TFLOP/s
beside K2
(`ops/conv_cuda.py`) and `torch.nn.functional.conv2d` (cuDNN, TF32 off)
on the same inputs, and whether T1 equals K2 bit for bit. It runs on the
card unless --device cpu is given; on the CPU it runs the plain version
and prints no time. The last line is one JSON object with the results.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..ops import conv_proto_cuda
from ..ops.conv import filter_responses
from ..ops.conv_proto_cuda import (
    C,
    FH,
    FW,
    conv_proto,
    conv_proto_plain,
    weights_k_major,
)
from ..utils.device import resolve_device
from ..utils.profiling import cuda_ms, device_ms

RTOL = 1e-5  # per output, of sum|x*w|
ATOL = 2e-3  # the tool's check against lax.conv
REPS = 20  # timed calls per number


def seeded_inputs(s: int, h: int, w: int, f: int):
    """The tool's inputs, drawn in its order (conv_pallas_proto.py:38-40)."""
    rng = np.random.RandomState(0)
    feat = rng.randn(s, h, w, C).astype(np.float32)
    filt = rng.randn(f, FH, FW, C).astype(np.float32)
    return feat, filt


def run(s: int, f: int, h: int, w: int, toh: int, device) -> dict:
    """Check T1 on the seeded inputs and, on the card, time it beside K2
    and conv2d. Raises AssertionError if a check fails."""
    dev = resolve_device(device)
    feat_np, filt_np = seeded_inputs(s, h, w, f)
    feat = torch.as_tensor(feat_np, device=dev)
    filt = torch.as_tensor(filt_np, device=dev)
    feat_t = feat.permute(0, 1, 3, 2).contiguous()  # (S, H, C, W)
    w2 = weights_k_major(filt)
    before = conv_proto_cuda.launches
    got = conv_proto(feat_t, w2, f, toh)
    launches = conv_proto_cuda.launches - before
    want = conv_proto_plain(feat_t, w2, f)
    scale = conv_proto_plain(feat_t.abs(), w2.abs(), f)
    k2_plain = filter_responses(feat, filt)
    oh, ow = h - FH + 1, w - FW + 1
    if tuple(got.shape) != (s, oh, ow, f):
        raise AssertionError(f"conv_proto: shape {tuple(got.shape)}")
    err = (got - want).abs()
    ref_err = (got - k2_plain).abs()
    max_err = err.max().item()
    if not max_err < ATOL or not bool((err <= RTOL * scale).all()):
        raise AssertionError(f"conv_proto: max |err| {max_err:.3e} against plain")
    if not bool((ref_err <= RTOL * scale).all()):
        raise AssertionError("conv_proto: disagrees with the plain K2 correlation")
    flops = 2.0 * s * oh * ow * FH * FW * C * f
    res = {"s": s, "f": f, "h": h, "w": w, "toh": toh, "device": str(dev),
           "max_abs_err": max_err, "max_abs_err_vs_k2_plain": ref_err.max().item(),
           "gflop": flops / 1e9, "launches": launches}
    if dev.type == "cuda":
        from ..ops.conv_cuda import filter_responses_grouped, split_bank

        torch.backends.cudnn.allow_tf32 = False
        bank = split_bank(filt)  # K2's bank is split once per model
        run_k2 = lambda: filter_responses_grouped([feat], filt, bank)[0]
        k2 = run_k2()
        res["equal_to_k2"] = bool(torch.equal(got, k2))
        x_nchw = feat.permute(0, 3, 1, 2).contiguous()
        w_nchw = filt.permute(0, 3, 1, 2).contiguous()
        conv2d = torch.nn.functional.conv2d
        res["ms"] = cuda_ms(lambda: conv_proto(feat_t, w2, f, toh), REPS)
        res["device_ms"] = device_ms(lambda: conv_proto(feat_t, w2, f, toh), REPS)
        res["k2_ms"] = cuda_ms(run_k2, REPS)
        res["conv2d_ms"] = cuda_ms(lambda: conv2d(x_nchw, w_nchw), REPS)
        for key in ("ms", "k2_ms", "conv2d_ms"):
            res[key.replace("ms", "tflops")] = flops / res[key] / 1e9
        res["card"] = torch.cuda.get_device_name(dev)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--s", type=int, default=5, help="scales (PS)")
    ap.add_argument("--f", type=int, default=104, help="filters (PF)")
    ap.add_argument("--h", type=int, default=126, help="feature rows (PH)")
    ap.add_argument("--w", type=int, default=166, help="feature columns (PW)")
    ap.add_argument("--toh", type=int, default=2, help="output rows per block (TOH)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = run(args.s, args.f, args.h, args.w, args.toh, args.device)
    shape = f"({args.s},{args.h},{args.w},{C})x({args.f},{FH},{FW},{C})"
    print(f"conv_proto {shape} toh={args.toh} on {res['device']}: "
          f"max err vs plain {res['max_abs_err']:.3e}")
    if "ms" in res:
        print(f"T1 conv_proto toh={args.toh}: {res['ms']:.4f} ms "
              f"{res['tflops']:.2f} TFLOP/s; K2 {res['k2_ms']:.4f} ms "
              f"{res['k2_tflops']:.2f}; conv2d {res['conv2d_ms']:.4f} ms "
              f"{res['conv2d_tflops']:.2f}; equal to K2: {res['equal_to_k2']}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
