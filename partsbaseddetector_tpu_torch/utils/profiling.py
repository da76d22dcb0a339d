"""Input validation for the public detect API (a copy of
`partsbaseddetector_tpu/utils/profiling.py::validate_image`) and the
CUDA-event timer of the T1 harness and chip_smoke.py. The other
profiling helpers of that module wait for the surfaces slice, where
they move to torch.profiler."""

from __future__ import annotations

from typing import Optional

import numpy as np


def validate_image(im: np.ndarray, min_side: Optional[int] = None) -> np.ndarray:
    """Public-API input validation (the reference demo exits on bad
    input, src/demo.cpp:90-99)."""
    im = np.asarray(im)
    if im.ndim == 2:
        im = np.repeat(im[:, :, None], 3, axis=2)
    if im.ndim != 3 or im.shape[2] not in (1, 3):
        raise ValueError(f"expected (H, W, 3) image, got shape {im.shape}")
    if im.shape[2] == 1:
        im = np.repeat(im, 3, axis=2)
    # integer/bool frames are always finite; floats are checked in
    # their own dtype; anything else (complex, object, ...) is rejected
    # outright, since silently dropping imaginary parts would be worse
    if np.issubdtype(im.dtype, np.floating):
        if not np.isfinite(im).all():
            raise ValueError("image contains NaN/Inf")
    elif not (
        np.issubdtype(im.dtype, np.integer) or im.dtype == np.bool_
    ):
        raise ValueError(f"unsupported image dtype: {im.dtype}")
    if min_side and min(im.shape[:2]) < min_side:
        raise ValueError(
            f"image side {min(im.shape[:2])} below minimum {min_side}"
        )
    return im


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean device time in ms of fn() over reps calls on the current CUDA
    stream, after one warm-up call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
