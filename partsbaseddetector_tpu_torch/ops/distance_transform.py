"""2-D generalized quadratic distance transform with packed pointers.

Port of `partsbaseddetector_tpu/ops/distance_transform.py::
shift_distance_transform_2d_packed`, and of its two public forms with
unpacked pointers, `shift_distance_transform_2d` and the same-size
anchored `distance_transform_2d`. Both separable passes run the 1-D
kernel along axis -2 (ops/dt_cuda.py::dt1d): the y pass in place, then
the x pass on the transposed intermediate with the y pointers carried
as `aux`, which fuses the MATLAB/shiftdt composition Iy = tmpIy[Ix]
(shiftdt.cc:95-108) into the kernel. The transposes around the x pass
run the T2 port as two pairs, one kernel launch each
(ops/transpose_cuda.py::transpose_last2_pair): the y pass's values and
pointers into the x pass, the x pass's values and pointers out of it.

Conventions (as in the JAX package):
  - deformation weights are the model's positive costs
    [wx2, wx1, wy2, wy1]; they are negated here (DynamicProgram.cpp:
    126-127, shiftdt.cc:70-73);
  - the output grid is q = shift + i*step (0-based);
  - ties go to the smallest source index.
The JAX package's kernel-dispatch heuristics and its scale/row packing
are TPU-lane artefacts and are not carried over. Its one opt-in kernel
choice is: with PBD_DT_WINDOW=1 both passes of an inference DT at step 1
run the adaptive-window kernel K5 (ops/dt_cuda.py::dt1d_window) instead
of K1, as `pallas_dt.py::dt1d_pallas` selects `_dt1d_pallas_window`.
"""

from __future__ import annotations

import os
from functools import partial

import torch

from .dt_cuda import dt1d, dt1d_window
from .transpose_cuda import transpose_last2_pair


def use_window() -> bool:
    """The adaptive-window DT (K5) is opt-in, as in the JAX package:
    PBD_DT_WINDOW=1 (`partsbaseddetector_tpu/ops/pallas_dt.py::
    _use_window`)."""
    return os.environ.get("PBD_DT_WINDOW", "0") == "1"


def shift_distance_transform_2d_packed(
    score: torch.Tensor,
    wdef: torch.Tensor,
    shift_x,
    shift_y,
    dlen_x: int,
    dlen_y: int,
    step: int = 1,
    valid_h=None,
    valid_w=None,
    differentiable: bool = False,
    out_valid_h=None,
    out_valid_w=None,
):
    """2-D shifted/subsampled generalized DT.

    score: (..., H, W) child score maps, -inf where invalid.
    wdef: (..., 4) positive deformation costs, broadcast over the batch.
    shift_x / shift_y: broadcastable to score.shape[:-2].
    valid_h: per-map live row count of score (rows beyond are -inf);
    valid_w: per-map live column count. Both default to the full map.
    differentiable=True runs both passes with K4's backward (score and
    wdef get gradients; a pair transpose's backward is the transpose of
    the values' cotangent, and the pointers take none).
    out_valid_h (..., W) / out_valid_w (..., dlen_y): optional consumer
    extents, per output column of the y pass and per output row of the
    x pass. Outputs beyond them are don't-care: the caller masks them to
    -inf downstream. Passing them also says that shift_x and shift_y
    are integral. With both given, step 1, no gradient and
    PBD_DT_WINDOW=1, both passes run K5, which returns (-inf, 0) there
    and stops each scan early; otherwise they are ignored.
    A bf16 score (the hybrid profile) is widened to f32 here, before the
    kernels, as the JAX package's Pallas wrapper does outside its kernel
    (`pallas_dt.py::_dt1d_sublane_call`); the kernels and their plain
    versions stay f32, so the card and the CPU compute alike.
    Returns (msg (..., dlen_y, dlen_x) f32, ptr (Iy << 12) | Ix int32).
    """
    score = score.to(torch.float32)
    ax, bx = -wdef[..., 0], -wdef[..., 1]
    ay, by = -wdef[..., 2], -wdef[..., 3]
    if (
        out_valid_h is not None
        and out_valid_w is not None
        and step == 1
        and not differentiable
        and use_window()
    ):
        pass_y = partial(dt1d_window, out_valid=out_valid_h)
        pass_x = partial(dt1d_window, out_valid=out_valid_w)
    else:
        pass_y = pass_x = partial(dt1d, step=step, differentiable=differentiable)
    tmp, iy = pass_y(score, ay, by, shift_y, dlen_y, nvalid=valid_h)
    tmp_t, iy_t = transpose_last2_pair(tmp, iy)
    msg_t, ptr_t = pass_x(
        tmp_t, ax, bx, shift_x, dlen_x, nvalid=valid_w, aux=iy_t
    )
    return transpose_last2_pair(msg_t, ptr_t)


def shift_distance_transform_2d(
    score: torch.Tensor,
    wdef,
    shift_x,
    shift_y,
    dlen_x: int,
    dlen_y: int,
    step: int = 1,
    valid_h=None,
    valid_w=None,
):
    """As shift_distance_transform_2d_packed, but returning unpacked
    (msg, Ix, Iy) 0-based source coordinates: the packed pointer's
    ptr & 0xFFF and ptr >> 12. On CUDA maps it launches K1, K3's x pass
    and T2; on CPU maps it runs their plain versions."""
    msg, ptr = shift_distance_transform_2d_packed(
        score, wdef, shift_x, shift_y, dlen_x, dlen_y, step, valid_h, valid_w
    )
    return msg, ptr & 0xFFF, ptr >> 12


def distance_transform_2d(score: torch.Tensor, wdef, anchor_x, anchor_y):
    """Same-size anchored DT, the C++ detect() grid
    (src/DynamicProgram.cpp:124-128): output grid q = anchor + i, output
    size equal to the input's. Returns (msg, Ix, Iy)."""
    h, w = score.shape[-2], score.shape[-1]
    return shift_distance_transform_2d(
        score, wdef, anchor_x, anchor_y, dlen_x=w, dlen_y=h, step=1
    )
