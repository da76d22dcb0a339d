"""2-D generalized quadratic distance transform with packed pointers.

Port of `partsbaseddetector_tpu/ops/distance_transform.py::
shift_distance_transform_2d_packed`. Both separable passes run the 1-D
kernel along axis -2 (ops/dt_cuda.py::dt1d): the y pass in place, then
the x pass on the transposed intermediate with the y pointers carried
as `aux`, which fuses the MATLAB/shiftdt composition Iy = tmpIy[Ix]
(shiftdt.cc:95-108) into the kernel.

Conventions (as in the JAX package):
  - deformation weights are the model's positive costs
    [wx2, wx1, wy2, wy1]; they are negated here (DynamicProgram.cpp:
    126-127, shiftdt.cc:70-73);
  - the output grid is q = shift + i*step (0-based);
  - ties go to the smallest source index.
The JAX package's kernel-dispatch heuristics and its scale/row packing
are TPU-lane artefacts and are not carried over.
"""

from __future__ import annotations

import torch

from .dt_cuda import dt1d


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
):
    """2-D shifted/subsampled generalized DT.

    score: (..., H, W) child score maps, -inf where invalid.
    wdef: (..., 4) positive deformation costs, broadcast over the batch.
    shift_x / shift_y: broadcastable to score.shape[:-2].
    valid_h: per-map live row count of score (rows beyond are -inf);
    valid_w: per-map live column count. Both default to the full map.
    differentiable=True runs both passes with K4's backward (score and
    wdef get gradients; autograd carries them through the transposes).
    Returns (msg (..., dlen_y, dlen_x) f32, ptr (Iy << 12) | Ix int32).
    """
    ax, bx = -wdef[..., 0], -wdef[..., 1]
    ay, by = -wdef[..., 2], -wdef[..., 3]
    tmp, iy = dt1d(
        score, ay, by, shift_y, dlen_y, step, nvalid=valid_h,
        differentiable=differentiable,
    )
    msg_t, ptr_t = dt1d(
        tmp.transpose(-1, -2).contiguous(),
        ax, bx, shift_x, dlen_x, step,
        nvalid=valid_w,
        aux=iy.transpose(-1, -2).contiguous(),
        differentiable=differentiable,
    )
    return (
        msg_t.transpose(-1, -2).contiguous(),
        ptr_t.transpose(-1, -2).contiguous(),
    )
