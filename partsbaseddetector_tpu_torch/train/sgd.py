"""Structured-SVM training by subgradient descent.

Port of `partsbaseddetector_tpu/train/sgd.py`. The detection score is
(sub)differentiable in every parameter pool: filters (through the
response convolution), deformation weights (through the distance
transform's quadratic, K4's backward) and biases. So the latent SSVM
objective

    C * sum_pos max(0, 1 - s(x))  +  C * sum_neg max(0, 1 + s(x))
    + 0.5 ||w||^2

trains by subgradient descent with a torch optimizer. The max over
latent placements (position, scale, mixtures) is the pipeline's
root-score max. Parameter pools mirror model2vec/vec2model
(matlab/learning/): the non-negativity constraint on the quadratic
deformation terms (model2vec.m:22-33) is a projection after each update.

The JAX step `vmap`s over the batch; here the step runs it image by
image and accumulates each image's share of the mean hinge's gradient,
so only one image's graph is alive at a time.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..models.convert import PARAM_KEYS, params_from_jax, params_to_numpy
from ..models.model import Model, PackedModel, pack_model, to_device
from ..pipeline import build_root_masks, make_plan, max_of_scores, root_scores
from ..utils.device import resolve_device


def model_params(model: Model, device="cuda") -> dict:
    """The trainable pools as f32 leaf tensors that require grad
    (model2vec analog), on `device` (the card unless the caller asks
    for the CPU)."""
    packed = pack_model(model)
    # a single-part model has no deformations; keep one zero row so the
    # gathers stay valid
    defs = (
        np.stack(model.defs)
        if len(model.defs)
        else np.zeros((1, 4), np.float32)
    )
    return params_from_jax(
        {"filters": packed.filters, "defs": defs, "biases": model.biases}, device
    )


def apply_params(model: Model, params: dict) -> Model:
    """Write trained pools back into the canonical model (vec2model
    analog). Filter padding introduced by packing is cropped away."""
    arrays = params_to_numpy(params)
    model = dataclasses.replace(model)
    model.filters = [
        arrays["filters"][i, : f.shape[0], : f.shape[1], :].copy()
        for i, f in enumerate(model.filters)
    ]
    model.defs = [d.copy() for d in arrays["defs"][: len(model.defs)]]
    model.biases = arrays["biases"]
    return model


def project_defs(params: dict, min_quad: float = 0.01) -> dict:
    """Clamp the quadratic deformation terms to stay positive (the QP's
    non-negativity constraint on def weights, qp_one_sparse.cc:247-255 /
    vec2model.m:30-31). In place, so an optimizer keeps its state on the
    same tensors; returns params."""
    with torch.no_grad():
        d = params["defs"]
        d[:, 0].clamp_(min=min_quad)
        d[:, 2].clamp_(min=min_quad)
    return params


def sgd_momentum(tensors: Iterable[torch.Tensor]) -> torch.optim.Optimizer:
    """The default optimizer: SGD at lr 1e-3 with momentum 0.9, which
    updates exactly as optax.sgd(1e-3, momentum=0.9) does."""
    return torch.optim.SGD(tensors, lr=1e-3, momentum=0.9)


class LatentHingeLoss:
    """Latent-hinge loss over a batch of images (make_loss_fn's result).

    Called as loss(params, images, labels), or with latent=True as
    loss(params, images, masks, labels), it returns the SGD-normalized
    objective, mean hinge + 0.5*reg*||w||^2, as a tensor with its
    graph. `value_and_grad` takes the same arguments, builds one image's
    graph at a time and leaves the gradient in each pool's `.grad`."""

    def __init__(self, packed: PackedModel, imsize, reg: float,
                 margin: float, latent: bool, conv=None,
                 engine: str = "spatial"):
        self.packed = packed
        # root_scores' `conv` (the plain one by default, a tensor-parallel
        # one in parallel/mesh.py) and its engine ("fourier": spectra of
        # the traced filters)
        self.conv = conv
        self.engine = engine
        self.plan = make_plan(packed, imsize)
        self.reg = reg
        self.margin = margin
        self.latent = latent
        self._dmodels: Dict[torch.device, object] = {}

    def _dmodel(self, device):
        device = torch.device(device)
        if device not in self._dmodels:
            self._dmodels[device] = to_device(self.packed, device)
        return self._dmodels[device]

    def reg_term(self, params: dict) -> torch.Tensor:
        return 0.5 * sum(torch.sum(torch.square(params[k])) for k in PARAM_KEYS)

    def margin_violation(self, params, im, label: float, masks=None):
        """margin - s for a positive (s the best GT-constrained placement
        when latent), margin + s for a negative (s the best placement
        anywhere); its positive part is the image's hinge."""
        dev = params["filters"].device
        im = torch.as_tensor(im, device=dev)
        scores = root_scores(
            im, self.packed, self._dmodel(dev), self.plan, params,
            with_tables=False, conv=self.conv, engine=self.engine,
        )
        if not self.latent:
            return self.margin - label * max_of_scores(scores)
        if label > 0:
            return self.margin - max_of_scores(scores, masks)
        return self.margin + max_of_scores(scores)

    def _batch(self, rest):
        masks, labels = rest if self.latent else (None, rest[0])
        labels = np.asarray(
            labels.detach().cpu() if torch.is_tensor(labels) else labels,
            np.float32,
        )
        per_image = [
            None if masks is None else [m[i] for m in masks]
            for i in range(len(labels))
        ]
        return labels, per_image

    def __call__(self, params, images, *rest) -> torch.Tensor:
        labels, masks = self._batch(rest)
        zero = torch.zeros((), device=params["filters"].device)
        hinges = [
            torch.maximum(zero, self.margin_violation(params, images[i], float(y), m))
            for i, (y, m) in enumerate(zip(labels, masks))
        ]
        return self.reg * self.reg_term(params) + torch.stack(hinges).mean()

    def value_and_grad(self, params, images, *rest) -> Tuple[torch.Tensor, dict]:
        labels, masks = self._batch(rest)
        for p in params.values():
            p.grad = None
        loss = self.reg * self.reg_term(params)
        loss.backward()
        total = loss.detach()
        n = len(labels)
        for i, (y, m) in enumerate(zip(labels, masks)):
            viol = self.margin_violation(params, images[i], float(y), m)
            if float(viol.detach()) < 0:
                # hinge 0 with a zero gradient: the backward adds nothing
                continue
            hinge = torch.maximum(torch.zeros_like(viol), viol) / n
            hinge.backward()
            total = total + hinge.detach()
        return total, {k: p.grad for k, p in params.items()}


def make_loss_fn(
    packed: PackedModel,
    imsize: Tuple[int, int],
    reg: float = 1e-4,
    margin: float = 1.0,
    latent: bool = False,
) -> LatentHingeLoss:
    """Latent-hinge loss over a batch of images.

    labels: +1 (object present) / -1 (pure negative). For negatives and
    unconstrained positives the latent placement max is the global
    root-score max; with latent=True the loss also takes per-image
    root-placement masks (from batch_root_masks) restricting positive
    placements to ground-truth-overlapping ones, the latent SSVM
    positive constraint."""
    return LatentHingeLoss(packed, imsize, reg, margin, latent)


def batch_root_masks(
    packed: PackedModel,
    imsize: Tuple[int, int],
    bboxes,
    overlap: float = 0.5,
    device="cuda",
) -> List[torch.Tensor]:
    """Per-example root masks for the latent loss. bboxes: (B, 4) GT
    bounding boxes (use the whole image for negatives). Returns a list
    of (B, S_b, Hr, Wr) bool tensors on `device`, one per bucket."""
    device = resolve_device(device)
    plan = make_plan(packed, imsize)
    per_image = [
        build_root_masks(packed, plan, np.asarray(bb), overlap) for bb in bboxes
    ]
    return [
        torch.as_tensor(np.stack([m[b] for m in per_image]), device=device)
        for b in range(len(plan.buckets))
    ]


def make_train_step(
    packed: PackedModel,
    imsize: Tuple[int, int],
    optimizer: Optional[Callable[[Iterable[torch.Tensor]], torch.optim.Optimizer]] = None,
    reg: float = 1e-4,
    latent: bool = False,
):
    """Build a training step.

    Returns (step, optimizer): `optimizer(params.values())` builds the
    torch optimizer over the pools (default `sgd_momentum`); it holds
    what the JAX step's opt_state holds.
    latent=False: step(params, opt, images, labels);
    latent=True:  step(params, opt, images, masks, labels) with masks
    from batch_root_masks (GT-constrained positive placements).
    The step updates params in place (gradient, optimizer step, defs
    projection) and returns (params, opt, loss). It turns TF32 off for
    cuBLAS and cuDNN, as the detector does: the f32 contract has none.
    """
    if optimizer is None:
        optimizer = sgd_momentum
    loss_fn = make_loss_fn(packed, imsize, reg, latent=latent)

    def step(params, opt, images, *rest):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        loss, _ = loss_fn.value_and_grad(params, images, *rest)
        opt.step()
        project_defs(params)
        return params, opt, loss

    return step, optimizer
