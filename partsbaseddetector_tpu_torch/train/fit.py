"""High-level SGD training loop: epochs, batching, checkpointing.

Port of `partsbaseddetector_tpu/train/fit.py`, the counterpart of
trainmodel.m's outer loop: seeded shuffled mini-batches, optional
latent root masks, periodic checkpoints, and the trained pools written
back into a canonical Model.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.model import Model, pack_model
from ..utils.device import resolve_device
from .checkpoint import restore_checkpoint, save_checkpoint
from .sgd import apply_params, batch_root_masks, make_train_step, model_params


def fit(
    model: Model,
    images: Sequence[np.ndarray],
    labels: Sequence[float],
    bboxes: Optional[Sequence[np.ndarray]] = None,
    epochs: int = 10,
    batch_size: int = 8,
    optimizer=None,
    overlap: float = 0.5,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 5,
    seed: int = 0,
    verbose: bool = False,
    device="cuda",
) -> Tuple[Model, List[float]]:
    """Train by batched subgradient descent on `device` (the card unless
    the caller asks for the CPU).

    images: same-shape (H, W, 3) arrays; labels: +-1; bboxes (optional):
    per-image GT boxes enabling the latent-positive constraint;
    optimizer: a factory over the pools (see make_train_step).
    Returns (trained model, per-epoch mean losses). Resumes from
    checkpoint_dir if a checkpoint exists there; the batch order of an
    epoch comes from np.random.RandomState(seed), as in the JAX package.
    """
    device = resolve_device(device)
    packed = pack_model(model)
    imsize = images[0].shape[:2]
    latent = bboxes is not None
    step, make_opt = make_train_step(
        packed, imsize, optimizer=optimizer, latent=latent
    )

    params = model_params(model, device)
    opt = make_opt(params.values())
    start_epoch = 0
    if checkpoint_dir:
        restored = restore_checkpoint(checkpoint_dir, params, opt)
        if restored is not None:
            params, opt, start_epoch = restored
            if verbose:
                print(f"resumed from epoch {start_epoch}")

    images_d = torch.as_tensor(
        np.stack(images).astype(np.float32), device=device
    )
    labels_h = np.asarray(labels, dtype=np.float32)
    masks_all = None
    if latent:
        masks_all = batch_root_masks(packed, imsize, bboxes, overlap, device)

    rng = np.random.RandomState(seed)
    n = len(images)
    history: List[float] = []
    for epoch in range(start_epoch, epochs):
        order = rng.permutation(n)
        losses = []
        for i in range(0, n - batch_size + 1, batch_size):
            sel = order[i : i + batch_size]
            sel_d = torch.as_tensor(sel, device=device)
            bi = images_d[sel_d]
            if latent:
                bm = [m[sel_d] for m in masks_all]
                params, opt, loss = step(params, opt, bi, bm, labels_h[sel])
            else:
                params, opt, loss = step(params, opt, bi, labels_h[sel])
            losses.append(float(loss))
        history.append(float(np.mean(losses)) if losses else float("nan"))
        if verbose:
            print(f"epoch {epoch}: loss {history[-1]:.4f}")
        if checkpoint_dir and (epoch + 1) % checkpoint_every == 0:
            save_checkpoint(checkpoint_dir, params, opt, epoch + 1)

    return apply_params(model, params), history
