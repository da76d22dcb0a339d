"""Training: the structured SVM by subgradient descent (sgd.py, fit.py,
checkpoint.py), with the whole detection pipeline differentiable and
the distance transforms' backward a CUDA kernel (K4) on the card.

The QP-faithful trainers of the JAX package (qp.py, latent.py,
trainmodel.py) and its on-device miner (detect_tpu.py) are not ported
yet.
"""

from .checkpoint import restore_checkpoint, save_checkpoint
from .fit import fit
from .sgd import (
    LatentHingeLoss,
    apply_params,
    batch_root_masks,
    make_loss_fn,
    make_train_step,
    model_params,
    project_defs,
    sgd_momentum,
)

__all__ = [
    "LatentHingeLoss",
    "apply_params",
    "batch_root_masks",
    "fit",
    "make_loss_fn",
    "make_train_step",
    "model_params",
    "project_defs",
    "restore_checkpoint",
    "save_checkpoint",
    "sgd_momentum",
]
