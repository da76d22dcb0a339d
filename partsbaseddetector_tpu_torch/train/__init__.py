"""Training stacks, with the JAX package's two paths:

  - the structured SVM by subgradient descent (sgd.py, fit.py,
    checkpoint.py), with the whole detection pipeline differentiable and
    the distance transforms' backward a CUDA kernel (K4) on the card;
  - the QP-faithful latent training of the reference's dual
    coordinate-descent recipe (qp.py, latent.py, trainmodel.py), which
    mines latent positives and hard negatives through the detect
    pipeline on the card (detect_tpu.py::TPUMiner).

Support: flat weight layout (layout.py), placement feature extraction +
the score-reconstruction invariant (features.py), model builders
(builder.py), data preparation (data.py), annotation/datasets
(annotate.py). The QP stack and its support are NumPy copies of the JAX
package's modules.
"""

from .builder import (
    build_model,
    cluster_parts,
    init_part_model,
    merge_models,
    relative_part_positions,
)
from .checkpoint import restore_checkpoint, save_checkpoint
from .data import crop_positive, point_to_box, warp_positive_feature
from .features import Placement, placement_feature, reconstruct_score
from .fit import fit
from .latent import train
from .layout import ParamLayout
from .qp import QPSolver
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
from .trainmodel import train_model

__all__ = [
    "LatentHingeLoss",
    "ParamLayout",
    "Placement",
    "QPSolver",
    "apply_params",
    "batch_root_masks",
    "build_model",
    "cluster_parts",
    "crop_positive",
    "fit",
    "init_part_model",
    "make_loss_fn",
    "make_train_step",
    "merge_models",
    "model_params",
    "placement_feature",
    "point_to_box",
    "project_defs",
    "reconstruct_score",
    "relative_part_positions",
    "restore_checkpoint",
    "save_checkpoint",
    "sgd_momentum",
    "train",
    "train_model",
    "warp_positive_feature",
]
