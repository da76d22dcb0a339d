"""Data and tensor parallelism on torch.distributed: device meshes,
dp-sharded batched detection and the dp x tp sharded training step
(port of `partsbaseddetector_tpu/parallel/`)."""

from .mesh import batched_detect_fn, make_mesh, sharded_train_step
from .distributed import (
    distributed_batched_detect_fn,
    distributed_train_step,
    host_local_batch_to_global,
    initialize_distributed,
    make_global_mesh,
)

__all__ = [
    "batched_detect_fn",
    "distributed_batched_detect_fn",
    "distributed_train_step",
    "host_local_batch_to_global",
    "initialize_distributed",
    "make_global_mesh",
    "make_mesh",
    "sharded_train_step",
]
