"""Multi-process wiring: one process per card, joined by torch.distributed.

Port of `partsbaseddetector_tpu/parallel/distributed.py`:

  - `initialize_distributed` joins the launcher's process group
    (torchrun's MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK and
    LOCAL_RANK), NCCL on the card and gloo only when the caller asks
    for the CPU; with no launcher configured it does nothing;
  - `make_global_mesh` builds the (dp, tp) mesh over every rank, tp
    consecutive ranks forming each tensor-parallel group;
  - `host_local_batch_to_global` wraps this rank's rows as a dp-sharded
    DTensor, so no process ever holds the global batch (the counterpart
    of `jax.make_array_from_process_local_data`).

A failure to set up NCCL raises: nothing falls back to gloo or to the
CPU. One process without a launcher gets the single-rank group and the
1x1 mesh of parallel/mesh.py.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from ..utils.device import resolve_device
from .mesh import (
    DP_ROWS,
    backend_for,
    batched_detect_fn,
    make_mesh,
    sharded_train_step,
)


def initialize_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device="cuda",
) -> bool:
    """Join the process group of a multi-process launch.

    The arguments default to torchrun's environment: init_method to
    "env://" when MASTER_ADDR is set (torch then reads MASTER_ADDR and
    MASTER_PORT), world_size to WORLD_SIZE, rank to RANK; on the card
    the process takes the device LOCAL_RANK. Returns True when a
    multi-process group is (now) set up, False when running alone (no
    launcher configured, or a group of one already set up), in which
    case the caller proceeds with the local mesh."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if init_method is None and env.get("MASTER_ADDR"):
        init_method = "env://"
    if world_size is None and env.get("WORLD_SIZE"):
        world_size = int(env["WORLD_SIZE"])
    if rank is None and env.get("RANK"):
        rank = int(env["RANK"])
    if init_method is None and world_size in (None, 1):
        return False
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", 0)))
    dist.init_process_group(
        backend_for(dev), init_method=init_method, world_size=world_size,
        rank=rank,
    )
    return dist.get_world_size() > 1


def make_global_mesh(tp: int = 1, device="cuda") -> DeviceMesh:
    """The global (dp, tp) mesh over every rank of every host: dp is
    world_size // tp, and tp consecutive ranks (one host's cards under
    torchrun's rank order) form each tensor-parallel group, so the
    filter-bank gathers stay inside a host and only the gradient sum
    over dp crosses hosts."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    assert world % tp == 0, f"{world} ranks not divisible by tp={tp}"
    return make_mesh(dp=world // tp, tp=tp, device=device)


def host_local_batch_to_global(mesh: DeviceMesh, local_batch) -> DTensor:
    """This rank's rows (B_local, ...) as the global batch, a DTensor
    sharded over "dp" and replicated over "tp", on this rank's device.
    The tp ranks of one dp group pass the same rows. No process
    gathers the global batch."""
    if mesh.device_type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device(mesh.device_type)
    local = torch.as_tensor(local_batch, device=dev)
    return DTensor.from_local(local, mesh, DP_ROWS, run_check=False)


def distributed_batched_detect_fn(detector, imsize: Tuple[int, int], tp: int = 1):
    """Multi-process batched detection: returns (fn, mesh), where fn
    takes this process's local batch and runs its rows of the globally
    sharded program. The outputs are DTensors sharded over "dp": each
    process reads its own rows with `.to_local()`, or every row with
    `.full_tensor()`."""
    mesh = make_global_mesh(tp=tp, device=detector.device)
    fn = batched_detect_fn(detector, imsize, mesh)

    def run(local_batch):
        return fn(host_local_batch_to_global(mesh, local_batch))

    return run, mesh


def distributed_train_step(
    packed, imsize: Tuple[int, int], tp: int = 1, device="cuda", **kw
):
    """Multi-process training step: parallel/mesh.py's sharded step over
    the global mesh, returned as (step, optimizer, shard_params, mesh).
    The gradient sum over "dp" is the one collective per step that
    crosses hosts; the filter-bank gathers stay inside each tp group."""
    mesh = make_global_mesh(tp=tp, device=device)
    step, opt, shard_params = sharded_train_step(packed, imsize, mesh, **kw)
    return step, opt, shard_params, mesh
