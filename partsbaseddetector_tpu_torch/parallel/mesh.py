"""Data and tensor parallelism over a torch.distributed device mesh.

Port of `partsbaseddetector_tpu/parallel/mesh.py`. The JAX package
annotates jit boundaries with shardings and lets GSPMD pick the
collectives; here every rank is a process that runs its own share of
the program, and the collectives are explicit:

  - the mesh: `init_device_mesh` over the process group, dims
    ("dp", "tp"), in place of `jax.sharding.Mesh`; NCCL on the card,
    gloo on the CPU;
  - batched detection: the batch axis is split over "dp" (a DTensor
    with placements [Shard(0), Replicate()], the counterpart of
    `NamedSharding(mesh, P("dp"))`); each rank runs the detector's
    batched program (`detect_batch_fn`) on its rows, and tp ranks of
    one dp group compute the same rows, as JAX replicates them;
  - training: images and labels are split over "dp" and the filter
    bank's F axis over "tp". Each tp rank computes the responses of its
    F/tp filters; they are gathered back along F (`_GatherFilters`), so
    every rank of a tp group runs the same DP on the whole bank's
    responses, and autograd hands each shard the gradient of its own
    filters. Defs and biases are replicated. The hinge is averaged over
    the global batch and the gradients are summed over "dp"; the
    regulariser is counted once.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..models.model import PackedModel
from ..ops.conv import filter_responses
from ..utils.device import resolve_device

# the placements of a batch split over "dp" and replicated over "tp"
DP_ROWS = (Shard(0), Replicate())
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def backend_for(device: torch.device) -> str:
    """The process group's backend for a device type: NCCL on the card,
    gloo on the CPU (only when the caller asks for the CPU)."""
    if device.type not in BACKENDS:
        raise ValueError(f"no process-group backend for {device}")
    return BACKENDS[device.type]


def make_mesh(
    n_devices: Optional[int] = None,
    dp: Optional[int] = None,
    tp: int = 1,
    device="cuda",
) -> DeviceMesh:
    """A (dp, tp) mesh over the process group, one rank per device.
    Without a process group it first joins the launcher's
    (`initialize_distributed`), and with no launcher configured it
    makes a single-rank group over an in-memory store, so one process
    gets the 1x1 mesh. dp defaults to n_devices // tp, n_devices to the
    group's size; dp * tp must be the group's size."""
    from .distributed import initialize_distributed

    dev = resolve_device(device)
    if not dist.is_initialized() and not initialize_distributed(device=dev):
        dist.init_process_group(
            backend_for(dev), store=dist.HashStore(), rank=0, world_size=1
        )
    world = dist.get_world_size()
    n = n_devices or world
    if dp is None:
        dp = n // tp
    if dp * tp != world:
        raise ValueError(
            f"a ({dp}, {tp}) mesh needs {dp * tp} ranks; the process group "
            f"has {world}"
        )
    return init_device_mesh(dev.type, (dp, tp), mesh_dim_names=("dp", "tp"))


def dp_rows(x, mesh: DeviceMesh) -> Tuple[torch.Tensor, int]:
    """(this rank's rows, the global row count) of a batch split over
    "dp": a DTensor's local shard, or, of a whole batch that every rank
    holds, the dp rank's contiguous block (the layout of P("dp"))."""
    if isinstance(x, DTensor):
        return x.to_local(), int(x.shape[0])
    x = torch.as_tensor(x)
    n, ndp = int(x.shape[0]), mesh.size(0)
    if n % ndp:
        raise ValueError(f"a batch of {n} does not split over dp={ndp}")
    k = n // ndp
    r = mesh.get_local_rank("dp")
    return x[r * k : (r + 1) * k], n


def batched_detect_fn(detector, imsize: Tuple[int, int], mesh: Optional[DeviceMesh] = None):
    """The detector's batched program over a batch; with a mesh, the
    batch split over "dp".

    Returns fn: (B, H, W, 3) -> (boxes, scores, components, valid,
    mixtures), batch-major. Without a mesh the outputs are the device
    tensors of `detector.detect_batch_fn`. With one, fn takes the whole
    batch (each rank keeps its rows) or a dp-sharded DTensor
    (`distributed.host_local_batch_to_global`), runs this rank's rows,
    and returns DTensors sharded over "dp" (`.full_tensor()` gathers
    them). Under the Fourier engine the filter spectra go to the device
    once, here, and stay with the detector's plan: each rank holds its
    replica, so no call sends them again (the JAX package commits them
    replicated for the same reason)."""
    if detector.conv_engine == "fourier":
        detector._fft_spectra(imsize)
    programs = {}

    def program(ims: torch.Tensor):
        ims = torch.as_tensor(ims, device=detector.device)
        n = int(ims.shape[0])
        if n not in programs:
            programs[n] = detector.detect_batch_fn(imsize, n)
        return programs[n](ims)

    if mesh is None:
        return program
    if mesh.device_type != detector.device.type:
        raise ValueError(
            f"the mesh is on {mesh.device_type}, the detector on {detector.device}"
        )

    def run(ims):
        local, _ = dp_rows(ims, mesh)
        return tuple(
            DTensor.from_local(o, mesh, DP_ROWS, run_check=False)
            for o in program(local)
        )

    return run


class _GatherFilters(torch.autograd.Function):
    """All-gather along the last (filter) axis over the tp group. Every
    rank of the group computes the same thing downstream (the same
    images, the whole bank's responses), so the loss's gradient with
    respect to the gathered tensor is the same on each of them, and a
    shard's gradient is its own slice: the backward takes the slice and
    sends nothing. (`torch.distributed.nn.functional.all_gather`
    reduce-scatters the tp copies in its backward, which counts the
    gradient tp times here, and on gloo it addresses its scatters by
    group-local rank as if global, which fails in any tp group that
    lacks rank 0.)"""

    @staticmethod
    def forward(ctx, x, group):
        ctx.width = x.shape[-1]
        ctx.rank = dist.get_rank(group)
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.rank * ctx.width
        return grad[..., lo : lo + ctx.width].contiguous(), None


class ParamSharding:
    """`shard_params` of a sharded train step: the trainable pools with
    the filter bank split over "tp". Called on full pools (model_params),
    it returns new leaf tensors: this tp rank's block of
    ceil(F / tp) filters, zero filters padding the bank to a multiple of
    tp (their responses are sliced away after the gather, so they get no
    gradient and stay zero), and copies of defs and biases. `gather`
    is the inverse: the whole F-filter bank on every rank, detached."""

    def __init__(self, nfilters: int, mesh: DeviceMesh):
        self.nfilters = nfilters
        self.tp = mesh.size(1)
        self.per_rank = -(-nfilters // self.tp)
        self.rank = mesh.get_local_rank("tp")
        self.group = mesh.get_group("tp")

    def __call__(self, params: dict) -> dict:
        f = params["filters"].detach()
        pad = self.per_rank * self.tp - self.nfilters
        if pad:
            f = torch.cat([f, f.new_zeros((pad, *f.shape[1:]))])
        lo = self.rank * self.per_rank
        out = {"filters": f[lo : lo + self.per_rank]}
        out.update({k: v.detach() for k, v in params.items() if k != "filters"})
        return {k: v.clone().requires_grad_(True) for k, v in out.items()}

    def gather(self, params: dict) -> dict:
        with torch.no_grad():
            parts = [torch.empty_like(params["filters"]) for _ in range(self.tp)]
            dist.all_gather(parts, params["filters"].detach().contiguous(), group=self.group)
        out = {"filters": torch.cat(parts)[: self.nfilters]}
        out.update({k: v.detach().clone() for k, v in params.items() if k != "filters"})
        return out


def sharded_train_step(
    packed: PackedModel,
    imsize: Tuple[int, int],
    mesh: DeviceMesh,
    optimizer=None,
    reg: float = 1e-4,
):
    """A training step sharded over the mesh (images and labels over
    "dp", the filter bank over "tp", defs and biases replicated).

    Returns (step, optimizer, shard_params) around
    `train/sgd.py::make_train_step`: `shard_params(model_params(...))`
    gives this rank's pools (a ParamSharding; `shard_params.gather`
    gives them back whole), `optimizer(params.values())` builds the
    torch optimizer over them, and step(params, opt, images, labels)
    takes the whole batch (or dp-sharded DTensors), updates params in
    place and returns (params, opt, loss). The loss and the gathered
    pools after a step are one process's make_train_step on the whole
    batch, to rounding: the hinge is averaged over the global batch and
    its gradients summed over "dp" (all_reduce), and the regulariser is
    counted once."""
    from ..train.sgd import LatentHingeLoss, make_train_step, project_defs

    _, optimizer = make_train_step(packed, imsize, optimizer, reg)
    shard_params = ParamSharding(int(packed.filters.shape[0]), mesh)
    tp_group, dp_group = mesh.get_group("tp"), mesh.get_group("dp")

    def conv(features, filters):
        resp = _GatherFilters.apply(filter_responses(features, filters), tp_group)
        return resp[..., : shard_params.nfilters]

    loss_fn = LatentHingeLoss(packed, imsize, reg, 1.0, latent=False, conv=conv)

    def step(params, opt, images, labels):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        ims, n = dp_rows(images, mesh)
        labs, _ = dp_rows(labels, mesh)
        labs = np.asarray(labs.detach().cpu(), np.float32)
        for p in params.values():
            p.grad = None
        dev = params["filters"].device
        hinge = torch.zeros((), device=dev)
        for im, y in zip(ims, labs):
            viol = loss_fn.margin_violation(params, im, float(y))
            if float(viol.detach()) < 0:
                continue
            h = viol / n
            h.backward()
            hinge = hinge + h.detach()
        with torch.no_grad():
            for p in params.values():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                dist.all_reduce(p.grad, group=dp_group)
                p.grad.add_(reg * p)
            dist.all_reduce(hinge, group=dp_group)
            fsq = torch.sum(torch.square(params["filters"]))
            dist.all_reduce(fsq, group=tp_group)
            sq = fsq + sum(
                torch.sum(torch.square(v)) for k, v in params.items() if k != "filters"
            )
            loss = reg * (0.5 * sq) + hinge
        opt.step()
        project_defs(params)
        return params, opt, loss

    return step, optimizer, shard_params
