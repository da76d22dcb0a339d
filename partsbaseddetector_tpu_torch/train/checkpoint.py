"""Training checkpoint/resume for the SGD path.

Port of `partsbaseddetector_tpu/train/checkpoint.py`. The live state of a
run (the parameter pools, the optimizer's `state_dict` and the step)
goes into `<path>/state.pt` with `torch.save`, and comes back with
`torch.load(weights_only=True)`, so a restore executes no pickled code.
The JAX package checkpoints with orbax; the port needs nothing beyond
torch.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

STATE_FILE = "state.pt"


def save_checkpoint(path: str, params: dict, optimizer, step: int) -> None:
    """Checkpoint to `path` (a directory). The file is written beside
    its final name and renamed into place, so a crash mid-write leaves
    the previous checkpoint intact."""
    os.makedirs(path, exist_ok=True)
    state = {
        "params": {k: v.detach().cpu() for k, v in params.items()},
        "optimizer": optimizer.state_dict(),
        "step": int(step),
    }
    final = os.path.join(path, STATE_FILE)
    tmp = final + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, final)


def restore_checkpoint(
    path: str, params: dict, optimizer
) -> Optional[Tuple[dict, object, int]]:
    """Restore a checkpoint saved by save_checkpoint into `params` (in
    place, on their devices) and `optimizer`. Returns (params,
    optimizer, step), or None if there is no checkpoint."""
    f = os.path.join(path, STATE_FILE)
    if not os.path.exists(f):
        return None
    state = torch.load(f, map_location="cpu", weights_only=True)
    if sorted(state["params"]) != sorted(params):
        raise ValueError(
            f"checkpoint pools {sorted(state['params'])} != {sorted(params)}"
        )
    with torch.no_grad():
        for k, v in params.items():
            v.copy_(state["params"][k])
    optimizer.load_state_dict(state["optimizer"])
    return params, optimizer, int(state["step"])
