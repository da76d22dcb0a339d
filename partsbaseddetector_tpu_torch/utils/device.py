"""The device an entry point of the port runs on."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """`device` as a torch.device. The port's entry points default to
    "cuda" and run on the CPU only when the caller asks for it: a CUDA
    device on a machine without one raises here, at once, instead of
    carrying on silently on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu'")
    return dev
