"""Model conversion into the port's `Model`.

`model_from_arrays` reads the canonical flat array layout that
`save_model` writes (and `np.load` of an .npz returns).
`model_from_jax` copies the NumPy fields of a model object from the JAX
package field by field, so both packages compute from the same weights.
It reads attributes only and never imports the JAX package.
`params_from_jax` / `params_to_numpy` carry the trainable pools
{'filters', 'defs', 'biases'} across in the same way.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..utils.device import resolve_device
from .model import Model


def model_from_arrays(data: Mapping[str, np.ndarray]) -> Model:
    """Build a Model from the flat `save_model` layout: `filter_<i>`,
    `def_<i>`, `anchor_<i>`, `parentid_<c>`, `filterid_<c>_<p>`,
    `defid_<c>_<p>`, `biasid_<c>_<p>` plus the scalar fields."""
    keys = list(data.keys())
    nfilters = len([k for k in keys if k.startswith("filter_")])
    ndefs = len([k for k in keys if k.startswith("def_")])
    ncomp = int(data["ncomponents"])
    filters = [np.asarray(data[f"filter_{i}"]) for i in range(nfilters)]
    defs = [np.asarray(data[f"def_{i}"]) for i in range(ndefs)]
    anchors = [np.asarray(data[f"anchor_{i}"]) for i in range(ndefs)]
    parentid, filterid, defid, biasid = [], [], [], []
    for c in range(ncomp):
        par = np.asarray(data[f"parentid_{c}"])
        parentid.append(par)
        filterid.append(
            [np.asarray(data[f"filterid_{c}_{p}"]) for p in range(len(par))]
        )
        defid.append(
            [np.asarray(data[f"defid_{c}_{p}"]) for p in range(len(par))]
        )
        biasid.append(
            [np.asarray(data[f"biasid_{c}_{p}"]) for p in range(len(par))]
        )
    ms = tuple(int(v) for v in np.asarray(data["maxsize"]))
    return Model(
        name=str(data["name"]),
        interval=int(data["interval"]),
        sbin=int(data["sbin"]),
        thresh=float(data["thresh"]),
        filters=filters,
        defs=defs,
        anchors=anchors,
        biases=np.asarray(data["biases"]),
        parentid=parentid,
        filterid=filterid,
        defid=defid,
        biasid=biasid,
        norient=int(data["norient"]),
        flen=int(data["flen"]),
        maxsize=None if ms == (-1, -1) else ms,
    )


def model_from_jax(m) -> Model:
    """Copy a JAX-package `Model` (all of whose fields are NumPy arrays
    and Python scalars) into the port's `Model`."""
    arr = lambda x, dt: np.array(x, dtype=dt, copy=True)
    return Model(
        name=str(m.name),
        interval=int(m.interval),
        sbin=int(m.sbin),
        thresh=float(m.thresh),
        filters=[arr(f, np.float32) for f in m.filters],
        defs=[arr(d, np.float32) for d in m.defs],
        anchors=[arr(a, np.int32) for a in m.anchors],
        biases=arr(m.biases, np.float32),
        parentid=[arr(p, np.int32) for p in m.parentid],
        filterid=[[arr(f, np.int32) for f in c] for c in m.filterid],
        defid=[[arr(d, np.int32) for d in c] for c in m.defid],
        biasid=[[arr(b, np.int32) for b in c] for c in m.biasid],
        norient=int(m.norient),
        flen=int(m.flen),
        maxsize=None if m.maxsize is None else tuple(int(v) for v in m.maxsize),
    )


PARAM_KEYS = ("filters", "defs", "biases")


def params_from_jax(params: Mapping, device="cuda") -> dict:
    """The JAX package's trainable pools (any arrays NumPy can read:
    jax arrays, NumPy) as f32 torch leaf tensors on `device` (the card
    unless the caller asks for the CPU) that require grad."""
    device = resolve_device(device)
    return {
        k: torch.tensor(
            np.asarray(params[k], np.float32), device=device,
            requires_grad=True,
        )
        for k in PARAM_KEYS
    }


def params_to_numpy(params: Mapping) -> dict:
    """The inverse of params_from_jax: f32 NumPy copies of the pools."""
    return {
        k: params[k].detach().to("cpu", torch.float32).numpy().copy()
        for k in PARAM_KEYS
    }
