"""The system under test: the torch port's detector, built from the
run's generated arrays (lib/inputs.py): the filter pool, and one
component of the program's `Model` a tree, its parts indexing the pool,
with deformations and biases of its own. The only module of the
harness, with the traced run's counter readings, that imports the
program."""

from __future__ import annotations

import numpy as np
import torch

from . import spec


def model(cfg: dict, arrays: dict):
    """The program's `Model` of the generated arrays: each pool filter at
    its own size, each anchor with its part's ds, the configuration's
    padding size.

    A configuration whose pyramid is other than "pose", the form every
    configuration meant before the key (lib/spec.py), passes it on as
    `Model(pyramid=...)`: the program's `Model` takes `pyramid`, "pose"
    or "dpm", with the reference's meaning (reference/pbd_tree.py). A
    program without that field fails at this call, loudly, rather than
    running the pose form under another name. A "pose" configuration
    makes the call it made before the key."""
    from partsbaseddetector_tpu_torch.models.model import Model

    bank = arrays["filters"].cpu().numpy()
    sizes = arrays["sizes"].tolist()
    defs, anchors, tables = [], [], []
    parentid, filterid, defid, biasid = [], [], [], []
    offset = 0
    for t in arrays["trees"]:
        fid = t["filterid"].cpu().numpy().astype(np.int32)
        ds = t["ds"].tolist()
        d = t["defs"].cpu().numpy()
        a = t["anchors"].cpu().numpy()
        bias = t["bias"].cpu().numpy()
        p_, k_ = fid.shape
        base = len(defs)
        defs += [d[p, k].astype(np.float32) for p in range(p_) for k in range(k_)]
        anchors += [np.array([a[p, k, 0], a[p, k, 1], ds[p]], np.int32)
                    for p in range(p_) for k in range(k_)]
        # the root's (1, K) table, then each part's (K_parent, K)
        ids = []
        for tbl in [bias[0, :1]] + [bias[p] for p in range(1, p_)]:
            ids.append(offset + np.arange(tbl.size, dtype=np.int32).reshape(tbl.shape))
            tables.append(tbl.reshape(-1))
            offset += tbl.size
        parentid.append(t["parent"].cpu().numpy().astype(np.int32))
        filterid.append(list(fid))
        defid.append([base + np.arange(p * k_, (p + 1) * k_, dtype=np.int32)
                      for p in range(p_)])
        biasid.append(ids)
    form = spec.pyramid(cfg)
    return Model(
        name=cfg["name"], interval=cfg["interval"], sbin=cfg["sbin"], thresh=cfg["thresh"],
        filters=[np.ascontiguousarray(f[:h, :w]) for f, (h, w) in zip(bank, sizes)],
        defs=defs, anchors=anchors,
        biases=np.concatenate(tables).astype(np.float32),
        parentid=parentid, filterid=filterid, defid=defid, biasid=biasid,
        maxsize=tuple(arrays["maxsize"]), **({"pyramid": form} if form != "pose" else {}),
    )


def detector(cfg: dict, arrays: dict, device, **overrides):
    """A PartsBasedDetector over the generated model, with the
    configuration's profile (dtype, engine, buckets, candidate budget);
    `overrides` replace detector arguments (the control's precision)."""
    from partsbaseddetector_tpu_torch import PartsBasedDetector

    kw = dict(max_detections=cfg["max_detections"], conv_engine=cfg["conv_engine"],
              buckets_per_octave=cfg["buckets_per_octave"],
              dtype=getattr(torch, cfg["dtype"]), device=device)
    kw.update(overrides)
    return PartsBasedDetector(model(cfg, arrays), **kw)


def launch_counts():
    """The hand kernels' launches so far, by family, as the program's
    wrappers count them."""
    from partsbaseddetector_tpu_torch.utils.profiling import launch_counts as counts

    return counts()
