"""The system under test: the torch port's detector, built from the
run's generated arrays. The only module of the harness, with the traced
run's counter readings, that imports the program."""

from __future__ import annotations

import numpy as np
import torch


def detector(cfg: dict, arrays: dict, device, **overrides):
    """A PartsBasedDetector over the generated model, with the
    configuration's profile (dtype, engine, buckets, candidate budget);
    `overrides` replace detector arguments (the control's precision)."""
    from partsbaseddetector_tpu_torch import PartsBasedDetector
    from partsbaseddetector_tpu_torch.models.model import Model

    p_, k_ = cfg["parts"], cfg["mixtures"]
    filters = arrays["filters"].cpu().numpy()
    defs = arrays["defs"].cpu().numpy()
    anchors = arrays["anchors"].cpu().numpy()
    bias = arrays["bias"].cpu().numpy()
    pools = [bias[0, :1]] + [bias[p] for p in range(1, p_)]
    biasid, offset = [], 0
    for tbl in pools:
        biasid.append(offset + np.arange(tbl.size, dtype=np.int32).reshape(tbl.shape))
        offset += tbl.size
    ids = lambda p: np.arange(p * k_, (p + 1) * k_, dtype=np.int32)
    model = Model(
        name=cfg["name"], interval=cfg["interval"], sbin=cfg["sbin"], thresh=cfg["thresh"],
        filters=[np.ascontiguousarray(filters[p, k]) for p in range(p_) for k in range(k_)],
        defs=[defs[p, k].astype(np.float32) for p in range(p_) for k in range(k_)],
        anchors=[np.array([anchors[p, k, 0], anchors[p, k, 1], 0], np.int32)
                 for p in range(p_) for k in range(k_)],
        biases=np.concatenate([t.reshape(-1) for t in pools]).astype(np.float32),
        parentid=[np.array(cfg["parents"], np.int32)],
        filterid=[[ids(p) for p in range(p_)]],
        defid=[[ids(p) for p in range(p_)]],
        biasid=[biasid],
        maxsize=(cfg["filter_h"], cfg["filter_w"]),
    )
    kw = dict(max_detections=cfg["max_detections"], conv_engine=cfg["conv_engine"],
              buckets_per_octave=cfg["buckets_per_octave"],
              dtype=getattr(torch, cfg["dtype"]), device=device)
    kw.update(overrides)
    return PartsBasedDetector(model, **kw)


def launch_counts():
    """The hand kernels' launches so far, by family, as the program's
    wrappers count them."""
    from partsbaseddetector_tpu_torch.utils.profiling import launch_counts as counts

    return counts()
