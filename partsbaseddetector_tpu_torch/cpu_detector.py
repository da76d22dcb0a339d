"""CPU serving path: the full detector on the native C++ kernels.

A copy of `partsbaseddetector_tpu/cpu_detector.py` on the port's own
copy of the native library (`native/`), so that the port never imports
the JAX package. Same public API as PartsBasedDetector, on the host
only, by design: the pipeline runs through the native library (OpenMP
HOG, envelope distance transforms, correlation); if that library cannot
be built or loaded (no g++), it falls back to the NumPy reference
kernels, as the JAX package does. It is the runtime analog of the
reference's OpenMP CPU implementation, a host baseline for the card,
and an end-to-end cross-check of the card path. With a depth map,
candidates are filtered on the host by the port's `depth.py`.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .models.model import Model
from .ops import reference
from .ops.reference_pipeline import detect_reference
from .types import Candidate


class CPUPartsBasedDetector:
    def __init__(self, model: Optional[Model] = None, use_native: bool = True):
        self._model: Optional[Model] = None
        self._kernels = reference
        if use_native:
            from . import native

            if native.available():
                self._kernels = native
        if model is not None:
            self.distribute_model(model)

    def distribute_model(self, model: Model) -> None:
        self._model = model

    @property
    def name(self) -> str:
        return self._model.name if self._model else ""

    def detect(
        self, im: np.ndarray, depth: Optional[np.ndarray] = None
    ) -> List[Candidate]:
        if self._model is None:
            raise RuntimeError("distribute_model() must be called first")
        dets = detect_reference(im, self._model, kernels=self._kernels)
        out: List[Candidate] = []
        for d in dets:
            conf = np.zeros(len(d["boxes"]), dtype=np.float32)
            conf[0] = d["score"]
            out.append(Candidate(d["boxes"], conf, d["component"]))
        if depth is not None:
            from .depth import filter_candidates_by_depth
            from .models.model import pack_model

            out = filter_candidates_by_depth(pack_model(self._model), out, depth)
        return out
