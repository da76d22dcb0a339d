"""Flat weight-vector layout for the structural SVM.

model2vec/vec2model analog (matlab/learning/model2vec.m): the canonical
model's parameter pools (biases, filters, deformations) map into one
flat vector w with recorded offsets; the QP trains w, and the layout
writes it back. Also carries the QP's regularization metadata:
  - w0 floor of 0.01 on quadratic deformation terms and their
    non-negativity set (model2vec.m:22-28),
  - wreg = 0.01 on root biases (weaker regularization,
    model2vec.m:30-33).

A NumPy copy of `partsbaseddetector_tpu/train/layout.py`,
kept verbatim so that the port never imports the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ..models.model import Model


@dataclasses.dataclass
class ParamLayout:
    bias_off: np.ndarray  # (nbias,) offsets, width 1
    filter_off: np.ndarray  # (nfilters,)
    filter_len: np.ndarray  # (nfilters,)
    def_off: np.ndarray  # (ndefs,) width 4
    length: int
    w0: np.ndarray  # (length,)
    wreg: np.ndarray  # (length,)
    noneg: np.ndarray  # indices with w >= 0 constraint

    @staticmethod
    def build(model: Model) -> "ParamLayout":
        off = 0
        bias_off = np.zeros(len(model.biases), dtype=np.int64)
        for i in range(len(model.biases)):
            bias_off[i] = off
            off += 1
        nf = len(model.filters)
        filter_off = np.zeros(nf, dtype=np.int64)
        filter_len = np.zeros(nf, dtype=np.int64)
        for i, f in enumerate(model.filters):
            filter_off[i] = off
            filter_len[i] = f.size
            off += f.size
        def_off = np.zeros(len(model.defs), dtype=np.int64)
        for i in range(len(model.defs)):
            def_off[i] = off
            off += 4
        length = off

        w0 = np.zeros(length)
        wreg = np.ones(length)
        noneg: List[int] = []
        for i in range(len(model.defs)):
            j = def_off[i]
            w0[j] = 0.01  # quadratic-x floor
            w0[j + 2] = 0.01  # quadratic-y floor
            noneg.extend([j, j + 2])
        for c in range(model.ncomponents):
            for idx in np.asarray(model.biasid[c][0]).ravel():
                wreg[bias_off[idx]] = 0.01
        return ParamLayout(
            bias_off=bias_off,
            filter_off=filter_off,
            filter_len=filter_len,
            def_off=def_off,
            length=length,
            w0=w0,
            wreg=wreg,
            noneg=np.asarray(sorted(set(noneg)), dtype=np.int64),
        )

    def model_to_vec(self, model: Model) -> np.ndarray:
        w = np.zeros(self.length)
        w[self.bias_off] = model.biases
        for i, f in enumerate(model.filters):
            w[self.filter_off[i] : self.filter_off[i] + f.size] = f.ravel()
        for i, d in enumerate(model.defs):
            w[self.def_off[i] : self.def_off[i] + 4] = d
        return w

    def vec_to_model(self, w: np.ndarray, model: Model) -> Model:
        model.biases = w[self.bias_off].astype(np.float32)
        for i, f in enumerate(model.filters):
            model.filters[i] = (
                w[self.filter_off[i] : self.filter_off[i] + f.size]
                .reshape(f.shape)
                .astype(np.float32)
            )
        for i in range(len(model.defs)):
            model.defs[i] = w[self.def_off[i] : self.def_off[i] + 4].astype(
                np.float32
            )
        return model
