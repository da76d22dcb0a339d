"""Mining through the port's detect pipeline, for the QP/latent
training loop.

Port of `partsbaseddetector_tpu/train/detect_tpu.py::TPUMiner`; the
file and class keep their names, so that a caller of the JAX API ports
unchanged. The miner runs on the card (device="cuda", the default) or,
when asked, on the CPU. The reference mines latent positives and hard
negatives by running the full detector inside the training loop
(matlab/learning/train.m:75-106); here that mining runs the inference
route of `pipeline.root_scores`: on the card the K2 conv kernel in one
grouped launch per detect, then the distance transforms with live
counts (K1 on the y pass, K1 with pointers on the x pass, T2's pair
transposes; K5 under PBD_DT_WINDOW=1). Returned placements use the
reference convention (root pyramid level, per-part padded-grid coords,
mixture indices: the dict contract of
ops/reference_pipeline.detect_reference), so train/features.py
assembles QP feature vectors on the host unchanged.

Latent-positive constraints (per-part ground-truth IoU masks,
detect.m:60-99) become per-filter response masks: each (part, mixture)
owns one filter in the packed bank, so one (S, Hr, Wr, F) bool tensor
per bucket expresses the reference's per-part masking exactly,
including the fixed-mixtures quirk where ONLY the mixture constraint
applies (detect.m:88-99).

dtype=torch.bfloat16 runs the JAX miner's bf16 call itself:
root_scores with the f32 pools as params (under torch.no_grad) and
-1e10 masking in bf16, the pyramid, HOG and the library's conv2d in
bf16, the DP in bf16 with its DTs widened to f32 (K1, K3 and T2 on the
card, no K2).

The masking value. The f32 miner runs the inference route, which masks
with -inf; the JAX miner runs the training route and masks with -1e10
(detect.m's INF). After
the validity cut at _NEG_THRESH = -1e9 both give the same valid
placements and the same finite scores: a -1e10 cell never wins a max
against a live source (a live score exceeds it by ~1e10, far more than
any deformation cost), so every placement that reaches a live cell
picks the same cell either way; and a root that reaches only masked
cells scores about -1e10 or -inf, below -1e9 either way, and is cut.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.model import Model, pack_model, to_device
from ..ops.dp import backtrack, stable_top_k
from ..ops.reference_pipeline import overlap_mask
from ..pipeline import make_plan, root_scores
from ..utils.device import resolve_device

# below any genuine score, above the -1e10 the JAX miner masks with, so
# masked placements stay invalid in backtrack under either masking value
_NEG_THRESH = -1e9


def _filters_unique_per_part(model: Model) -> bool:
    """Per-filter masks express per-part constraints only when no filter
    is shared between two (component, part) slots."""
    owner: Dict[int, Tuple[int, int]] = {}
    for c in range(model.ncomponents):
        for p in range(model.nparts(c)):
            for f in np.asarray(model.filterid[c][p]).ravel():
                key = int(f)
                if key in owner and owner[key] != (c, p):
                    return False
                owner[key] = (c, p)
    return True


class TPUMiner:
    """Mining detector whose weights change without re-planning.

    The model's structure (tree topology, filter sizes, index tables,
    pyramid interval) is packed and planned once per (image shape,
    interval); the weights live in a DeviceModel that set_model()
    rebuilds (the bank upload and, on the card, its TF32 split) and
    nothing else. Call set_model() after each QP update.
    """

    def __init__(
        self,
        model: Model,
        max_det: int = 64,
        dtype=torch.float32,
        device="cuda",
    ):
        if dtype not in (torch.float32, torch.bfloat16):
            raise NotImplementedError(
                f"TPUMiner: dtype {dtype}; float32 and bfloat16 are ported"
            )
        self.device = resolve_device(device)
        self._model = model
        self.max_det = int(max_det)
        self.dtype = dtype
        # (H, W, interval) -> (packed structure, plan, per-bucket
        # (box scales, levels) on the device)
        self._plans: Dict[Tuple[int, int, int], Tuple] = {}
        self._dmodel = None
        self._params = None
        self._struct = self._structure_key(model)

    @staticmethod
    def _structure_key(model: Model):
        return (
            len(model.filters),
            tuple(f.shape for f in model.filters),
            len(model.defs),
            model.sbin,
        )

    def set_model(self, model: Model) -> None:
        """Adopt updated weights. The plans stay valid while the
        structure is the same; a changed structure clears them."""
        if self._structure_key(model) != self._struct:
            self._plans.clear()
            self._struct = self._structure_key(model)
        self._model = model
        self._dmodel = None
        self._params = None

    def _get_params(self) -> dict:
        """The weights as the f32 pools of the training route (the bf16
        miner's: the JAX miner runs root_scores with them)."""
        if self._params is None:
            from .sgd import model_params

            self._params = model_params(self._model, device=self.device)
        return self._params

    def _get_dmodel(self):
        if self._dmodel is None:
            self._dmodel = to_device(pack_model(self._model), self.device)
        return self._dmodel

    def _get_plan(self, imshape: Tuple[int, int]):
        model = self._model
        key = (int(imshape[0]), int(imshape[1]), int(model.interval))
        if key not in self._plans:
            packed = pack_model(model)  # its weights are never read
            assert packed.spec.border == "matlab"
            plan = make_plan(packed, imshape)
            tabs = [
                (
                    torch.as_tensor(
                        [plan.scales[s].box_scale for s in b.scale_indices],
                        dtype=self.dtype, device=self.device,
                    ),
                    torch.as_tensor(
                        np.asarray(b.scale_indices, np.int64),
                        device=self.device,
                    ),
                )
                for b in plan.buckets
            ]
            self._plans[key] = (packed, plan, tabs)
        return self._plans[key]

    def _mine(self, im: torch.Tensor, packed, plan, tabs, dmodel, masks):
        """The top max_det placements of one (1, H, W, 3) frame, packed
        into one (max_det, 3 + 7 * P_max) f32 tensor per row: score,
        level, component, then mixtures, xs, ys (P_max each) and boxes
        (P_max * 4). Every integer is below 2**24, exact in f32."""
        spec = packed.spec
        max_det = self.max_det
        p_max = packed.max_nparts
        if self.dtype == torch.bfloat16:
            # the JAX miner's bf16 call: the training route's pools and
            # -1e10 masking, the pyramid, HOG and the library conv in
            # bf16, the DP in bf16 with its DTs widened to f32
            scores = root_scores(
                im, packed, dmodel, plan, params=self._get_params(),
                with_tables=True, response_masks=masks,
                dtype=torch.bfloat16, conv_dtype=torch.bfloat16,
            )
        else:
            scores = root_scores(
                im, packed, dmodel, plan, with_tables=True, response_masks=masks,
            )
        rows = []  # (score, valid, level, comp, mixtures, xs, ys, boxes)
        for bs in scores:
            box_scales, levels = tabs[bs.bucket_index]
            bx, sc, mx, vd, (si, xs, ys) = backtrack(
                bs.rootv, bs.rooti, bs.tables,
                packed.components[bs.component],
                dmodel.components[bs.component],
                box_scales,
                box_off_x=-spec.padx,
                box_off_y=-spec.pady,
                thresh=_NEG_THRESH,
                max_det=max_det,
            )
            pc = packed.components[bs.component].nparts
            if pc < p_max:
                # pad the part axis; the boxes replicate the root box
                pad = (0, p_max - pc)
                mx, xs, ys = F.pad(mx, pad), F.pad(xs, pad), F.pad(ys, pad)
                bx = torch.cat(
                    [bx, bx[:, :, :1].expand(-1, -1, p_max - pc, 4)], dim=2
                )
            rows.append((
                sc, vd, levels[si.long()],
                torch.full_like(si, bs.component), mx, xs, ys, bx,
            ))
        sc, vd, lvl, comp, mx, xs, ys, bx = (
            torch.cat(t, dim=1)[0] for t in zip(*rows)
        )
        top, order = stable_top_k(torch.where(vd, sc, -torch.inf), max_det)
        f32 = lambda t: t[order].to(torch.float32)
        return torch.cat(
            [
                top[:, None], f32(lvl)[:, None], f32(comp)[:, None],
                f32(mx), f32(xs), f32(ys), f32(bx).reshape(max_det, -1),
            ],
            dim=1,
        )

    # -- latent masks ------------------------------------------------------

    def _latent_masks(
        self,
        packed,
        plan,
        part_boxes: np.ndarray,
        overlap: float,
        fixed_mixtures: Optional[np.ndarray],
    ) -> List[np.ndarray]:
        """Per-bucket (S, Hr, Wr, F) bool masks reproducing detect.m's
        latent per-part response masking on the shared padded grid
        (cells beyond a scale's valid extent are already -inf-masked by
        the pipeline, so over-wide masks there are harmless). The JAX
        miner's masks, built in fewer passes."""
        spec = packed.spec
        nf = packed.filters.shape[0]
        part_boxes = np.asarray(part_boxes, dtype=np.float64)
        masks: List[np.ndarray] = []
        for bucket in plan.buckets:
            hr, wr = bucket.resp_h, bucket.resp_w
            # filter-major while it is built, so each filter's (S, Hr, Wr)
            # block is contiguous; one IoU test per part and filter size
            m = np.ones((nf, len(bucket.scale_indices), hr, wr), dtype=bool)
            for comp in packed.components:
                for p in range(comp.nparts):
                    windows: Dict[Tuple[int, int], np.ndarray] = {}
                    for k in range(int(comp.nmix[p])):
                        f = int(comp.filterid[p, k])
                        if fixed_mixtures is not None:
                            # detect.m:88-99 quirk: with fixed mixtures
                            # ONLY the mixture constraint applies
                            if k != int(fixed_mixtures[p]):
                                m[f] = False
                            continue
                        fsize = (int(comp.fsize[p, k, 0]), int(comp.fsize[p, k, 1]))
                        if fsize not in windows:
                            windows[fsize] = np.stack([
                                overlap_mask(
                                    (hr, wr),
                                    fsize,
                                    plan.scales[s].box_scale,
                                    spec.padx,
                                    spec.pady,
                                    part_boxes[p],
                                    overlap,
                                )
                                for s in bucket.scale_indices
                            ])
                        m[f] &= windows[fsize]
            masks.append(np.ascontiguousarray(np.moveaxis(m, 0, -1)))
        return masks

    # -- the detect_reference-shaped entry --------------------------------

    def detect(
        self,
        im: np.ndarray,
        thresh: float,
        part_boxes: Optional[np.ndarray] = None,
        overlap: float = 0.7,
        fixed_mixtures: Optional[np.ndarray] = None,
    ) -> List[dict]:
        """detect_reference-contract mining through the port's pipeline.

        Returns at most max_det detections (score-sorted; the QP writes
        only the top handful per image, train.m:100), or the single best
        constrained placement in latent mode (part_boxes given).
        """
        latent = part_boxes is not None
        if latent and not _filters_unique_per_part(self._model):
            # shared filters would entangle two parts' masks: the JAX
            # package's semantics hand this case to the reference, which
            # runs on the host
            from ..ops.reference_pipeline import detect_reference

            if self.device.type != "cpu":
                warnings.warn(
                    "TPUMiner: the model shares filters between parts, so "
                    "latent mining runs detect_reference on the host, not "
                    f"on {self.device}"
                )

            return detect_reference(
                im,
                self._model,
                thresh=thresh,
                part_boxes=part_boxes,
                overlap=overlap,
                fixed_mixtures=fixed_mixtures,
            )
        im = np.asarray(im)
        packed, plan, tabs = self._get_plan(im.shape[:2])
        dmodel = self._get_dmodel()
        if im.dtype != np.uint8:
            im = im.astype(np.float32, copy=False)
        dev_im = torch.as_tensor(im, device=self.device)[None]
        masks = None
        if latent:
            masks = [
                torch.as_tensor(m, device=self.device)
                for m in self._latent_masks(
                    packed, plan, part_boxes, overlap, fixed_mixtures
                )
            ]
        with torch.no_grad():
            out = self._mine(dev_im, packed, plan, tabs, dmodel, masks)
        out = out.cpu().numpy()
        p_max = packed.max_nparts
        dets: List[dict] = []
        for row in out:
            s = float(row[0])
            if not np.isfinite(s) or s < thresh:
                break  # the top-k rows are sorted descending
            c = int(row[2])
            pc = packed.components[c].nparts
            mx, xs, ys = (
                row[3 + j * p_max : 3 + j * p_max + pc].astype(np.int64)
                for j in range(3)
            )
            bx = row[3 + 3 * p_max :].reshape(p_max, 4)[:pc]
            dets.append(
                dict(
                    score=s,
                    component=c,
                    level=int(row[1]),
                    mixtures=mx,
                    xs=xs,
                    ys=ys,
                    boxes=bx.astype(np.float64),
                )
            )
        if latent:
            return dets[:1]
        return dets
