"""PartsBasedDetector: the public detect() API of the torch port.

Port of `partsbaseddetector_tpu/detector.py` for the f32 profile. API
as in the reference detector (include/PartsBasedDetector.hpp:167-175):
construct, distribute_model(), name, detect(image[, depth]) ->
candidates. One call runs, on the detector's device:

    HOG pyramid (matrix-product resampling + tent histograms)
      -> batched part-filter responses per bucket (CUDA kernel K2, or
         the Fourier engine: cuFFT around batched matrix products)
      -> -inf valid-extent masking (and, with a depth_gate and a depth
         map, the plausible-depth response gate)
      -> tree min-sum DP (2-D distance transforms: CUDA kernel K1, or
         the adaptive-window kernel K5 under PBD_DT_WINDOW=1)
      -> merged top-k backtracking (and, with device_depth_filter, the
         candidates' depth-consistency keep mask)

and only the final dense candidate tensors come back to the host. The
per-image-size plan (and the Fourier engine's filter spectra) is built
once and cached.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .models.model import Model, PackedModel, pack_model, to_device
from .ops.depth_device import component_tables, depth_keep_mask
from .ops.dp import backtrack, backtrack_merged, stable_top_k
from .pipeline import (
    depth_response_masks,
    fourier_spectra_args,
    make_plan,
    root_scores,
)
from .ops.pyramid import PyramidPlan
from .types import Candidate, DetectionResult
from .utils.profiling import validate_image

NEG_INF = -math.inf


def _depth_meters_host(depth: np.ndarray) -> np.ndarray:
    """A depth frame in metres for the host filter: uint16 frames are
    millimetres (the reference demo divides by 1000, src/demo.cpp:95-99),
    converted in f32 as on the device."""
    depth = np.asarray(depth)
    if depth.dtype == np.uint16:
        return depth.astype(np.float32) / 1000.0
    return depth


class PartsBasedDetector:
    """Flexible-mixtures-of-parts detector on torch.

    Args:
      model: canonical Model (optional; call distribute_model later).
      max_detections: per-image candidate budget.
      conv_engine: "spatial" (the K2 kernel) or "fourier" (FFT path, the
          intended FourierConvolutionEngine behaviour).
      border_mode: "matlab" (authoritative) or "cpp" (the C++ demo's
          same-size grids, one-padded borders, one-cell box offset).
      buckets_per_octave: >1 splits each octave into finer scale
          buckets (less padding waste); must divide the interval.
      depth_gate: a depth.DepthGate. With it, detect(im, depth) masks
          the response cells whose local depth is implausible for their
          scale before the DP (the intended filterResponseByDepth,
          src/SearchSpacePruning.cpp:47-70).
      device_depth_filter: run the candidate depth-consistency filter
          on the device (ops/depth_device.py) instead of on the host
          (depth.py, the exact reference and the default).
      device: where the pipeline runs ("cuda", "cuda:1", "cpu"). On a
          CUDA device the part-filter responses and the distance
          transforms run the hand-written kernels; on the CPU they run
          their plain torch versions.

    This is the f32 profile: constructing a detector turns off TF32 for
    both cuBLAS matmuls and cuDNN (`torch.backends.cuda.matmul.
    allow_tf32` and `torch.backends.cudnn.allow_tf32`, process-wide),
    because the reference computes at full f32 precision and TF32
    breaks its score parity.

    Options of the JAX detector that later slices port raise
    NotImplementedError: a dtype other than float32 (the bf16 profile),
    rerank_fp32 and nms_overlap.
    """

    def __init__(
        self,
        model: Optional[Model] = None,
        max_detections: int = 256,
        conv_engine: str = "spatial",
        dtype=torch.float32,
        nms_overlap: Optional[float] = None,
        border_mode: str = "matlab",
        buckets_per_octave: int = 1,
        depth_gate=None,
        device_depth_filter: bool = False,
        rerank_fp32: Optional[bool] = None,
        device="cpu",
    ):
        if conv_engine not in ("spatial", "fourier"):
            raise ValueError(f"unknown conv engine: {conv_engine}")
        if dtype not in (torch.float32, np.float32, "float32"):
            raise NotImplementedError(
                f"only the float32 profile is ported (got dtype={dtype})"
            )
        if rerank_fp32:
            raise NotImplementedError("the fp32 re-rank is not ported yet")
        if nms_overlap is not None:
            raise NotImplementedError("device part NMS is not ported yet")
        if border_mode not in ("matlab", "cpp"):
            raise ValueError(f"unknown border mode: {border_mode}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.device = torch.device(device)
        self.max_detections = int(max_detections)
        self.conv_engine = conv_engine
        self.border_mode = border_mode
        self.buckets_per_octave = int(buckets_per_octave)
        self.depth_gate = depth_gate
        self.device_depth_filter = bool(device_depth_filter)
        self._packed: Optional[PackedModel] = None
        self._dmodel = None
        self._depth_tables = None
        self._plans: Dict[Tuple[int, int], PyramidPlan] = {}
        self._spectra: Dict[Tuple[int, int], List[torch.Tensor]] = {}
        if model is not None:
            self.distribute_model(model)

    # -- reference API surface ------------------------------------------------

    def distribute_model(self, model: Model) -> None:
        """Pack the model, copy it to the device and reset the plan cache
        (ref: src/PartsBasedDetector.cpp:102-127)."""
        self._packed = pack_model(model, border=self.border_mode)
        self._dmodel = to_device(self._packed, self.device)
        self._depth_tables = tuple(
            torch.as_tensor(t, device=self.device)
            for t in component_tables(self._packed)
        )
        self._plans.clear()
        self._spectra.clear()

    @property
    def name(self) -> str:
        return self._packed.name if self._packed else ""

    def detect(
        self, im: np.ndarray, depth: Optional[np.ndarray] = None
    ) -> List[Candidate]:
        """Detect candidates in an (H, W, 3) image, best first.

        With a depth map ((H', W') metres, or uint16 millimetres) the
        candidates are also filtered for part depth consistency
        (src/SearchSpacePruning.cpp:73-95): on the host by default, or
        by the device keep mask with device_depth_filter. With a
        depth_gate, implausible-depth response cells are pruned on the
        device before the DP."""
        result = self.detect_dense(im, depth)
        if depth is not None and result.depth_keep is not None:
            result.valid = result.valid & result.depth_keep
            return result.to_candidates()
        candidates = result.to_candidates()
        if depth is not None:
            from .depth import filter_candidates_by_depth

            candidates = filter_candidates_by_depth(
                self._packed, candidates, _depth_meters_host(depth)
            )
        return candidates

    def detect_dense(
        self, im: np.ndarray, depth: Optional[np.ndarray] = None
    ) -> DetectionResult:
        """Run detection, returning dense padded arrays (host copies).
        The depth map is used here only with a depth_gate (response
        pruning) or device_depth_filter (depth_keep, the keep mask);
        the host candidate filter stays in detect()."""
        if self._packed is None:
            raise RuntimeError("distribute_model() must be called first")
        im = validate_image(im, min_side=5 * self._packed.spec.sbin)
        if im.dtype != np.uint8:
            im = im.astype(np.float32, copy=False)
        frame = torch.as_tensor(np.ascontiguousarray(im)).to(self.device)
        d_dev = None
        if depth is not None and (
            self.depth_gate is not None or self.device_depth_filter
        ):
            depth = np.asarray(depth)
            if depth.ndim != 2:
                raise ValueError(f"depth must be (H, W), got {depth.shape}")
            if depth.dtype != np.uint16:
                depth = depth.astype(np.float32, copy=False)
            # a uint16 frame travels as uint16 and becomes metres in f32
            # on the device, as _depth_meters_host does on the host
            d_dev = torch.as_tensor(np.ascontiguousarray(depth)).to(self.device)
            if depth.dtype == np.uint16:
                d_dev = d_dev.to(torch.float32) / 1000.0
        out = self._run(frame, d_dev)
        host = [t.cpu().numpy() for t in out]
        return DetectionResult(
            boxes=host[0],
            scores=host[1],
            components=host[2],
            valid=host[3],
            nparts_by_component=[c.nparts for c in self._packed.components],
            mixtures=host[4],
            depth_keep=host[5] if len(host) > 5 else None,
        )

    # -- internals --------------------------------------------------------------

    def _plan(self, imsize: Tuple[int, int]) -> PyramidPlan:
        key = (int(imsize[0]), int(imsize[1]))
        if key not in self._plans:
            self._plans[key] = make_plan(
                self._packed, key, self.buckets_per_octave
            )
        return self._plans[key]

    def _fft_spectra(self, imsize: Tuple[int, int]) -> List[torch.Tensor]:
        """The Fourier engine's filter spectra for one image size,
        uploaded once and kept with the plan."""
        key = (int(imsize[0]), int(imsize[1]))
        if key not in self._spectra:
            self._spectra[key] = [
                torch.as_tensor(sp, device=self.device)
                for sp in fourier_spectra_args(self._packed, self._plan(key))
            ]
        return self._spectra[key]

    def _run(self, im: torch.Tensor, depth: Optional[torch.Tensor] = None):
        packed, dmodel = self._packed, self._dmodel
        spec = packed.spec
        plan = self._plan(im.shape[:2])
        max_det = self.max_detections
        p_max = packed.max_nparts
        dev = self.device
        rmasks = None
        if depth is not None and self.depth_gate is not None:
            rmasks = depth_response_masks(depth, plan, spec, self.depth_gate)
        scores = root_scores(
            im, packed, dmodel, plan, engine=self.conv_engine,
            response_masks=rmasks,
            fft_spectra=(
                self._fft_spectra(im.shape[:2])
                if self.conv_engine == "fourier" else None
            ),
        )

        # box origin: MATLAB subtracts the virtual padding; the C++ demo
        # subtracts one cell (DynamicProgram.cpp:239)
        off_x = -1 if spec.border == "cpp" else -spec.padx
        off_y = -1 if spec.border == "cpp" else -spec.pady
        bscale = lambda b: torch.as_tensor(
            [plan.scales[s].box_scale for s in plan.buckets[b].scale_indices],
            dtype=torch.float32, device=dev,
        )
        kw = dict(
            box_off_x=off_x, box_off_y=off_y, thresh=spec.thresh,
            max_det=max_det,
        )
        outs = []  # (boxes, scores, mixtures, valid, component) per call
        # merged tail for components with all parts on the root grid:
        # one top-k and one walk across all their buckets
        by_comp: Dict[int, list] = {}
        for bs in scores:
            by_comp.setdefault(bs.component, []).append(bs)
        merged = [c for c in sorted(by_comp) if packed.components[c].max_ds == 0]
        for c in merged:
            lst = sorted(by_comp[c], key=lambda bs: bs.bucket_index)
            bx, sc, mx, vd, _ = backtrack_merged(
                [bs.rootv for bs in lst],
                [bs.rooti for bs in lst],
                [bs.tables for bs in lst],
                packed.components[c], dmodel.components[c],
                [bscale(bs.bucket_index) for bs in lst],
                **kw,
            )
            outs.append((bx, sc, mx, vd, c))
        # octave-offset components: the per-bucket walk
        for bs in scores:
            c = bs.component
            if c not in merged:
                bx, sc, mx, vd, _ = backtrack(
                    bs.rootv, bs.rooti, bs.tables,
                    packed.components[c], dmodel.components[c],
                    bscale(bs.bucket_index), **kw,
                )
                outs.append((bx, sc, mx, vd, c))

        boxes_l, scores_l, mix_l, valid_l, comp_l = [], [], [], [], []
        for bx, sc, mx, vd, c in outs:
            pc = packed.components[c].nparts
            if pc < p_max:
                # pad the part axis by replicating the root box (keeps
                # bounding boxes unaffected by padding)
                rep = bx[:, :1].expand(bx.shape[0], p_max - pc, 4)
                bx = torch.cat([bx, rep], dim=1)
                mx = torch.nn.functional.pad(mx, (0, p_max - pc))
            boxes_l.append(bx)
            scores_l.append(sc)
            mix_l.append(mx)
            valid_l.append(vd)
            comp_l.append(torch.full(sc.shape, c, dtype=torch.int32, device=dev))
        boxes = torch.cat(boxes_l)
        scores_all = torch.cat(scores_l)
        mixtures = torch.cat(mix_l)
        valid = torch.cat(valid_l)
        comps = torch.cat(comp_l)

        masked = torch.where(valid, scores_all, NEG_INF)
        top, order = stable_top_k(masked, max_det)
        out = (
            boxes[order], top, comps[order], top > NEG_INF, mixtures[order],
        )
        if depth is not None and self.device_depth_filter:
            out += (depth_keep_mask(depth, out[0], out[2], *self._depth_tables),)
        return out
