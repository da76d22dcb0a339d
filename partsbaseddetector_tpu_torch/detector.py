"""PartsBasedDetector: the public detect and serving APIs of the torch port.

Port of `partsbaseddetector_tpu/detector.py`: the f32 profile and the
hybrid bf16 + fp32-rescore profile. API as in the reference detector
(include/PartsBasedDetector.hpp:167-175): construct, distribute_model(),
name, detect(image[, depth]) -> candidates, plus the JAX package's
serving APIs: detect_batch, detect_many, detect_stream, detect_fn and
detect_batch_fn. One program
runs, on the detector's device, over one frame or a batch of frames:

    HOG pyramid (matrix-product resampling + tent histograms)
      -> batched part-filter responses per bucket (CUDA kernel K2, or
         the Fourier engine: cuFFT around batched matrix products)
      -> -inf valid-extent masking (and, with a depth_gate and a depth
         map, the plausible-depth response gate)
      -> tree min-sum DP (2-D distance transforms: CUDA kernel K1, or
         the adaptive-window kernel K5 under PBD_DT_WINDOW=1, with the
         x pass's transposes on the T2 kernel)
      -> merged top-k backtracking per image (in the hybrid profile, then
         the f32 re-score and re-rank of the top-k, ops/rescore.py;
         optionally the part-aware NMS keep mask, and with
         device_depth_filter the candidates' depth-consistency keep mask)

and only the final dense candidate tensors come back to the host. The
per-image-size plan (and the Fourier engine's filter spectra) is built
once and cached.

Serving on the card: frames go up from pinned host memory on a copy
stream of their own, which the compute stream waits for on an event;
outputs are packed on the device into one (k, M) f32 buffer per group
of frames and come back with one non-blocking copy into pinned host
memory and one event wait. On the CPU the same code runs without
streams and without pinned memory, because the caller asked for the
CPU.
"""

from __future__ import annotations

import math
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from itertools import islice
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .models.model import Model, PackedModel, pack_model, to_device
from .ops.depth_device import component_tables, depth_keep_mask
from .ops.dp import backtrack, backtrack_merged, stable_top_k
from .ops.nms import part_nms_device
from .ops.rescore import build_rescore_tables, rescore_from_responses, tables_on
from .pipeline import (
    depth_response_masks,
    fourier_spectra_args,
    make_plan,
    root_scores,
)
from .ops.pyramid import PyramidPlan
from .types import Candidate, DetectionResult
from .utils.device import resolve_device
from .utils.profiling import validate_image

NEG_INF = -math.inf
# frames per packed readback group (detect_batch, the pipelined path)
PACK = 8


def _depth_meters_host(depth: np.ndarray) -> np.ndarray:
    """A depth frame in metres for the host filter: uint16 frames are
    millimetres (the reference demo divides by 1000, src/demo.cpp:95-99),
    converted in f32 as on the device."""
    depth = np.asarray(depth)
    if depth.dtype == np.uint16:
        return depth.astype(np.float32) / 1000.0
    return depth


def _wire_image(im: np.ndarray) -> np.ndarray:
    """A validated frame as it travels: uint8 stays uint8 (cast to f32 on
    the device, exactly), any other type becomes f32."""
    return im if im.dtype == np.uint8 else im.astype(np.float32, copy=False)


class _Transfer(NamedTuple):
    """A copy in flight: the destination tensor, the pinned host buffer
    the copy reads or writes (kept referenced until the copy is done)
    and the event recorded after it (None on the CPU)."""

    tensor: torch.Tensor
    pinned: Optional[torch.Tensor]
    done: Optional[torch.cuda.Event]


class PartsBasedDetector:
    """Flexible-mixtures-of-parts detector on torch.

    Args:
      model: canonical Model (optional; call distribute_model later).
      max_detections: per-image candidate budget.
      conv_engine: "spatial" (the K2 kernel) or "fourier" (FFT path, the
          intended FourierConvolutionEngine behaviour).
      nms_overlap: with a value, the part-aware NMS (detection/nms.m,
          ops/nms.py::part_nms_device) runs on the device after the
          top-k and its keep mask is ANDed into `valid`.
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
      device: where the pipeline runs ("cuda", the default, "cuda:1",
          "cpu"). On a CUDA device the part-filter responses, the
          distance transforms and their transposes run the hand-written
          kernels; on the CPU they run their plain torch versions. A
          CUDA device on a machine without one raises RuntimeError.

      dtype: the DP's dtype: torch.float32 (the default, reference
          parity) or torch.bfloat16, the hybrid serving profile. There
          HOG and the conv run in f32 (K2), the responses are cast to
          bf16 for the masking and the tree DP, whose distance transforms
          widen their sources to f32 (the JAX package's Pallas route, on
          the card and on the CPU alike), and the top max_detections
          placements by raw DP score are re-scored from the f32
          responses, their boxes rebuilt in f32, re-sorted by that score
          (stable: ties keep the DP's order) and thresholded
          (ops/rescore.py). Scores and boxes are f32 reconstructions;
          which placements are found may differ from the f32 profile at
          near-ties.
      rerank_fp32: the f32 re-score and re-rank; default on for bf16,
          off for f32 (where it reproduces the DP's scores).

    Constructing a detector turns off TF32 for both cuBLAS matmuls and
    cuDNN (`torch.backends.cuda.matmul.allow_tf32` and
    `torch.backends.cudnn.allow_tf32`, process-wide), because the
    reference computes at full f32 precision and TF32 breaks its score
    parity.

    Options of the JAX detector that are not ported raise
    NotImplementedError: a dtype other than float32 and bfloat16, and
    bfloat16 with rerank_fp32=False (the JAX package then runs HOG and
    the conv in bf16 through lax.conv).
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
        device="cuda",
    ):
        if conv_engine not in ("spatial", "fourier"):
            raise ValueError(f"unknown conv engine: {conv_engine}")
        if dtype in (torch.float32, np.float32, "float32"):
            dtype = torch.float32
        elif dtype in (torch.bfloat16, "bfloat16"):
            dtype = torch.bfloat16
        else:
            raise NotImplementedError(
                f"the float32 and bfloat16 profiles are ported (got {dtype})"
            )
        if rerank_fp32 is None:
            rerank_fp32 = dtype != torch.float32
        if dtype == torch.bfloat16 and not rerank_fp32:
            raise NotImplementedError(
                "bfloat16 without the fp32 re-rank (HOG and the conv in "
                "bf16) is not ported"
            )
        if border_mode not in ("matlab", "cpp"):
            raise ValueError(f"unknown border mode: {border_mode}")
        self.device = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.dtype = dtype
        self.rerank_fp32 = bool(rerank_fp32)
        self.max_detections = int(max_detections)
        self.conv_engine = conv_engine
        self.nms_overlap = None if nms_overlap is None else float(nms_overlap)
        self.border_mode = border_mode
        self.buckets_per_octave = int(buckets_per_octave)
        self.depth_gate = depth_gate
        self.device_depth_filter = bool(device_depth_filter)
        self._packed: Optional[PackedModel] = None
        self._dmodel = None
        self._depth_tables = None
        self._plans: Dict[Tuple[int, int], PyramidPlan] = {}
        self._spectra: Dict[Tuple[int, int], List[torch.Tensor]] = {}
        self._rtables: Dict[Tuple[int, int], object] = {}
        # uploads run on a stream of their own (the card only)
        self._copy_stream = (
            torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        )
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
        self._rtables.clear()

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
        the host candidate filter stays in detect(). The outputs come
        back packed, in one copy."""
        out = self._run(*self._inputs(self._validate(im), depth))
        wk = len(out) > 5
        row = self._wait(self._readback(self._packer([out], wk)))[0]
        boxes, scores, comps, valid, mixtures, keep = self._unpack_host(row, wk)
        return DetectionResult(
            boxes=boxes,
            scores=scores,
            components=comps,
            valid=valid,
            nparts_by_component=[c.nparts for c in self._packed.components],
            mixtures=mixtures,
            depth_keep=keep,
        )

    # -- serving APIs -----------------------------------------------------------

    def detect_fn(self, imsize: Tuple[int, int]):
        """The single-frame program for one image size: a callable from
        one (H, W, 3) frame on the detector's device (any real dtype) to
        the five device outputs (boxes (D, P, 4), scores (D,),
        components (D,), valid (D,), mixtures (D, P)), best first. It
        returns as soon as the work is queued: no host sync."""
        key = self._imsize(imsize)

        def fn(im: torch.Tensor):
            if tuple(im.shape) != (*key, 3):
                raise ValueError(f"expected a {key} frame, got {tuple(im.shape)}")
            return tuple(t[0] for t in self._run(im[None]))

        return fn

    def detect_batch_fn(self, imsize: Tuple[int, int], batch: int):
        """The fused batched program: one run of the whole pipeline over
        a (batch, H, W, 3) stack on the device (the JAX package's vmap of
        the single-frame program): shared bucket plans, the conv and DT
        kernels over every image's maps in one launch each, one top-k
        per image. Returns the five outputs with a leading image axis,
        without a host sync. Under the Fourier engine it uses the
        spectra cached for the image size. The batch is bounded by
        device memory: large request lists stream through microbatches
        of this program (detect_many)."""
        key = self._imsize(imsize)
        batch = int(batch)

        def fn(ims: torch.Tensor):
            if tuple(ims.shape) != (batch, *key, 3):
                raise ValueError(
                    f"expected a ({batch}, {key[0]}, {key[1]}, 3) stack, "
                    f"got {tuple(ims.shape)}"
                )
            return self._run(ims)

        return fn

    def detect_batch(self, images) -> List[List[Candidate]]:
        """Throughput API: queue every image's program without waiting,
        pack the outputs on the device in groups of PACK frames, read
        each group back with one copy, and synchronise once. Images may
        differ in size (one plan per size)."""
        outs = [self._run(*self._inputs(self._validate(im))) for im in images]
        reads = [
            (self._readback(self._packer(outs[i : i + PACK])),
             len(outs[i : i + PACK]))
            for i in range(0, len(outs), PACK)
        ]
        return self._collect(reads)

    def detect_many(
        self,
        images,
        microbatch: int = 1,
        readback_top: Optional[int] = None,
        prefetch: int = 0,
    ) -> List[List[Candidate]]:
        """High-throughput batch API over same-shape images.

        microbatch=1 (default) queues the single-frame program per image
        (detect_batch); with prefetch>0 or readback_top it takes the
        pipelined path, where a worker thread stages the uploads
        `prefetch` frames ahead of dispatch and each frame's readback
        is cut to its best `readback_top` valid candidates (score order
        kept). microbatch>1 runs detect_batch_fn's fused program over
        stacks of `microbatch` frames, padding the request list with its
        last image."""
        if len(images) == 0:
            return []
        if microbatch == 1:
            if prefetch > 0 or readback_top is not None:
                return self._detect_many_pipelined(
                    images, readback_top, max(prefetch, 1)
                )
            return self.detect_batch(images)
        if prefetch > 0 or readback_top is not None:
            raise ValueError(
                "readback_top/prefetch belong to the microbatch=1 "
                "pipelined path; the fused batched path (microbatch>1) "
                "reads full outputs"
            )
        imgs = self._same_shape([self._validate(im) for im in images])
        n = len(imgs)
        imgs += [imgs[-1]] * ((-n) % microbatch)
        fn = self.detect_batch_fn(imgs[0].shape[:2], microbatch)
        reads = []
        for i in range(0, len(imgs), microbatch):
            stack = self._to_device(np.stack(imgs[i : i + microbatch]))
            reads.append((self._readback(self._packer([fn(stack)])), microbatch))
        return self._collect(reads)[:n]

    def detect_stream(
        self,
        frames,
        lookahead: int = 2,
        workers: int = 1,
        readback_batch: int = 1,
    ):
        """Pipelined streaming serving: yields List[Candidate] per frame.

        frames: iterable of rgb or (rgb, depth) pairs. Keeps up to
        `lookahead` frames' programs in flight, so uploads, device
        compute and host post-processing (readback, the host depth
        filter, candidate assembly) overlap. workers=N runs readback and
        post-processing on N threads (chunks finish concurrently; output
        order is kept); workers=0 runs them inline. readback_batch packs
        that many frames per readback; readback_batch>1 raises the
        lookahead to 2k, so that a full chunk can form while another
        reads back. With readback_batch=1 the caller's lookahead is
        honoured exactly (0 is fully synchronous). A chunk never mixes
        gated frames (6 outputs, with the device keep mask) and plain
        ones (5)."""
        pend = deque()  # (frames, future or payload) per chunk
        buf = []  # (outputs, depth) of frames not yet in a chunk
        ready = deque()  # per-frame results of finished chunks

        def finish_chunk(payload):
            read, depths, wk = payload
            return self._rows_to_candidates(self._wait(read), depths, wk)

        pool = ThreadPoolExecutor(max_workers=workers) if workers else None

        def flush_buf():
            if buf:
                chunk = list(buf)
                buf.clear()
                outs = [o for o, _ in chunk]
                wk = len(outs[0]) > 5
                payload = (
                    self._readback(self._packer(outs, wk)),
                    [d for _, d in chunk],
                    wk,
                )
                pend.append(
                    (len(chunk),
                     pool.submit(finish_chunk, payload) if pool else payload)
                )

        def pop_chunk():
            _, payload = pend.popleft()
            return payload.result() if pool else finish_chunk(payload)

        def in_flight():
            return len(buf) + sum(n for n, _ in pend)

        if readback_batch > 1:
            lookahead = max(lookahead, 2 * readback_batch)
        try:
            for frame in frames:
                rgb, depth = frame if isinstance(frame, tuple) else (frame, None)
                out = self._run(*self._inputs(self._validate(rgb), depth))
                if buf and len(buf[-1][0]) != len(out):
                    flush_buf()
                buf.append((out, depth))
                if len(buf) >= readback_batch:
                    flush_buf()
                while in_flight() > lookahead:
                    if not pend:
                        flush_buf()
                    ready.extend(pop_chunk())
                while ready:
                    yield ready.popleft()
            flush_buf()
            while pend:
                ready.extend(pop_chunk())
            while ready:
                yield ready.popleft()
        finally:
            if pool:
                pool.shutdown(wait=False)

    def _detect_many_pipelined(
        self, images, readback_top: Optional[int], prefetch: int
    ) -> List[List[Candidate]]:
        """The microbatch=1 serving loop: ONE uploader thread keeps
        `prefetch` uploads (pinned staging and the copy on the copy
        stream) in flight ahead of dispatch, outputs pack on the device
        in groups of PACK (cut to readback_top), and each group comes
        back with one copy."""
        top = self._norm_top(readback_top)
        imgs = self._same_shape([self._validate(im) for im in images])
        pool = ThreadPoolExecutor(max_workers=1)
        todo = iter(imgs)
        futs = deque(
            pool.submit(self._upload, im) for im in islice(todo, prefetch)
        )
        outs: List = []
        reads = []
        try:
            while futs:
                frame = self._arrived(futs.popleft().result())
                im = next(todo, None)
                if im is not None:
                    futs.append(pool.submit(self._upload, im))
                outs.append(self._run(frame[None]))
                if len(outs) == PACK:
                    reads.append((self._readback(self._packer(outs, top=top)), PACK))
                    outs = []
            if outs:
                reads.append(
                    (self._readback(self._packer(outs, top=top)), len(outs))
                )
        finally:
            pool.shutdown(wait=False)
        return self._collect(reads, top=top)

    # -- uploads and readback -----------------------------------------------

    def _upload(self, arr: np.ndarray) -> _Transfer:
        """Start one host array's copy to the device. On the card the
        array is staged in pinned host memory and copied on the
        detector's copy stream, with an event recorded behind the copy;
        `_arrived` makes the consuming stream wait for it. The pinned
        buffer stays referenced by the transfer (and torch's pinned
        allocator does not reuse it before the copy's event), so it
        outlives the copy. May run on a worker thread."""
        host = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return _Transfer(host.to(self.device), None, None)
        with torch.cuda.device(self.device):
            pinned = host.pin_memory()
            with torch.cuda.stream(self._copy_stream):
                dev = pinned.to(self.device, non_blocking=True)
                done = torch.cuda.Event()
                done.record(self._copy_stream)
        return _Transfer(dev, pinned, done)

    def _arrived(self, up: _Transfer) -> torch.Tensor:
        """The uploaded tensor, usable on the current stream: the stream
        waits for the copy's event, and the tensor (allocated on the
        copy stream) is recorded as used on it, so the caching
        allocator does not hand its memory out again before the
        compute that reads it is done."""
        if up.done is None:
            return up.tensor
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(up.done)
        up.tensor.record_stream(compute)
        return up.tensor

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return self._arrived(self._upload(arr))

    def _readback(self, buf: torch.Tensor) -> _Transfer:
        """Start one packed buffer's copy to the host: on the card one
        non-blocking copy into pinned host memory, with an event behind
        it; on the CPU the buffer itself."""
        if buf.device.type != "cuda":
            return _Transfer(buf, None, None)
        pinned = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
        pinned.copy_(buf, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(buf.device))
        return _Transfer(pinned, pinned, done)

    @staticmethod
    def _wait(read: _Transfer) -> np.ndarray:
        if read.done is not None:
            read.done.synchronize()
        return read.tensor.numpy()

    def _collect(self, reads, top: Optional[int] = None) -> List[List[Candidate]]:
        """Candidates of readbacks (transfer, frames) issued in order on
        one stream: one wait, on the last, then host assembly."""
        if reads:
            self._wait(reads[-1][0])
        results: List[List[Candidate]] = []
        for read, n in reads:
            results.extend(
                self._rows_to_candidates(self._wait(read), [None] * n, top=top)
            )
        return results

    # -- packed readback -------------------------------------------------------

    def _packer(
        self, outs, with_keep: bool = False, top: Optional[int] = None
    ) -> torch.Tensor:
        """Device-side output packer: a list of program outputs, each
        with a leading image axis, -> ONE (k, M) float32 tensor for
        their k frames, so that a group comes back in one copy. Int
        leaves travel bit-cast to f32 (exact), bools as 0/1. top
        (optional) first cuts each frame to its best `top` rows: a
        stable partition puts the valid rows first (device NMS clears
        rows in place, so valid rows need not form a prefix), keeping
        score order. _unpack_host is the inverse."""
        top = self._norm_top(top)
        o = tuple(torch.cat(leaf) for leaf in zip(*outs))
        k = o[0].shape[0]
        if top is not None:
            order = torch.argsort((~o[3]).to(torch.int32), dim=1, stable=True)
            rows = torch.arange(k, device=order.device)[:, None]
            o = tuple(x[rows, order[:, :top]] for x in o)
        parts = [
            o[0].reshape(k, -1).to(torch.float32),  # boxes
            o[1].to(torch.float32),  # scores
            o[2].to(torch.int32).view(torch.float32),  # components
            o[3].to(torch.float32),  # valid
            o[4].to(torch.int32).view(torch.float32).reshape(k, -1),  # mixtures
        ]
        if with_keep:
            parts.append(o[5].to(torch.float32))
        return torch.cat(parts, dim=1)

    def _rows_to_candidates(
        self,
        host: np.ndarray,
        depths,
        wk: bool = False,
        top: Optional[int] = None,
    ) -> List[List[Candidate]]:
        """Shared packed-row assembly: unpack each frame's row, apply
        the device keep mask (gated programs) or the host depth filter
        (ungated frames that carried a depth map), and build the
        candidate lists. depths: per-frame depth map or None."""
        nbc = [c.nparts for c in self._packed.components]
        results: List[List[Candidate]] = []
        for j, depth in enumerate(depths):
            bx, sc, cp, vd, mx, keep = self._unpack_host(host[j], wk, top)
            if keep is not None:
                vd = vd & keep
            cands = DetectionResult(
                boxes=bx,
                scores=sc,
                components=cp,
                valid=vd,
                nparts_by_component=nbc,
                mixtures=mx,
            ).to_candidates()
            if depth is not None and not wk:
                from .depth import filter_candidates_by_depth

                cands = filter_candidates_by_depth(
                    self._packed, cands, _depth_meters_host(depth)
                )
            results.append(cands)
        return results

    def _norm_top(self, top: Optional[int]) -> Optional[int]:
        """Clamp a readback truncation to the program's candidate
        budget; asking for >= max_detections is the full readback
        (slicing beyond D would shrink the packed rows and desync
        _unpack_host's offsets)."""
        if top is None:
            return None
        top = int(top)
        if top <= 0:
            raise ValueError(f"readback_top must be positive, got {top}")
        top = min(top, self.max_detections)
        return None if top == self.max_detections else top

    def _unpack_host(
        self,
        row: np.ndarray,
        with_keep: bool = False,
        top: Optional[int] = None,
    ):
        """Inverse of _packer for one frame's packed row."""
        top = self._norm_top(top)
        d = self.max_detections if top is None else top
        p = self._packed.max_nparts
        nb, ns = d * p * 4, d
        off = 0
        bx = row[off : off + nb].reshape(d, p, 4)
        off += nb
        sc = row[off : off + ns]
        off += ns
        cp = row[off : off + ns].view(np.int32)
        off += ns
        vd = row[off : off + ns] != 0.0
        off += ns
        mx = row[off : off + d * p].view(np.int32).reshape(d, p)
        off += d * p
        keep = None
        if with_keep:
            keep = row[off : off + ns] != 0.0
        return bx, sc, cp, vd, mx, keep

    # -- internals --------------------------------------------------------------

    def _validate(self, im) -> np.ndarray:
        if self._packed is None:
            raise RuntimeError("distribute_model() must be called first")
        return validate_image(im, min_side=5 * self._packed.spec.sbin)

    def _imsize(self, imsize) -> Tuple[int, int]:
        if self._packed is None:
            raise RuntimeError("distribute_model() must be called first")
        key = (int(imsize[0]), int(imsize[1]))
        self._plan(key)
        return key

    @staticmethod
    def _same_shape(imgs: List[np.ndarray]) -> List[np.ndarray]:
        if any(im.shape[:2] != imgs[0].shape[:2] for im in imgs):
            raise ValueError(
                "detect_many's pipelined and batched paths need same-shape "
                "images (one plan); mixed shapes go through detect_batch"
            )
        return [_wire_image(im) for im in imgs]

    def _inputs(self, im: np.ndarray, depth: Optional[np.ndarray] = None):
        """One validated frame on the device as a batch of one, and its
        depth map when the gate or the device filter reads it, in the
        detector's dtype (as the JAX package casts it): uint16
        millimetres travel as uint16 and become metres on the device, as
        _depth_meters_host does on the host."""
        frame = self._to_device(_wire_image(im))[None]
        if depth is None or not (
            self.depth_gate is not None or self.device_depth_filter
        ):
            return frame, None
        depth = np.asarray(depth)
        if depth.ndim != 2:
            raise ValueError(f"depth must be (H, W), got {depth.shape}")
        if depth.dtype != np.uint16:
            depth = depth.astype(np.float32, copy=False)
        d_dev = self._to_device(depth).to(self.dtype)
        if depth.dtype == np.uint16:
            d_dev = d_dev / 1000.0
        return frame, d_dev

    def _plan(self, imsize: Tuple[int, int]) -> PyramidPlan:
        key = (int(imsize[0]), int(imsize[1]))
        if key not in self._plans:
            self._plans[key] = make_plan(
                self._packed, key, self.buckets_per_octave
            )
        return self._plans[key]

    def _rescore_tables(self, imsize: Tuple[int, int]):
        """The re-score's tables for one image size, on the device."""
        key = (int(imsize[0]), int(imsize[1]))
        if key not in self._rtables:
            self._rtables[key] = tables_on(
                build_rescore_tables(
                    self._packed, self._plan(key), self.buckets_per_octave
                ),
                self.device,
            )
        return self._rtables[key]

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

    def _run(self, ims: torch.Tensor, depth: Optional[torch.Tensor] = None):
        """The program over (B, H, W, 3) frames on the device: (boxes
        (B, D, P, 4), scores (B, D), components (B, D) int32, valid
        (B, D), mixtures (B, D, P) int32), each image's rows best first,
        plus depth_keep (B, D) with a depth map and device_depth_filter.
        A depth map ((H', W') metres in the detector's dtype) belongs to
        a batch of one."""
        packed, dmodel = self._packed, self._dmodel
        spec = packed.spec
        imsize = tuple(ims.shape[1:3])
        plan = self._plan(imsize)
        nimg = ims.shape[0]
        max_det = self.max_detections
        p_max = packed.max_nparts
        dev = self.device
        rerank = self.rerank_fp32
        rmasks = None
        if depth is not None and self.depth_gate is not None:
            rmasks = depth_response_masks(
                depth, plan, spec, self.depth_gate, self.dtype
            )
        # the hybrid profile: HOG and the conv in f32, the DP in
        # self.dtype, and the f32 re-score gathers one response scalar
        # per (candidate, part) from the raw f32 responses
        resps32: Optional[List[torch.Tensor]] = [] if rerank else None
        scores = root_scores(
            ims, packed, dmodel, plan, engine=self.conv_engine,
            response_masks=rmasks,
            fft_spectra=(
                self._fft_spectra(imsize)
                if self.conv_engine == "fourier" else None
            ),
            dtype=self.dtype,
            collect_responses=resps32,
        )

        # box origin: MATLAB subtracts the virtual padding; the C++ demo
        # subtracts one cell (DynamicProgram.cpp:239)
        off_x = -1 if spec.border == "cpp" else -spec.padx
        off_y = -1 if spec.border == "cpp" else -spec.pady
        bscale = lambda b: torch.as_tensor(
            [plan.scales[s].box_scale for s in plan.buckets[b].scale_indices],
            dtype=self.dtype, device=dev,
        )
        kw = dict(
            box_off_x=off_x, box_off_y=off_y, thresh=spec.thresh,
            max_det=max_det,
        )
        outs = []  # (boxes, scores, mixtures, valid, component) per call
        coords = []  # (bucket, scale, xs, ys) per call, for the re-score
        # merged tail for components with all parts on the root grid:
        # one top-k per image and one walk across all their buckets
        by_comp: Dict[int, list] = {}
        for bs in scores:
            by_comp.setdefault(bs.component, []).append(bs)
        merged = [c for c in sorted(by_comp) if packed.components[c].max_ds == 0]
        for c in merged:
            lst = sorted(by_comp[c], key=lambda bs: bs.bucket_index)
            bx, sc, mx, vd, (bid, si, xs, ys) = backtrack_merged(
                [bs.rootv for bs in lst],
                [bs.rooti for bs in lst],
                [bs.tables for bs in lst],
                packed.components[c], dmodel.components[c],
                [bscale(bs.bucket_index) for bs in lst],
                **kw,
            )
            outs.append((bx, sc, mx, vd, c))
            # a merged component scores every bucket, so the walk's index
            # into its list is the plan's bucket index
            coords.append((bid, si, xs, ys))
        # octave-offset components: the per-bucket walk
        for bs in scores:
            c = bs.component
            if c not in merged:
                bx, sc, mx, vd, (si, xs, ys) = backtrack(
                    bs.rootv, bs.rooti, bs.tables,
                    packed.components[c], dmodel.components[c],
                    bscale(bs.bucket_index), **kw,
                )
                outs.append((bx, sc, mx, vd, c))
                coords.append((torch.full_like(si, bs.bucket_index), si, xs, ys))

        boxes_l, scores_l, mix_l, valid_l, comp_l = [], [], [], [], []
        for i, (bx, sc, mx, vd, c) in enumerate(outs):
            pc = packed.components[c].nparts
            if pc < p_max:
                # pad the part axis by replicating the root box (keeps
                # union-box NMS and bounding boxes unaffected by padding);
                # the re-score's partmask kills the padded coordinates
                rep = bx[:, :, :1].expand(nimg, bx.shape[1], p_max - pc, 4)
                bx = torch.cat([bx, rep], dim=2)
                mx = F.pad(mx, (0, p_max - pc))
                bid, si, xs, ys = coords[i]
                coords[i] = (bid, si, F.pad(xs, (0, p_max - pc)),
                             F.pad(ys, (0, p_max - pc)))
            boxes_l.append(bx)
            scores_l.append(sc)
            mix_l.append(mx)
            valid_l.append(vd)
            comp_l.append(torch.full(sc.shape, c, dtype=torch.int32, device=dev))
        boxes = torch.cat(boxes_l, dim=1)
        scores_all = torch.cat(scores_l, dim=1)
        mixtures = torch.cat(mix_l, dim=1)
        valid = torch.cat(valid_l, dim=1)
        comps = torch.cat(comp_l, dim=1)

        rows = torch.arange(nimg, device=dev)[:, None]
        if rerank:
            # select by RAW DP score: the threshold moves to the f32
            # score (a candidate just below it in bf16 may be above it in
            # f32). isfinite(top) marks real placements because this
            # path runs root_scores with params=None, whose masking value
            # is -inf; a caller with trainable params would have to
            # carry the backtracks' valid flags here instead.
            top, order = stable_top_k(scores_all, max_det)
            real = torch.isfinite(top)
            bid, si, xs, ys = (
                torch.cat(leaf, dim=1)[rows, order] for leaf in zip(*coords)
            )
            sc32, bx32 = rescore_from_responses(
                resps32, self._rescore_tables(imsize), comps[rows, order],
                bid, si, xs, ys, mixtures[rows, order],
                box_off_x=off_x, box_off_y=off_y,
            )
            sc32 = torch.where(real, sc32, NEG_INF)
            # stable: ties keep the DP's order
            top, ord2 = torch.sort(sc32, dim=1, descending=True, stable=True)
            order = torch.gather(order, 1, ord2)
            out_boxes = bx32[rows, ord2]
            out_valid = top >= spec.thresh
        else:
            masked = torch.where(valid, scores_all, NEG_INF)
            top, order = stable_top_k(masked, max_det)
            out_boxes = boxes[rows, order]
            out_valid = top > NEG_INF
        if self.nms_overlap is not None:
            keep = part_nms_device(out_boxes, top, out_valid, self.nms_overlap)
            out_valid = out_valid & keep
        out = (
            out_boxes, top, comps[rows, order], out_valid, mixtures[rows, order],
        )
        if depth is not None and self.device_depth_filter:
            keep = depth_keep_mask(depth, out[0][0], out[2][0], *self._depth_tables)
            out += (keep[None],)
        return out
