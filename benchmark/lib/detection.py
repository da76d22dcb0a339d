"""The detector behind a closed loop: what the traffic clients of
benchmark/clients/ that call the detector share.

A request starts from host uint8 frames and ends with the candidate
lists on the host: upload, run, readback and candidate assembly count.
Every answer is kept by frame; after the window, `compare_frames`
frames of the pool, drawn from the seed, are run through the reference
and every answer of theirs is compared (lib/compare.py).

Parameters every detector mix has:

    pool             distinct uint8 frames made from the seed
    compare_frames   frames whose every answer in the window is compared
    warm_requests    untimed requests of the window's own shapes first
"""

from __future__ import annotations

import random
from typing import Dict, List, Tuple

import torch

from . import compare, inputs, loop, port, spec

KEYS = {"pool", "compare_frames", "warm_requests"}


class Client(loop.ClosedLoop):
    """Subclasses give call() -> [(frame index, candidates)] of one
    request, traced_request() and warm_call()."""

    def __init__(self, params: dict, cfg: dict, arrays: dict, g: torch.Generator, device,
                 overrides: dict):
        self.p = params
        self.cfg = cfg
        self.arrays = arrays
        self.device = device
        self.frames = inputs.frames(cfg, params["pool"], g, device)
        self.det = port.detector(cfg, arrays, device, **overrides)
        self.answers: Dict[int, List[list]] = {}
        self.next = 0

    def call(self) -> List[Tuple[int, list]]:
        raise NotImplementedError

    def warm_call(self) -> None:
        raise NotImplementedError

    def request(self) -> int:
        got = self.call()
        for i, cands in got:
            self.answers.setdefault(i, []).append(cands)
        return len(got)

    def warm(self) -> None:
        """The first builds the kernel library and the pyramid plan."""
        for _ in range(self.p["warm_requests"]):
            self.warm_call()

    def close(self) -> None:
        del self.det

    def readings(self, ref, rng: random.Random) -> List[Dict[str, float]]:
        """Every answer of the sampled frames against the reference (an
        answer equal to one already compared reads the same numbers)."""
        sample = rng.sample(sorted(self.answers),
                            min(self.p["compare_frames"], len(self.answers)))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg = self.cfg
        model = ref.model_from_arrays(self.arrays, cfg["interval"], cfg["sbin"], cfg["thresh"],
                                      pyramid=spec.pyramid(cfg))
        out = []
        with torch.no_grad():
            for j in sample:
                det = ref.detect(torch.as_tensor(self.frames[j], device=self.device), model)
                seen = {}
                for cands in self.answers[j]:
                    key = compare.answer_key(cands)
                    if key not in seen:
                        seen[key] = compare.answer_readings(cands, det, model, cfg, ref)
                    out.append(seen[key])
                del det
        return out
