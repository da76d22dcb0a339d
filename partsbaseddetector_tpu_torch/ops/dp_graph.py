"""One CUDA graph over the tree DPs of an inference call.

An inference `root_scores` runs `tree_min_sum` for every (bucket,
component) pair: about a thousand small device ops a bucket (index
selects, the mixture where-chains, the DT kernels and their glue), each
a Python call and a launch. Everything the DP's host code decides (the
schedule, the grids, the live counts, K1 or K5) follows from the shapes,
the dtype and the model, never from the responses' values. So for one
shape the DP is captured once as a CUDA graph and then replayed: the
same kernels in the same order with the same arithmetic, issued by one
launch.

`DPGraph` owns one such graph and the DP plans (`ops/dp.py::dp_plan`)
of its shape. Its `run` runs the DP eagerly the first time (which loads
the kernel library and builds the plans: a capture may copy nothing
from the host), captures it the second time and replays it from then
on. A replay copies the masked responses into the graph's input buffers
first; the results (root maps and pointer tables) live in the graph's
memory pool and are overwritten by the next replay, so a caller
consumes them on the same stream before it replays again.

The graph engages only where `graphable` holds: maps on CUDA, no
trainable weights and no autograd recording. Every other call runs the
eager DP and counts as `eager`.

The DT and transpose wrappers count their launches (`launch_counts`);
during a capture their calls launch nothing, so the capture's counts
are taken back off and added again at each replay, and the counters
equal the kernels the card ran.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from . import dt_cuda, transpose_cuda

# DP calls by how they ran: captured (and replayed once), replayed, or
# eager (a shape's first call, or a call the graph does not engage for)
counts: Dict[str, int] = {"captures": 0, "replays": 0, "eager": 0}

# the launch counters, as launch_counts() reads them, of the hand kernels
# an inference DP runs: K1 (y and x passes), K5 and T2
_COUNTERS = (
    (dt_cuda, "launches"), (dt_cuda, "aux_launches"),
    (dt_cuda, "window_launches"), (transpose_cuda, "launches"),
)


def _read_counters() -> List[int]:
    return [getattr(mod, name) for mod, name in _COUNTERS]


def _add_counters(delta: List[int]) -> None:
    for (mod, name), d in zip(_COUNTERS, delta):
        setattr(mod, name, getattr(mod, name) + d)


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def graphable(resps: List[torch.Tensor], trainable: bool) -> bool:
    """Whether a DP over these maps may run as a graph: they are on
    CUDA, the weights are the model's constants and autograd records
    nothing."""
    return not trainable and _on_card(resps[0]) and not torch.is_grad_enabled()


def cuda_capture(fn: Callable, device: torch.device):
    """Capture fn() as a CUDA graph on `device`: (graph, the tensors fn
    returned, which every replay rewrites). Only the calling thread is
    held to the capture's rules (another thread may stage uploads
    meanwhile)."""
    with torch.cuda.device(device):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = fn()
    return graph, out


class DPGraph:
    """The DP plans and the CUDA graph of one shape (see the module
    docstring)."""

    def __init__(self):
        self.plans: Dict[tuple, list] = {}
        self._warm = False
        self._graph = None
        self._inputs: List[torch.Tensor] = []
        self._outputs = None
        self._delta: List[int] = []

    def plan(self, key: tuple, build: Callable) -> list:
        """The plan under key, built at the first call."""
        if key not in self.plans:
            self.plans[key] = build()
        return self.plans[key]

    @staticmethod
    def note_eager() -> None:
        """Count a DP that ran eagerly, off the gate."""
        counts["eager"] += 1

    def run(self, resps: List[torch.Tensor], dp: Callable):
        """dp(resps): eagerly the first time, then captured and
        replayed; the results of a replay are the graph's own tensors."""
        if self._graph is None:
            if not self._warm:
                self._warm = True
                self.note_eager()
                return dp(resps)
            self._record(resps, dp)
            counts["captures"] += 1
        else:
            counts["replays"] += 1
        return self._replay(resps)

    def _record(self, resps: List[torch.Tensor], dp: Callable) -> None:
        self._inputs = [torch.empty_like(r) for r in resps]
        before = _read_counters()
        self._graph, self._outputs = cuda_capture(
            lambda: dp(self._inputs), resps[0].device
        )
        self._delta = [a - b for a, b in zip(_read_counters(), before)]
        _add_counters([-d for d in self._delta])

    def _replay(self, resps: List[torch.Tensor]):
        if [r.shape for r in resps] != [x.shape for x in self._inputs]:
            raise ValueError("DPGraph: the maps' shapes are not the captured ones")
        for dst, src in zip(self._inputs, resps):
            dst.copy_(src)
        self._graph.replay()
        _add_counters(self._delta)
        return self._outputs
