"""CUDA graphs of an inference call: the tree DP's and the pyramid's.

An inference `root_scores` runs two long chains of small device ops
whose host code follows only from shapes, never from values: the HOG
pyramid (about five thousand ops a VGA frame: the resize and reduce
taps, the gradients, the tent maps, the block norms, the padding) and
`tree_min_sum` for every (bucket, component) pair (about a thousand ops
a bucket: index selects, the mixture where-chains, the DT kernels and
their glue). Each op is a Python call and a launch. For one shape each
chain is captured once as a CUDA graph and then replayed: the same
kernels in the same order with the same arithmetic, issued by one
launch.

`ShapeGraph` is the capture-once, replay-after machinery both share. Its
`run` runs the function eagerly the first time (which loads the kernel
library and uploads every constant the function reads: a capture may
copy nothing from the host), captures it the second time and replays it
from then on. A replay copies the inputs into the graph's input buffers
first; the results live in the graph's memory pool and are overwritten
by the next replay, so a caller consumes them on the same stream before
it replays again. Each use counts its calls in a dict of its own
(utils/profiling.py's `dp_graph_calls`, `pyramid_graph_calls`).

`DPGraph` owns the DP's graph and the DP plans (`ops/dp.py::dp_plan`) of
its shape; its input is the masked responses. `PyramidGraph` owns the
pyramid's graph and every device constant the pyramid reads
(`ops/resize.py`'s taps, `ops/hog.py`'s orientation units), taken at
the eager call into a dict of its own, so that no bounded cache can
free a tensor that the captured graph reads; its input is the frame
stack as it was uploaded, and the cast to the pyramid's dtype is inside
the graph.

A graph engages only where `graphable` holds: tensors on CUDA, no
trainable weights and no autograd recording. Every other call runs
eagerly and counts as `eager`.

The hand kernels' wrappers count their launches in the launch registry
(`utils/profiling.py::hand_launches`); during a capture their calls
launch nothing, and a replay launches without them. So every
`ShapeGraph` takes the whole registry's counts of its capture back off
and adds them again at each replay, and the registry equals the kernels
the card ran, whichever hand kernels a graph holds.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from ..utils.profiling import (
    add_launches, dp_graph_calls, launch_counts, launches_since, pyramid_graph_calls,
)


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def graphable(tensors: List[torch.Tensor], trainable: bool) -> bool:
    """Whether a call over these tensors may run as a graph: they are on
    CUDA, the weights are the model's constants and autograd records
    nothing."""
    return not trainable and _on_card(tensors[0]) and not torch.is_grad_enabled()


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


class ShapeGraph:
    """The CUDA graph of one shape of one function, its calls counted in
    `counts`, and the hand-kernel launches of its capture, which each
    replay adds to the launch registry (see the module docstring)."""

    def __init__(self, counts: Dict[str, int]):
        self.counts = counts
        self._warm = False
        self._graph = None
        self._inputs: List[torch.Tensor] = []
        self._outputs = None
        self._launches: Dict[str, int] = {}

    def note_eager(self) -> None:
        """Count a call that ran eagerly, off the gate."""
        self.counts["eager"] += 1

    def run(self, inputs: List[torch.Tensor], fn: Callable):
        """fn(inputs): eagerly the first time, then captured and
        replayed; the results of a replay are the graph's own tensors."""
        if self._graph is None:
            if not self._warm:
                self._warm = True
                self.note_eager()
                return fn(inputs)
            self._record(inputs, fn)
            self.counts["captures"] += 1
        else:
            self.counts["replays"] += 1
        return self._replay(inputs)

    def _record(self, inputs: List[torch.Tensor], fn: Callable) -> None:
        self._inputs = [torch.empty_like(x) for x in inputs]
        before = launch_counts()
        self._graph, self._outputs = cuda_capture(
            lambda: fn(self._inputs), inputs[0].device
        )
        self._launches = launches_since(before)
        add_launches(self._launches, -1)

    def _replay(self, inputs: List[torch.Tensor]):
        if [(x.shape, x.dtype) for x in inputs] != [
            (x.shape, x.dtype) for x in self._inputs
        ]:
            raise ValueError(
                f"{type(self).__name__}: the inputs' shapes or dtypes are not "
                "the captured ones"
            )
        for dst, src in zip(self._inputs, inputs):
            dst.copy_(src)
        self._graph.replay()
        add_launches(self._launches)
        return self._outputs


class DPGraph(ShapeGraph):
    """The DP plans and the CUDA graph of one shape."""

    def __init__(self):
        super().__init__(dp_graph_calls)
        self.plans: Dict[tuple, list] = {}

    def plan(self, key: tuple, build: Callable) -> list:
        """The plan under key, built at the first call."""
        if key not in self.plans:
            self.plans[key] = build()
        return self.plans[key]


class PyramidGraph(ShapeGraph):
    """The pyramid's CUDA graph of one shape, and `consts`: every device
    constant the pyramid reads, by the key ops/resize.py::held gives it,
    filled at the eager call and read by the capture."""

    def __init__(self):
        super().__init__(pyramid_graph_calls)
        self.consts: Dict[tuple, object] = {}


class ShapeGraphs:
    """The graphs of one inference shape, held and dropped together."""

    __slots__ = ("pyramid", "dp")

    def __init__(self):
        self.pyramid = PyramidGraph()
        self.dp = DPGraph()
