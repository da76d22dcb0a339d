"""Utilities: C-semantics rounding, observability, input validation, the
device. The JAX package's `utils` re-exports; its `time_jitted` is
`time_fn` here (the port runs eagerly and has no jit), and the stage
spans (`span`, `recording`), the DP's, the pyramid's and the tail's
graph counters (`dp_graph_counts`, `pyramid_graph_counts`,
`tail_graph_counts`) and the detect path's tree counter (`tree_counts`)
are the port's own."""

from .device import resolve_device
from .profiling import (
    Timer, checked, dp_graph_counts, pyramid_graph_counts, recording, span,
    tail_graph_counts, time_fn, trace, tree_counts, validate_image,
)
from .rounding import cround
