"""Utilities: C-semantics rounding, observability, input validation, the
device. The JAX package's `utils` re-exports; its `time_jitted` is
`time_fn` here (the port runs eagerly and has no jit)."""

from .device import resolve_device
from .profiling import Timer, checked, time_fn, trace, validate_image
from .rounding import cround
