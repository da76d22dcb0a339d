"""Utilities: C-semantics rounding, input validation, the device."""

from .device import resolve_device
from .profiling import validate_image
from .rounding import cround
