"""Utilities: C-semantics rounding, input validation."""

from .profiling import validate_image
from .rounding import cround
