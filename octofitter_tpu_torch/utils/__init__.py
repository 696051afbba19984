"""Utilities: profiling and timing hooks."""

from .profiling import profile_trace, timing_probe

__all__ = ["profile_trace", "timing_probe"]
