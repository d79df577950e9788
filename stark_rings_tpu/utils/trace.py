"""Profiling / tracing helpers.

The reference has no instrumentation beyond arkworks start_timer! no-ops
(SURVEY.md §5); here tracing is first-class: spans integrate with the JAX
profiler (visible in TensorBoard/XProf device traces) and fall back to a
wall-clock log."""

from __future__ import annotations

import contextlib
import time

import jax

__all__ = ["trace_span"]


@contextlib.contextmanager
def trace_span(name: str, log=None):
    """Context manager: names the region in JAX profiler traces and
    optionally logs wall time via ``log(name, seconds)``."""
    t0 = time.perf_counter()
    with jax.named_scope(name), jax.profiler.TraceAnnotation(name):
        yield
    if log is not None:
        log(name, time.perf_counter() - t0)
