"""Throughput metering and profiler hooks.

The reference's only instrumentation is a wall-clock Timer and per-row
progress prints (SURVEY.md section 5).  Here:

  * RaysPerSecond — steady-state ray-segment throughput meter that
    excludes compile time (first call) from the measurement.
  * trace_annotation / profile_to — thin wrappers over jax.profiler for
    capturing device traces viewable in TensorBoard/XProf or Perfetto.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import jax


class RaysPerSecond:
    """Accumulates (rays, seconds) across timed sections."""

    def __init__(self):
        self.rays = 0
        self.seconds = 0.0

    @contextlib.contextmanager
    def measure(self, n_rays: int):
        t0 = time.perf_counter()
        yield
        self.seconds += time.perf_counter() - t0
        self.rays += n_rays

    @property
    def value(self) -> float:
        return self.rays / self.seconds if self.seconds > 0 else 0.0

    def __repr__(self):
        return f"{self.value:.3e} rays/s ({self.rays} rays in {self.seconds:.2f}s)"


def trace_annotation(name: str):
    """Named region for profiler timelines."""
    return jax.profiler.TraceAnnotation(name)


@contextlib.contextmanager
def profile_to(logdir: Optional[str]):
    """Capture a jax.profiler trace into ``logdir`` (no-op if None)."""
    if not logdir:
        yield
        return
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
