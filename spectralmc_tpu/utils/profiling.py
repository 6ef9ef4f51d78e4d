"""Profiling hooks — the idiomatic JAX counterpart of the reference's
lightweight latency counters (SURVEY §5 "Tracing/profiling": the reference
only tracks normals-pool sync/idle times; in JAX the right tool is a
``jax.profiler`` trace viewed in TensorBoard/Perfetto).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Iterator


@contextlib.contextmanager
def profile_trace(logdir: str) -> Iterator[None]:
    """Capture a jax.profiler trace for the enclosed block."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@dataclass
class StepTimer:
    """Host-side wall-clock per-step accumulator (parity: StepMetrics.batch_time)."""

    times: list[float] = field(default_factory=list)
    _start: float | None = None

    def start(self) -> None:
        self._start = time.perf_counter()

    def stop(self) -> float:
        assert self._start is not None, "start() before stop()"
        elapsed = time.perf_counter() - self._start
        self.times.append(elapsed)
        self._start = None
        return elapsed

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0
