"""Per-stage wall-clock timing and JAX profiler traces.

The reference has no profiling (SURVEY.md §5); the frames/s benchmark target
requires one. ``StageTimer`` collects blocking wall-clock timings (calling
``block_until_ready`` on JAX outputs); ``trace_stage`` wraps a stage in a
``jax.profiler`` TraceAnnotation so stages show up in profile dumps.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import jax


class StageTimer:
    """Accumulates wall-clock per named stage; reports mean/total seconds."""

    def __init__(self) -> None:
        self.times: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                jax.block_until_ready(block_on)
            self.times[name].append(time.perf_counter() - t0)

    def block(self, name: str, value):
        """Time the device completion of ``value`` under ``name``."""
        t0 = time.perf_counter()
        jax.block_until_ready(value)
        self.times[name].append(time.perf_counter() - t0)
        return value

    def summary(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, ts in self.times.items():
            out[name] = {"mean_s": sum(ts) / len(ts), "total_s": sum(ts),
                         "count": len(ts), "min_s": min(ts)}
        return out

    def report(self) -> str:
        lines = []
        for name, s in self.summary().items():
            lines.append(f"{name:30s} mean {s['mean_s']*1e3:9.3f} ms  "
                         f"min {s['min_s']*1e3:9.3f} ms  x{s['count']}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace_stage(name: str):
    """Annotate a stage for the JAX/XLA profiler timeline."""
    with jax.profiler.TraceAnnotation(name):
        yield
