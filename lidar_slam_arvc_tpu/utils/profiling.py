"""Tracing and per-stage timing (SURVEY.md §5: absent in the reference,
first-class here).

  * :class:`StageTimer` — named wall-clock counters with frames/s reporting,
    used by the pipeline drivers (replaces the reference's ad-hoc prints,
    run_scanmatcher.py:194,209-210).
  * :func:`trace` — context manager around ``jax.profiler`` producing a
    TensorBoard-loadable trace directory for kernel-level inspection.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class StageTimer:
    """Accumulates wall time + item counts per named stage."""

    def __init__(self):
        self.seconds = defaultdict(float)
        self.items = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] += time.perf_counter() - t0
            self.items[name] += items

    def rate(self, name: str) -> float | None:
        s = self.seconds.get(name, 0.0)
        n = self.items.get(name, 0)
        return n / s if s > 0 and n else None

    def report(self) -> dict:
        out = {}
        for name in self.seconds:
            out[name] = {"seconds": round(self.seconds[name], 4),
                         "items": self.items[name]}
            r = self.rate(name)
            if r is not None:
                out[name]["items_per_second"] = round(r, 2)
        return out

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.report(), f, indent=2)

    def __str__(self):
        parts = []
        for name, stats in sorted(self.report().items()):
            rate = stats.get("items_per_second")
            rate_s = f" ({rate}/s)" if rate else ""
            parts.append(f"{name}: {stats['seconds']}s{rate_s}")
        return " | ".join(parts)


def setup_compile_cache() -> str:
    """Place JAX's persistent compilation cache; returns its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing else is configured.  Otherwise the cache goes to ``.jax_cache``
    at the root of this checkout: a fixed path, since the path is part of
    the cache key."""
    import jax
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = os.path.join(_CHECKOUT, ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    return path


class CompileCounter:
    """Counts distinct XLA compilations (and their wall time) in a scope.

    Compilation is a one-time cost of every run; this makes the program
    count a regression-trackable metric.  Counts '/jax/core/compile/backend_compile'
    events via jax.monitoring; note JAX compiles a few tiny internal
    helpers on first use, so the count is an upper bound on user programs —
    the durations are what matter.
    """

    _EVENT = "/jax/core/compile/backend_compile_duration"

    def __init__(self):
        self.events = []

    @property
    def count(self) -> int:
        return len(self.events)

    @property
    def seconds(self) -> float:
        return float(sum(self.events))

    @contextlib.contextmanager
    def scope(self):
        from jax import monitoring

        def listener(name, duration, **kw):
            if name == self._EVENT:
                self.events.append(duration)

        monitoring.register_event_duration_secs_listener(listener)
        try:
            yield self
        finally:
            try:
                monitoring.unregister_event_duration_listener(listener)
            except Exception:
                pass  # older JAX: listener stays, harmlessly appending

    def report(self) -> dict:
        return {"programs_compiled": self.count,
                "compile_seconds": round(self.seconds, 3)}


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a device trace (view with TensorBoard's profile plugin)."""
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
