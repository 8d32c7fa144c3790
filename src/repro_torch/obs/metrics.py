"""Lightweight metrics registry: counters, gauges, fixed-bucket histograms
(DESIGN.md §12). A copy of ``repro/obs/metrics.py``.

A :class:`Registry` is a named bag of instruments with get-or-create
semantics (`registry.counter("sampling.draw.miss").inc()`) and a
``snapshot()`` that renders every instrument to plain JSON-able values —
the export surface the CLIs' ``--metrics-json`` flag and the CI artifacts
consume.  One process-global :data:`REGISTRY` serves the instrumented
subsystems (serve latency, draw-cache hits, tuned-table hits); components
that need isolated counters (e.g. one :class:`~repro_torch.eval.plans.PlanTrie`
per grid run) construct their own Registry.

Histograms use fixed upper-bound buckets (default: a latency ladder from
100 µs to 60 s) so ``observe()`` is O(log B) with constant memory, and
``percentile(p)`` reads p50/p90/p99 back out by linear interpolation
inside the covering bucket — exact at bucket edges, bounded error inside
(tested against hand-computed fixtures in tests/test_obs.py).  Values
above the last bucket land in an overflow bucket whose percentile
estimate is the observed maximum.

Naming convention: dot-separated ``<subsystem>.<thing>[.<qualifier>]``,
units suffixed when ambiguous (``_s`` seconds, ``_bytes``) — e.g.
``serve.request_latency_s``, ``tuning.resolve.hit``, ``plan.executions.
sample``.
"""
from __future__ import annotations

import bisect
import math
import threading
from typing import Dict, Iterable, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
           "DEFAULT_BUCKETS"]

#: default histogram upper bounds (seconds): 1 µs .. 60 s latency ladder.
#: The sub-100 µs rungs exist for the serving tier — a warm microbatched
#: search on a small tenant completes in tens of microseconds, and a
#: ladder that starts at 100 µs reports every such request as "< 1e-4",
#: making p50 vs p99 indistinguishable exactly where the scheduler's
#: batching decisions show up.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    1e-6, 2.5e-6, 5e-6, 1e-5, 2.5e-5, 5e-5,
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


class Counter:
    """Monotonically increasing count."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = 0

    def inc(self, n: int = 1) -> None:
        self._value += n

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0

    def set(self, value: float) -> None:
        self._value = float(value)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket histogram with interpolated percentiles.

    ``buckets`` are ascending upper bounds; an implicit overflow bucket
    catches everything above the last bound.
    """

    __slots__ = ("name", "uppers", "counts", "count", "sum", "_min", "_max")

    def __init__(self, name: str,
                 buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.uppers = tuple(sorted(
            DEFAULT_BUCKETS if buckets is None else buckets))
        if not self.uppers:
            raise ValueError("histogram needs at least one bucket bound")
        self.counts = [0] * (len(self.uppers) + 1)   # +1: overflow
        self.count = 0
        self.sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, value: float) -> None:
        value = float(value)
        self.counts[bisect.bisect_left(self.uppers, value)] += 1
        self.count += 1
        self.sum += value
        self._min = min(self._min, value)
        self._max = max(self._max, value)

    @property
    def min(self) -> float:
        return self._min if self.count else 0.0

    @property
    def max(self) -> float:
        return self._max if self.count else 0.0

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        """Estimated p-th percentile (p in [0, 100]) by linear
        interpolation inside the covering bucket; 0.0 when empty."""
        if not 0 <= p <= 100:
            raise ValueError(f"percentile {p!r} outside [0, 100]")
        if self.count == 0:
            return 0.0
        rank = p / 100.0 * self.count
        cum = 0
        for i, n in enumerate(self.counts):
            if n == 0:
                continue
            if cum + n >= rank:
                if i == len(self.uppers):          # overflow bucket
                    return self._max
                lo = 0.0 if i == 0 else self.uppers[i - 1]
                hi = self.uppers[i]
                frac = (rank - cum) / n
                # clamp into the actually observed range
                return min(max(lo + frac * (hi - lo), self._min), self._max)
            cum += n
        return self._max

    def percentiles(self) -> Dict[str, float]:
        return {"p50": self.percentile(50), "p90": self.percentile(90),
                "p99": self.percentile(99)}

    def to_dict(self) -> dict:
        return {"count": self.count, "sum": self.sum, "mean": self.mean,
                "min": self.min, "max": self.max, **self.percentiles()}


class Registry:
    """Get-or-create instrument store with a JSON-able snapshot."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            inst = self._counters.get(name)
            if inst is None:
                inst = self._counters[name] = Counter(name)
            return inst

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            inst = self._gauges.get(name)
            if inst is None:
                inst = self._gauges[name] = Gauge(name)
            return inst

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        with self._lock:
            inst = self._histograms.get(name)
            if inst is None:
                inst = self._histograms[name] = Histogram(name, buckets)
            return inst

    def counters(self) -> Iterable[Counter]:
        with self._lock:
            return list(self._counters.values())

    def snapshot(self) -> dict:
        """Every instrument rendered to plain values (the JSON export)."""
        with self._lock:
            return {
                "counters": {n: c.value
                             for n, c in sorted(self._counters.items())},
                "gauges": {n: g.value
                           for n, g in sorted(self._gauges.items())},
                "histograms": {n: h.to_dict()
                               for n, h in sorted(self._histograms.items())},
            }

    def reset(self) -> None:
        """Drop every instrument (tests; never called on the hot path)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


#: process-global default registry — what the instrumented subsystems use
REGISTRY = Registry()
