"""Open-loop load generator for the serving tier (a copy of
``repro/serve/loadgen.py``; host code only).

Drives a :class:`~repro_torch.serve.scheduler.MicrobatchScheduler` with a
synthetic arrival process and reports what capacity planning reads:
sustained **throughput** (completed requests / wall time) and **p50/p99
latency** (per-request queue wait + compute, straight off each request's
completion future) as functions of offered load, microbatch size and
tenant count.

Open loop with backpressure shedding: arrivals fire on their schedule
regardless of completions (``rate=inf`` collapses to "as fast as
possible"); a full queue rejects the arrival, the generator counts the
shed and moves on — so overload shows up as rejections plus saturated
throughput, not as a generator stall that would hide it. Tenants
round-robin over arrivals. The scheduler's cooperative ``tick`` runs in
the generator loop between submissions — one thread, deterministic
per-seed, nothing to join. A tick returns once its results are on the
host, so every latency includes the card's work.

``launch/serve.py`` routes here; its ``--out`` row is
:meth:`LoadReport.to_row`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np

from repro_torch.serve.scheduler import MicrobatchScheduler, PendingResult

__all__ = ["LoadSpec", "LoadReport", "run_load"]


@dataclasses.dataclass(frozen=True)
class LoadSpec:
    """One load-generation run: ``n_requests`` arrivals at ``rate``
    requests/s (inf = back-to-back), spread round-robin over ``tenants``
    tenant ids (``tenant-0`` … ``tenant-{n-1}``), each asking top-``k``."""

    n_requests: int = 256
    rate: float = float("inf")
    tenants: int = 1
    k: int = 10
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class LoadReport:
    """What one run measured (the serve CLI's ``--out`` row)."""

    completed: int
    rejected: int
    wall_s: float
    throughput_rps: float
    p50_s: float
    p99_s: float
    ticks: int
    mean_batch: float

    def to_row(self) -> dict:
        return {"throughput_rps": round(self.throughput_rps, 2),
                "p50_s": self.p50_s, "p99_s": self.p99_s,
                "completed": self.completed, "rejected": self.rejected,
                "ticks": self.ticks,
                "mean_batch": round(self.mean_batch, 2)}


def _percentile(xs: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs \
        else float("nan")


def run_load(scheduler: MicrobatchScheduler, queries: np.ndarray,
             spec: Optional[LoadSpec] = None) -> LoadReport:
    """Run one open-loop load test; ``queries`` f32[Q, D] are cycled to
    fill ``spec.n_requests`` arrivals."""
    spec = spec or LoadSpec()
    q = np.asarray(queries, np.float32)
    if q.ndim != 2 or q.shape[0] == 0:
        raise ValueError(f"queries must be non-empty f32[Q, D]; got "
                         f"{q.shape}")
    interval = 0.0 if not np.isfinite(spec.rate) else 1.0 / spec.rate
    pending: List[PendingResult] = []
    rejected = 0
    ticks0 = scheduler.ticks
    start = time.perf_counter()
    for i in range(spec.n_requests):
        due = start + i * interval
        # hold the arrival to its schedule, ticking while we wait so the
        # queue keeps draining between arrivals
        while True:
            now = time.perf_counter()
            if now >= due:
                break
            if scheduler.tick() == 0:
                time.sleep(min(due - now, 1e-4))
        req = scheduler.submit(q[i % q.shape[0]], k=spec.k,
                               tenant=f"tenant-{i % spec.tenants}")
        if req is None:
            rejected += 1
        else:
            pending.append(req)
        # tick once a full microbatch is waiting — ticking per arrival
        # would pin every batch at size 1 and measure the serial path
        if scheduler.depth >= scheduler.config.max_batch:
            scheduler.tick()
    while scheduler.tick():
        pass
    wall = time.perf_counter() - start
    lat = [r.completed_at - r.submitted_at for r in pending if r.done]
    ticks = scheduler.ticks - ticks0
    return LoadReport(
        completed=len(lat), rejected=rejected, wall_s=wall,
        throughput_rps=len(lat) / wall if wall > 0 else 0.0,
        p50_s=_percentile(lat, 50), p99_s=_percentile(lat, 99),
        ticks=ticks, mean_batch=(len(lat) / ticks if ticks else 0.0))
