"""Continuous-batching microbatch scheduler for search serving (port of
``repro/serve/scheduler.py``; DESIGN.md §14).

One query per ``search`` call leaves the card idle between launches, but
naive batching makes p99 hostage to the slowest co-batched request, and
every distinct batch shape is a new launch shape for the kernels. The
scheduler solves both as the reference does:

  * a bounded FIFO queue admits requests (``submit``) and rejects with
    backpressure when full — callers see ``None`` immediately, never an
    unbounded wait;
  * each ``tick()`` pops the head-of-line tenant's requests (up to
    ``max_batch``, in arrival order), pads them to the smallest shape in
    a fixed **bucket set** (powers of two up to ``max_batch``) and runs
    ONE shared ``search_scored`` at the fixed ``k_max`` — so once every
    bucket has run, the kernels see no new (Q, k) shape whatever the
    offered load (``launch/serve.py --recompile-check`` counts it);
  * results slice back to per-request completion futures
    (:class:`PendingResult`) that callers block on independently — a
    request's latency is its own queue wait + its tick.

A tick completes its requests with host numpy arrays: the session hands
back numpy (``SearchSession.search_scored`` reads its results to the host,
which waits for the card), so a request's latency counts the device's
work. Ticks are cooperative (the caller's serving loop invokes ``tick`` /
``drain``): no scheduler threads to drain on shutdown, and tests drive it
deterministically.

Observability: ``serve.tick`` and ``serve.batch`` spans (the batch span
carries tenant, bucket and fill), the ``serve.request_latency_s``
histogram (queue wait + compute, per request), ``serve.queue.depth``
gauge, ``serve.queue.rejected`` counter, and a ``serve.batch.fill``
histogram exposing padding waste.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Optional, Tuple

import numpy as np
import torch

from repro_torch.obs import REGISTRY, recompile, trace
from repro_torch.obs.locks import make_lock
from repro_torch.obs.metrics import Registry

__all__ = ["SchedulerConfig", "PendingResult", "MicrobatchScheduler"]


def _buckets(max_batch: int) -> Tuple[int, ...]:
    out = []
    b = 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


def _host(x) -> np.ndarray:
    """A session's result as a host array (a tensor is read back, which
    waits for the card)."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Admission and batching knobs.

    ``k_max`` fixes the top-k width of every dispatched search (requests
    ask for any ``k <= k_max`` and get a slice) — one more shape held
    constant, so the kernels see |buckets| shapes."""

    max_queue: int = 256
    max_batch: int = 32
    k_max: int = 16
    buckets: Optional[Tuple[int, ...]] = None   # default: powers of two

    def bucket_set(self) -> Tuple[int, ...]:
        return tuple(sorted(self.buckets)) if self.buckets \
            else _buckets(self.max_batch)


class PendingResult:
    """Completion future for one submitted query: ``result()`` blocks for
    (scores f32[k], ids i32[k]) — or re-raises the tick's failure."""

    def __init__(self, tenant: str, query: np.ndarray, k: int):
        self.tenant = tenant
        self.query = query
        self.k = k
        self.submitted_at = time.perf_counter()
        self.completed_at: Optional[float] = None
        self._done = threading.Event()
        self._scores: Optional[np.ndarray] = None
        self._ids: Optional[np.ndarray] = None
        self._error: Optional[BaseException] = None

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def _complete(self, scores: np.ndarray, ids: np.ndarray) -> None:
        self._scores, self._ids = scores, ids
        self.completed_at = time.perf_counter()
        self._done.set()

    def _fail(self, error: BaseException) -> None:
        self._error = error
        self.completed_at = time.perf_counter()
        self._done.set()

    def result(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise TimeoutError("result not ready; drive the scheduler "
                               "(tick()/drain()) or raise the timeout")
        if self._error is not None:
            raise self._error
        return self._scores, self._ids


class MicrobatchScheduler:
    """Bounded-queue continuous batching over per-tenant search sessions.

    ``sessions(tenant)`` resolves a search target exposing
    ``search_scored(queries, k=...)`` — a :class:`~repro_torch.serve.
    tenants.TenantCache` bound method, a :class:`~repro_torch.serve.ingest.
    LiveIndex`, or a bare :class:`~repro_torch.retrieval.search_core.
    SearchSession` wrapped in a lambda."""

    def __init__(self, sessions: Callable[[str], Any],
                 config: Optional[SchedulerConfig] = None,
                 *, registry: Registry = REGISTRY):
        self.config = config or SchedulerConfig()
        if self.config.max_queue < 1 or self.config.max_batch < 1:
            raise ValueError("max_queue and max_batch must be >= 1")
        if max(self.config.bucket_set()) < self.config.max_batch:
            raise ValueError("bucket set must cover max_batch")
        self._sessions = sessions
        self._registry = registry
        self._queue: Deque[PendingResult] = deque()
        self._lock = make_lock("scheduler-queue")
        self.ticks = 0

    # -- admission ---------------------------------------------------------

    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def submit(self, query, *, k: Optional[int] = None,
               tenant: str = "default") -> Optional[PendingResult]:
        """Admit one query (f32[D]); returns its future, or None when the
        queue is full (backpressure — the caller retries or sheds)."""
        cfg = self.config
        k = cfg.k_max if k is None else k
        if not 1 <= k <= cfg.k_max:
            raise ValueError(f"k={k} outside [1, k_max={cfg.k_max}]; "
                             "raise SchedulerConfig.k_max")
        q = _host(query).astype(np.float32, copy=False).reshape(-1)
        req = PendingResult(tenant, q, k)
        with self._lock:
            if len(self._queue) >= cfg.max_queue:
                self._registry.counter("serve.queue.rejected").inc()
                return None
            self._queue.append(req)
            depth = len(self._queue)
        self._registry.counter("serve.queue.submitted").inc()
        self._registry.gauge("serve.queue.depth").set(depth)
        return req

    # -- batching ----------------------------------------------------------

    def _take_batch(self) -> list:
        """Pop the head-of-line tenant's requests in arrival order (up to
        ``max_batch``); other tenants keep their queue positions, so
        admission order is served order within every tenant."""
        with self._lock:
            if not self._queue:
                return []
            tenant = self._queue[0].tenant
            batch, keep = [], deque()
            while self._queue:
                req = self._queue.popleft()
                if req.tenant == tenant and len(batch) < \
                        self.config.max_batch:
                    batch.append(req)
                else:
                    keep.append(req)
            self._queue = keep
            self._registry.gauge("serve.queue.depth").set(len(keep))
        return batch

    def _bucket(self, n: int) -> int:
        for b in self.config.bucket_set():
            if b >= n:
                return b
        return max(self.config.bucket_set())

    def tick(self) -> int:
        """Serve one microbatch; returns the number of requests completed
        (0 when idle). One shared search per tick, fixed shapes."""
        batch = self._take_batch()
        if not batch:
            return 0
        self.ticks += 1
        cfg = self.config
        tenant = batch[0].tenant
        bucket = self._bucket(len(batch))
        with trace.span("serve.tick", requests=len(batch), bucket=bucket), \
                recompile.region("serve.tick"):
            try:
                session = self._sessions(tenant)
                dim = batch[0].query.shape[0]
                padded = np.zeros((bucket, dim), np.float32)
                for i, req in enumerate(batch):
                    padded[i] = req.query
                with trace.span("serve.batch", tenant=tenant, bucket=bucket,
                                fill=len(batch)):
                    scores, ids = session.search_scored(padded, k=cfg.k_max)
                    scores, ids = _host(scores), _host(ids)
            except BaseException as e:
                for req in batch:
                    req._fail(e)
                    self._observe(req)
                if not isinstance(e, Exception):
                    raise       # an interrupt still fails the batch first
                return len(batch)
            for i, req in enumerate(batch):
                req._complete(scores[i, :req.k].copy(),
                              ids[i, :req.k].copy())
                self._observe(req)
        self._registry.histogram("serve.batch.fill").observe(
            len(batch) / bucket)
        return len(batch)

    def _observe(self, req: PendingResult) -> None:
        self._registry.histogram("serve.request_latency_s").observe(
            req.completed_at - req.submitted_at)
        self._registry.counter("serve.queue.completed").inc()

    def drain(self, max_ticks: Optional[int] = None) -> int:
        """Tick until the queue empties; returns requests completed. The
        bound defaults to the depth (every tick serves >= 1 request, so
        depth ticks always suffice) — a guard against a loop that never
        ends."""
        bound = max_ticks if max_ticks is not None else max(self.depth, 1)
        total = 0
        for _ in range(bound):
            done = self.tick()
            if done == 0:
                break
            total += done
        return total
