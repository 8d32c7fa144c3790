"""The retrieval serving tier, assembled (port of ``repro/serve/engine.py``
less its decoder; DESIGN.md §14).

The paper's Fig. 5 online component, query -> embed -> ANN:
:class:`RetrievalFrontend` embeds incoming queries and answers them through
the SAME :class:`~repro_torch.retrieval.search_core.SearchSession` the
offline experiment grid uses (engine/backend/shard are one config), and
:class:`SearchServer` serves many tenants, whose corpora grow while they
serve, through a microbatch scheduler over a cache of per-tenant
:class:`~repro_torch.serve.ingest.LiveIndex` sessions.

The reference's generative RAG path (``ServeEngine``, ``ServeConfig``,
``Request``, ``RagEngine``) runs a decoder the port has not yet
(``decode_step``, ``init_kv_cache``); it comes with ROADMAP.md queue 1
item 15.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.device import resolve_device
from repro_torch.obs import REGISTRY
from repro_torch.retrieval.search_core import SearchConfig, SearchSession
from repro_torch.serve.ingest import IngestConfig, LiveIndex
from repro_torch.serve.scheduler import (MicrobatchScheduler, PendingResult,
                                         SchedulerConfig)
from repro_torch.serve.tenants import LRUCache, TenantCache

__all__ = ["RetrievalFrontend", "SearchServer"]


class RetrievalFrontend:
    """Fig. 5 online path: query -> embed -> ANN, through the search core.

    ``embed_fn`` maps a batch of raw queries (token arrays, text — whatever
    the deployment embeds) to f32[Q, D] vectors (numpy, or a tensor on any
    device) on the geometry the ``corpus_vecs`` were embedded with;
    retrieval itself is one :class:`SearchSession` on ``device``, so the
    online path and the offline grid share one implementation.

    Retrieved contexts are memoised in a BOUNDED per-query LRU (keyed by
    the embedded vector bytes + k): repeat queries skip the session
    entirely, the cache never grows past ``ctx_cache_size`` entries
    (eviction is counted as ``serve.ctx.evict``), and an evicted query's
    re-retrieval recomputes the identical ids — the session is
    deterministic, so the cache is a latency bound, never a correctness
    surface. ``ingest=IngestConfig(...)`` swaps the frozen session for a
    :class:`~repro_torch.serve.ingest.LiveIndex`, adding ``append`` (the
    cache is flushed per append — stale top-k would otherwise hide new
    documents).
    """

    def __init__(self, corpus_vecs, embed_fn: Callable[..., Any], *,
                 config: Optional[SearchConfig] = None,
                 key: Optional[prng.Key] = None,
                 ids_map: Optional[np.ndarray] = None,
                 ctx_cache_size: int = 1024,
                 ingest: Optional[IngestConfig] = None, device="cuda",
                 **overrides):
        self.embed_fn = embed_fn
        if ingest is not None:
            if ids_map is not None:
                raise ValueError("live ingest keeps its own global id "
                                 "space; ids_map is not supported")
            self.session = LiveIndex(corpus_vecs, config, key=key,
                                     ingest=ingest, device=device,
                                     **overrides)
        else:
            self.session = SearchSession(corpus_vecs, config, key=key,
                                         ids_map=ids_map, device=device,
                                         **overrides)
        self._ctx_cache = LRUCache(
            ctx_cache_size,
            on_evict=lambda *_: REGISTRY.counter("serve.ctx.evict").inc())

    def append(self, docs):
        """Land new documents into a live-ingest session (and invalidate
        the context cache — cached top-k predates the new rows)."""
        if not isinstance(self.session, LiveIndex):
            raise ValueError("frontend was built without ingest=; pass "
                             "IngestConfig(...) to enable appends")
        out = self.session.append(docs)
        self._ctx_cache = LRUCache(self._ctx_cache.capacity,
                                   on_evict=self._ctx_cache._on_evict)
        return out

    def retrieve(self, raw_queries, *, k: int = 3) -> np.ndarray:
        """Raw queries -> top-k ids i32[Q, k] (-1 padding for misses)."""
        t0 = time.perf_counter()
        vecs = self.embed_fn(raw_queries)
        if isinstance(vecs, torch.Tensor):
            vecs = vecs.detach().cpu().numpy()
        vecs = np.asarray(vecs, np.float32)
        if vecs.shape[0] == 0:
            return np.zeros((0, k), np.int32)
        keys = [(q.tobytes(), k) for q in vecs]
        cached = [self._ctx_cache.get(key) for key in keys]
        misses = [i for i, c in enumerate(cached) if c is None]
        REGISTRY.counter("serve.ctx.hit").inc(len(keys) - len(misses))
        REGISTRY.counter("serve.ctx.miss").inc(len(misses))
        if misses:
            fresh = self.session.search(vecs[misses], k=k)
            for j, i in enumerate(misses):
                cached[i] = fresh[j]
                self._ctx_cache.put(keys[i], fresh[j])
        ids = np.stack(cached, axis=0).astype(np.int32)
        REGISTRY.counter("serve.retrieve.queries").inc(len(ids))
        REGISTRY.histogram("serve.retrieve_latency_s").observe(
            time.perf_counter() - t0)
        return ids


class SearchServer:
    """The serving tier, assembled: a bounded-queue
    :class:`~repro_torch.serve.scheduler.MicrobatchScheduler` dispatching
    into a :class:`~repro_torch.serve.tenants.TenantCache` of per-tenant
    :class:`~repro_torch.serve.ingest.LiveIndex` sessions on ``device``.

    ``corpus_provider(tenant)`` returns the tenant's corpus vectors
    f32[N, D] — called on cache miss (first request, or re-admission after
    eviction), so tenant state is always reconstructible and eviction is
    safe. ``submit``/``tick``/``drain`` are the scheduler's;
    ``append(tenant, docs)`` lands documents in that tenant's live index
    (building it if cold); ``flush()`` lets every resident tenant's
    in-flight compaction land.
    """

    def __init__(self, corpus_provider: Callable[[str], Any], *,
                 config: Optional[SearchConfig] = None,
                 scheduler: Optional[SchedulerConfig] = None,
                 ingest: Optional[IngestConfig] = None,
                 max_tenants: int = 8,
                 key: Optional[prng.Key] = None, device="cuda"):
        search_cfg = config or SearchConfig()
        ingest_cfg = ingest or IngestConfig()
        self.device = resolve_device(device)

        def build(tenant: str) -> LiveIndex:
            return LiveIndex(corpus_provider(tenant), search_cfg, key=key,
                             ingest=ingest_cfg, device=self.device)

        self.tenants = TenantCache(build, capacity=max_tenants)
        self.scheduler = MicrobatchScheduler(self.tenants.get, scheduler)

    def submit(self, query, *, k: Optional[int] = None,
               tenant: str = "default") -> Optional[PendingResult]:
        return self.scheduler.submit(query, k=k, tenant=tenant)

    def tick(self) -> int:
        return self.scheduler.tick()

    def drain(self, max_ticks: Optional[int] = None) -> int:
        return self.scheduler.drain(max_ticks)

    def append(self, tenant: str, docs):
        """Ingest new documents for one tenant (cold tenants build first)."""
        return self.tenants.get(tenant).append(docs)

    def flush(self) -> None:
        """Block until every resident tenant's in-flight compaction has
        landed (raises a failed one)."""
        self.tenants.flush()
