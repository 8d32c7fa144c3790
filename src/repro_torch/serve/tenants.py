"""Per-tenant session cache for the serving tier (port of
``repro/serve/tenants.py``; DESIGN.md §14).

A multi-tenant server holds one built index per (tenant, search
configuration) — each is a :class:`~repro_torch.serve.ingest.LiveIndex`
(or a bare :class:`~repro_torch.retrieval.search_core.SearchSession`)
whose device tensors are the dominant memory cost. :class:`TenantCache`
bounds that cost with an LRU over live sessions: a hit returns the
resident session, a miss builds one through the caller's provider, and
eviction drops the session reference so its tensors return to the caching
allocator with the last in-flight search. Eviction is safe by
construction: a session is pure state plus pure compute, so an evicted
tenant's next request just rebuilds (a cold ``search.build``, visible in
the trace), and results are identical.

Observability (the shared registry): ``serve.tenant.hit`` /
``serve.tenant.miss`` / ``serve.tenant.evict`` counters and a
``serve.tenant.resident_bytes`` gauge sampled from
``obs/memory.bytes_per_device`` after every build/evict. As in the
reference, that reading is the allocator's peak, so the gauge does not
fall when a tenant is evicted; on a host with no card it reads 0.

The generic :class:`LRUCache` also bounds the retrieval frontend's
context cache (serve/engine.py): one eviction policy, two tiers.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Hashable, Optional, Tuple

from repro_torch.obs import REGISTRY
from repro_torch.obs import memory as obs_memory
from repro_torch.obs.locks import make_lock
from repro_torch.obs.metrics import Registry

__all__ = ["LRUCache", "TenantCache", "RESIDENT_GAUGE"]

RESIDENT_GAUGE = "serve.tenant.resident_bytes"


class LRUCache:
    """Minimal thread-safe LRU: ``get`` promotes, ``put`` evicts the least
    recently used entry past ``capacity`` and hands it to ``on_evict``
    (called outside the lock — evict handlers may do real work)."""

    def __init__(self, capacity: int,
                 on_evict: Optional[Callable[[Hashable, Any], None]] = None):
        if capacity < 1:
            raise ValueError(f"cache capacity must be >= 1; got {capacity}")
        self.capacity = capacity
        self._on_evict = on_evict
        self._items: "OrderedDict[Hashable, Any]" = OrderedDict()
        self._lock = make_lock("lru-cache")

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    def __contains__(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._items

    def get(self, key: Hashable, default: Any = None) -> Any:
        with self._lock:
            if key not in self._items:
                return default
            self._items.move_to_end(key)
            return self._items[key]

    def put(self, key: Hashable, value: Any) -> None:
        evicted = []
        with self._lock:
            self._items[key] = value
            self._items.move_to_end(key)
            while len(self._items) > self.capacity:
                evicted.append(self._items.popitem(last=False))
        for ekey, evalue in evicted:
            if self._on_evict is not None:
                self._on_evict(ekey, evalue)

    def pop(self, key: Hashable, default: Any = None) -> Any:
        with self._lock:
            return self._items.pop(key, default)

    def keys(self) -> Tuple[Hashable, ...]:
        with self._lock:
            return tuple(self._items)


class TenantCache:
    """LRU of per-tenant live search sessions.

    ``provider(tenant)`` builds the session for a tenant on a miss — the
    server owns corpus loading and configuration; the cache owns residency.
    ``capacity`` bounds how many tenants hold device tensors at once."""

    def __init__(self, provider: Callable[[str], Any], *, capacity: int = 8,
                 registry: Registry = REGISTRY):
        self._provider = provider
        self._registry = registry
        self._build_lock = make_lock("tenant-build")
        self._lru = LRUCache(capacity, on_evict=self._evicted)

    def _sample_resident(self) -> None:
        self._registry.gauge(RESIDENT_GAUGE).set(
            float(max(obs_memory.bytes_per_device().values(), default=0.0)))

    def _evicted(self, tenant: Hashable, session: Any) -> None:
        self._registry.counter("serve.tenant.evict").inc()
        # let an in-flight compaction land before the drop; a LiveIndex's
        # close also hands its compaction groups to the next build
        done = getattr(session, "close", None) or getattr(session, "flush",
                                                            None)
        if callable(done):
            done()
        self._sample_resident()

    def get(self, tenant: str) -> Any:
        """The tenant's resident session, building (and possibly evicting)
        on a miss."""
        session = self._lru.get(tenant)
        if session is not None:
            self._registry.counter("serve.tenant.hit").inc()
            return session
        # one build at a time: concurrent misses for the same tenant must
        # not build twice (device memory spike), and provider builds are
        # the expensive path anyway
        with self._build_lock:
            session = self._lru.get(tenant)
            if session is not None:
                self._registry.counter("serve.tenant.hit").inc()
                return session
            self._registry.counter("serve.tenant.miss").inc()
            session = self._provider(tenant)
            self._lru.put(tenant, session)
            self._sample_resident()
            return session

    def evict(self, tenant: str) -> bool:
        """Explicitly drop one tenant's session (admin path)."""
        session = self._lru.pop(tenant)
        if session is None:
            return False
        self._evicted(tenant, session)
        return True

    def flush(self) -> None:
        """Let every resident session's in-flight compaction land (a
        shutdown or end-of-run step; counts no hit)."""
        for tenant in self.resident:
            session = self._lru.get(tenant)
            if callable(getattr(session, "flush", None)):
                session.flush()

    @property
    def resident(self) -> Tuple[Hashable, ...]:
        return self._lru.keys()

    def __len__(self) -> int:
        return len(self._lru)
