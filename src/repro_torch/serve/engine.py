"""Batched serving engine with continuous batching over a shared KV cache,
and the retrieval serving tier, assembled (port of
``repro/serve/engine.py``; DESIGN.md §14).

The paper's Fig. 5 online component, query -> embed -> ANN, plus a
generative RAG path: :class:`RetrievalFrontend` embeds incoming queries and
answers them through the SAME :class:`~repro_torch.retrieval.search_core.
SearchSession` the offline experiment grid uses (engine/backend/shard are
one config), :class:`RagEngine` feeds the retrieved passages into the
continuous-batching decoder (:class:`ServeEngine`), and
:class:`SearchServer` serves many tenants, whose corpora grow while they
serve, through a microbatch scheduler over a cache of per-tenant
:class:`~repro_torch.serve.ingest.LiveIndex` sessions.

Requests join a fixed-slot batch; finished slots are refilled without
stalling in-flight requests (continuous batching). Slot state lives in the
rolling KV cache, on the device of the parameters; prefill for a joining
request runs token-by-token through ``decode_step``, as the reference's
does.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.device import resolve_device
from repro_torch.models.transformer import (TransformerConfig, decode_step,
                                            init_kv_cache, tree_to)
from repro_torch.obs import REGISTRY, trace
from repro_torch.retrieval.search_core import SearchConfig, SearchSession
from repro_torch.serve.ingest import IngestConfig, LiveIndex
from repro_torch.serve.scheduler import (MicrobatchScheduler, PendingResult,
                                         SchedulerConfig)
from repro_torch.serve.tenants import LRUCache, TenantCache

__all__ = ["ServeConfig", "Request", "ServeEngine", "RetrievalFrontend",
           "RagEngine", "SearchServer"]


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 8
    max_seq: int = 512
    max_new_tokens: int = 32
    temperature: float = 0.0      # 0 -> greedy


@dataclasses.dataclass
class Request:
    prompt: np.ndarray            # i32[prompt_len]
    out: list = dataclasses.field(default_factory=list)
    remaining_prompt: int = 0
    new_tokens: int = 0
    done: bool = False
    t_submit: float = 0.0         # perf_counter at submit (latency metrics)
    t_done: float = 0.0           # perf_counter at completion


class ServeEngine:
    """Metrics (DESIGN.md §12, always on — the global obs registry):
    ``serve.request_latency_s`` submit→complete histogram (p50/p99),
    ``serve.tokens_per_step`` histogram + ``serve.tokens`` counter,
    ``serve.slot_occupancy`` gauge (active/max_batch per step), and
    ``serve.submitted`` / ``serve.completed`` / ``serve.rejected``
    request counters.

    The KV cache lives on the device of ``params``. The parameters are cast
    to ``model_cfg.dtype`` once, here: the values the reference casts on
    every step, without a step reading the f32 tree again. Sampling at
    ``temperature > 0`` with a key is ``jax.random.categorical``'s: the
    argmax of the scaled logits plus ``prng.gumbel`` noise from the key,
    bit for bit in float32 and bfloat16. ``drain(key)`` hands the one key
    to every step, as the reference's does."""

    def __init__(self, params, model_cfg: TransformerConfig,
                 cfg: ServeConfig):
        self.params = tree_to(params, model_cfg.dtype)
        self.mcfg = model_cfg
        self.cfg = cfg
        self.device = self.params["embed"].device
        self.cache = init_kv_cache(model_cfg, cfg.max_batch, cfg.max_seq,
                                   device=self.device)
        self.slots: List[Optional[Request]] = [None] * cfg.max_batch

    def submit(self, prompt: np.ndarray) -> Optional[Request]:
        for i, s in enumerate(self.slots):
            if s is None:
                req = Request(prompt=prompt, remaining_prompt=len(prompt),
                              t_submit=time.perf_counter())
                self.slots[i] = req
                # joining slot restarts its cache position
                self.cache["pos"][i] = 0
                REGISTRY.counter("serve.submitted").inc()
                return req
        REGISTRY.counter("serve.rejected").inc()   # batch full
        return None

    def _next_tokens(self) -> np.ndarray:
        toks = np.zeros((self.cfg.max_batch, 1), np.int32)
        for i, req in enumerate(self.slots):
            if req is None or req.done:
                continue
            if req.remaining_prompt > 0:
                toks[i, 0] = req.prompt[len(req.prompt) - req.remaining_prompt]
            elif req.out:
                toks[i, 0] = req.out[-1]
        return toks

    def _pick(self, logits: torch.Tensor,
              key: Optional[prng.Key]) -> torch.Tensor:
        """Each row's next token from its logits (B, V): greedy, the first
        index on ties, or sampled."""
        if self.cfg.temperature > 0 and key is not None:
            noise = prng.gumbel(key, logits.shape, logits.dtype,
                                logits.device)
            # a tensor divisor: an IEEE division on any device (a CUDA
            # division by a Python scalar multiplies by its reciprocal)
            temp = torch.tensor(self.cfg.temperature, dtype=logits.dtype,
                                device=logits.device)
            return torch.argmax(noise + logits / temp, -1)
        return torch.argmax(logits, -1)

    def step(self, key: Optional[prng.Key] = None) -> int:
        """One engine step: feeds every active slot one token. Returns the
        number of active requests."""
        active = [i for i, r in enumerate(self.slots)
                  if r is not None and not r.done]
        REGISTRY.gauge("serve.slot_occupancy").set(
            len(active) / max(self.cfg.max_batch, 1))
        if not active:
            return 0
        with trace.device_span("serve.step", active=len(active)) as sp:
            toks = torch.from_numpy(self._next_tokens()).to(self.device)
            logits, self.cache = decode_step(self.params, self.cache, toks,
                                             self.mcfg)
            nxt = self._pick(logits[:, 0], key)
            # the host needs the tokens to feed the next step, as the
            # reference's np.asarray(nxt) does
            nxt = nxt.cpu().numpy()  # lint: disable=torch-host-sync
            sp.declare(nxt)
        REGISTRY.counter("serve.tokens").inc(len(active))
        REGISTRY.histogram("serve.tokens_per_step",
                           buckets=tuple(range(1, 257))).observe(len(active))
        now = time.perf_counter()
        for i in active:
            req = self.slots[i]
            if req.remaining_prompt > 0:
                req.remaining_prompt -= 1
                if req.remaining_prompt == 0 and req.new_tokens == 0:
                    req.out.append(int(nxt[i]))   # first generated token
                    req.new_tokens = 1
            else:
                req.out.append(int(nxt[i]))
                req.new_tokens += 1
            if req.new_tokens >= self.cfg.max_new_tokens:
                req.done = True
                req.t_done = now
                REGISTRY.counter("serve.completed").inc()
                REGISTRY.histogram("serve.request_latency_s").observe(
                    now - req.t_submit)
                self.slots[i] = None if req.done else req
        return len(active)

    def state_summary(self) -> Dict[str, Any]:
        """Engine state for diagnostics (attached to the drain guard's
        error): per-slot progress plus the serving config bounds."""
        return {
            "max_batch": self.cfg.max_batch,
            "max_new_tokens": self.cfg.max_new_tokens,
            "slots": [None if r is None else
                      {"remaining_prompt": r.remaining_prompt,
                       "new_tokens": r.new_tokens, "done": r.done,
                       "out_len": len(r.out)}
                      for r in self.slots],
        }

    def drain(self, key: Optional[prng.Key] = None,
              max_steps: Optional[int] = None) -> int:
        """Step until every request completes; returns the step count.

        Guarded against hanging: by default ``max_steps`` is derived from
        the pending work — each active request needs at most
        ``remaining_prompt + (max_new_tokens - new_tokens)`` steps, and no
        new work can join mid-drain, so the sum over pending requests is a
        hard upper bound. Exceeding the bound raises ``RuntimeError`` with
        the engine state attached (``.engine_state``) instead of looping
        forever (e.g. on a corrupted slot or a non-positive
        ``max_new_tokens``)."""
        if max_steps is None:
            pending = [r for r in self.slots
                       if r is not None and not r.done]
            max_steps = sum(
                r.remaining_prompt +
                max(self.cfg.max_new_tokens - r.new_tokens, 1)
                for r in pending)
        steps = 0
        with trace.span("serve.drain", max_steps=max_steps) as sp:
            while self.step(key):
                steps += 1
                if steps > max_steps:
                    state = self.state_summary()
                    err = RuntimeError(
                        f"ServeEngine.drain exceeded its step bound "
                        f"({max_steps} steps for the pending work) without "
                        f"completing every request — engine state: {state}")
                    err.engine_state = state
                    raise err
            sp.set(steps=steps)
        return steps


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


class RagEngine:
    """Retrieval-augmented serving: the frontend's top passage is prepended
    to the prompt and decoded through the continuous-batching engine."""

    def __init__(self, frontend: RetrievalFrontend, engine: ServeEngine,
                 passage_tokens: Callable[[int], np.ndarray], *,
                 ctx_tokens: int = 24):
        self.frontend = frontend
        self.engine = engine
        self.passage_tokens = passage_tokens   # global id -> i32[tokens]
        self.ctx_tokens = ctx_tokens

    def submit_query(self, raw_query, query_tokens: np.ndarray, *,
                     k: int = 1):
        """Retrieve for one query and enqueue its RAG prompt; returns
        (request-or-None, retrieved ids i32[k])."""
        ids = self.frontend.retrieve([raw_query], k=k)[0]
        hit = bool(ids.size and ids[0] >= 0)
        REGISTRY.counter("serve.rag.ctx_hit" if hit
                         else "serve.rag.ctx_miss").inc()
        ctx = (self.passage_tokens(int(ids[0]))[:self.ctx_tokens]
               if hit else np.zeros((0,), np.int32))
        prompt = np.concatenate([np.asarray(query_tokens, np.int32),
                                 np.asarray(ctx, np.int32)])
        return self.engine.submit(prompt), ids


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
