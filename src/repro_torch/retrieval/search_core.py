"""Search core front door — Layer 3 (port of
``repro/retrieval/search_core.py``, single device).

One :class:`SearchSession` builds an index once and answers many query
batches; the experiment grid and the evaluation CLI route through it.

Configuration is one declarative :class:`SearchConfig`:

  * ``engine``  — a registered retrieval engine (retrieval/engines.py);
  * ``backend`` — a registered scoring backend (retrieval/backends.py),
    ``None`` for the device's default (``cuda`` on a card, ``torch`` on the
    CPU); naming ``cuda`` on the CPU is an error;
  * ``query_chunk`` — chunked multi-query batching;
  * ``engine_opts`` — hyper-parameter overrides (``dataclasses.replace``).

The reference's ``sharded`` / ``streamed`` / ``mesh`` search waits for the
multi-device port (ROADMAP queue 1 item 12). ``k`` is clamped to the
indexed corpus size and padded back with -1 ids, so tiny sampled corpora
never crash a search.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.device import check_runs_on, default_backend, resolve_device
from repro_torch.obs import trace
from repro_torch.retrieval.backends import get_backend
from repro_torch.retrieval.engines import get_retrieval_engine


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Declarative search-core configuration (engine × backend)."""

    engine: str = "exact"
    backend: Optional[str] = None   # None -> device default
    query_chunk: int = 256
    engine_opts: Optional[Mapping[str, Any]] = None


class SearchSession:
    """Build-once, chunked multi-query search over one corpus on ``device``.

    ``corpus_vecs`` f32[N, D] (numpy or tensor) are indexed once at
    construction; ``search`` then answers any number of query batches.
    When ``ids_map`` is given (the sample's kept entity ids), results map
    from index-local rows back to global ids, with -1 for misses.
    """

    def __init__(self, corpus_vecs, config: Optional[SearchConfig] = None,
                 *, key: Optional[prng.Key] = None,
                 ids_map: Optional[np.ndarray] = None, device="cuda",
                 **overrides):
        cfg = config or SearchConfig()
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        self.device = resolve_device(device)
        engine = get_retrieval_engine(cfg.engine)    # registry error UX
        backend = get_backend(cfg.backend or default_backend(self.device))
        check_runs_on("backend", backend.name, backend.needs_cuda,
                      self.device)
        cfg = dataclasses.replace(cfg, backend=backend.name)
        if cfg.engine_opts:
            engine = dataclasses.replace(engine, **dict(cfg.engine_opts))
        self.config = cfg
        self.engine = dataclasses.replace(engine, backend=cfg.backend)
        vecs = torch.as_tensor(corpus_vecs).to(self.device)
        self.corpus_size = int(vecs.shape[0])
        self.ids_map = None if ids_map is None else np.asarray(ids_map)
        if self.ids_map is not None and self.ids_map.size != self.corpus_size:
            raise ValueError(
                f"ids_map has {self.ids_map.size} entries for a corpus of "
                f"{self.corpus_size} vectors")
        with trace.device_span(
                "search.build",
                compile_key=f"search.build/{cfg.engine}/{cfg.backend}",
                engine=cfg.engine, backend=cfg.backend,
                n=self.corpus_size) as sp:
            bkey = key if key is not None else prng.prng_key(0)
            self.index = self.engine.build(bkey, vecs)
            sp.declare(self.index)

    def _search_chunk(self, queries: torch.Tensor, k: int):
        cfg = self.config
        with trace.device_span(
                "search.chunk",
                compile_key=(f"search.chunk/{cfg.engine}/{cfg.backend}/"
                             f"{self.corpus_size}/{queries.shape[0]}/{k}"),
                engine=cfg.engine, backend=cfg.backend,
                n=self.corpus_size, q=int(queries.shape[0]), k=k) as sp:
            scores, ids = self.engine.search_scored(self.index, queries, k=k)
            sp.declare(ids)
        return scores.cpu().numpy(), ids.cpu().numpy()

    def search_scored(self, queries, *, k: int):
        """(scores f32[Q, k], ids i32[Q, k]) numpy arrays for a query batch —
        -inf/-1 padding for misses, chunked by ``query_chunk``, ids mapped
        through ``ids_map`` when set."""
        q = torch.as_tensor(queries).to(self.device)
        k_eff = max(1, min(k, self.corpus_size))
        chunk = self.config.query_chunk
        parts = [self._search_chunk(q[i:i + chunk], k_eff)
                 for i in range(0, q.shape[0], chunk)]
        if parts:
            scores = np.concatenate([p[0] for p in parts], 0)
            local = np.concatenate([p[1] for p in parts], 0)
        else:
            scores = np.full((0, k_eff), -np.inf, np.float32)
            local = np.zeros((0, k_eff), np.int32)
        if k_eff < k:
            scores = np.pad(scores, ((0, 0), (0, k - k_eff)),
                            constant_values=-np.inf)
            local = np.pad(local, ((0, 0), (0, k - k_eff)),
                           constant_values=-1)
        if self.ids_map is not None:
            local = np.where(local >= 0,
                             self.ids_map[np.clip(local, 0, None)], -1)
        return scores, local

    def search(self, queries, *, k: int) -> np.ndarray:
        """Top-k ids i32[Q, k] for a query batch (-1 padding for misses)."""
        return self.search_scored(queries, k=k)[1]
