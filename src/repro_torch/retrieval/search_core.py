"""Search core front door — Layer 3 (port of
``repro/retrieval/search_core.py``).

One :class:`SearchSession` builds an index once and answers many query
batches; the experiment grid and the evaluation CLI route through it.

Configuration is one declarative :class:`SearchConfig`:

  * ``engine``  — a registered retrieval engine (retrieval/engines.py);
  * ``backend`` — a registered scoring backend (retrieval/backends.py),
    ``None`` for the device's default (``cuda`` on a card, ``torch`` on the
    CPU); naming ``cuda`` on the CPU is an error;
  * ``sharded`` / ``mesh`` (a ``DeviceMesh``, launch/mesh.py) — route
    searches through the mesh-partitioned Layer 2 (retrieval/sharded.py),
    one rank per device;
  * ``streamed`` / ``stream_chunk`` — shard the corpus from birth: the
    host array is streamed chunk-wise into each rank's buffer
    (distributed/sharded_corpus.ShardedCorpus) and the index is built per
    shard (retrieval/sharded.sharded_build), so no device holds the global
    corpus or index; passing a ``ShardedCorpus`` as ``corpus_vecs`` does
    the same (both imply ``sharded=True``);
  * ``query_chunk`` — chunked multi-query batching;
  * ``engine_opts`` — hyper-parameter overrides (``dataclasses.replace``).

Every index build publishes the CUDA allocator's peak as the
``build.peak_bytes_per_device`` gauge (``obs/memory``), and each chunk's
span carries the launch params its kernel wrappers resolved
(``tuned_blocks``, ``kernels/tuning``) while tracing is on.

``k`` is clamped to the indexed corpus size and padded back with -1 ids,
so tiny sampled corpora never crash a search.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.device import (check_runs_on, default_backend, on_device,
                                resolve_device)
from repro_torch.distributed.sharded_corpus import ShardedCorpus
from repro_torch.kernels import tuning
from repro_torch.obs import memory as obs_memory
from repro_torch.obs import trace
from repro_torch.retrieval.backends import get_backend
from repro_torch.retrieval.engines import get_retrieval_engine
from repro_torch.retrieval.sharded import sharded_build, sharded_search


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Declarative search-core configuration (engine × backend × shard)."""

    engine: str = "exact"
    backend: Optional[str] = None   # None -> device default
    sharded: bool = False
    mesh: Any = None                # DeviceMesh when sharded
    streamed: bool = False          # shard-local build from birth
    stream_chunk: int = 65536       # host->device streaming chunk rows
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
        born = corpus_vecs if isinstance(corpus_vecs, ShardedCorpus) else None
        if born is None and cfg.streamed:
            if cfg.mesh is None:
                raise ValueError("streamed build needs a mesh; pass "
                                 "SearchConfig(mesh=...) (launch.mesh "
                                 "helpers)")
            born = ShardedCorpus.from_host(corpus_vecs, mesh=cfg.mesh,
                                           chunk_rows=cfg.stream_chunk,
                                           device=self.device)
        if born is not None:
            # a sharded-from-birth corpus forces the sharded query plans
            if not on_device(born.vecs, self.device):
                raise ValueError(
                    f"ShardedCorpus lives on {born.vecs.device}; the session "
                    f"runs on {self.device}")
            cfg = dataclasses.replace(cfg, sharded=True, streamed=True,
                                      mesh=born.mesh)
        if cfg.sharded and cfg.mesh is None:
            raise ValueError("sharded search needs a mesh; pass "
                             "SearchConfig(mesh=...) (launch.mesh helpers)")
        if cfg.sharded and cfg.backend == "int8" and born is None:
            # lifted on the born path (per-shard scales + float rerank);
            # the global-partition path keeps the rejection
            raise ValueError(
                "sharded search does not support the 'int8' backend (the "
                "row-shard padding sentinel would destroy the quantization "
                "scale); use backend='torch' or 'cuda'")
        if cfg.engine_opts:
            engine = dataclasses.replace(engine, **dict(cfg.engine_opts))
        self.config = cfg
        self.engine = dataclasses.replace(engine, backend=cfg.backend)
        if born is not None:
            self.corpus_size = born.n
        else:
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
                n=self.corpus_size, streamed=born is not None,
                shards=born.num_shards if born is not None else 1) as sp:
            bkey = key if key is not None else prng.prng_key(0)
            if born is not None:
                self.index = sharded_build(self.engine, born, bkey)
            else:
                self.index = self.engine.build(bkey, vecs)
            sp.declare(self.index)
        obs_memory.record_build_peak()

    def _search_chunk(self, queries: torch.Tensor, k: int):
        cfg = self.config
        mark = tuning.resolution_mark() if trace.is_enabled() else 0
        with trace.device_span(
                "search.chunk",
                compile_key=(f"search.chunk/{cfg.engine}/{cfg.backend}/"
                             f"{self.corpus_size}/{queries.shape[0]}/{k}"),
                engine=cfg.engine, backend=cfg.backend,
                n=self.corpus_size, q=int(queries.shape[0]), k=k,
                sharded=cfg.sharded) as sp:
            if cfg.sharded:
                scores, ids = sharded_search(self.engine, self.index,
                                             queries, k=k, mesh=cfg.mesh)
            else:
                scores, ids = self.engine.search_scored(self.index, queries,
                                                        k=k)
            sp.declare(ids)
            blocks = tuning.resolutions_since(mark)
            if blocks:
                # the launch params of each kernel wrapper this chunk
                # dispatched (every call resolves: there is no trace cache)
                sp.set(tuned_blocks=[
                    {"kernel": b["kernel"], "params": b["params"],
                     "tuned": b["tuned"]} for b in blocks])
        # the session answers in host arrays: one read of each chunk's
        # lint: disable=torch-host-sync
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
