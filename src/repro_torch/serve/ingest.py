"""Incremental corpus ingestion for the serving tier (port of
``repro/serve/ingest.py``; DESIGN.md §14).

A :class:`LiveIndex` is a :class:`~repro_torch.retrieval.search_core.
SearchSession` that accepts new documents while it serves: ``append(docs)``
lands rows in a fixed-capacity append buffer on the device that every
search scans alongside the frozen index, and a compaction threshold
triggers a background rebuild through the normal session build path
(``sharded_build`` on the streamed path) — serving never stops for a
reindex.

Dataflow per search::

    queries ──> frozen SearchSession.search_scored ──┐
            └─> append-buffer exact scan ────────────┴─> score merge, top-k

The two sides merge by score, which works because every engine's
``search_scored`` returns its FINAL ranking scores as inner products
(lsh must therefore run with ``rerank > 0`` — enforced at construction;
the no-rerank Hamming scale is not comparable to a dot product). The
buffer is scanned in f32 whatever the session backend: buffers are small,
and quantization is a bandwidth optimisation for the big frozen index,
not its tail. The scan is one ``torch.matmul`` (in full f32: TF32 stays
off, PyTorch's default, since the merge compares its scores with the
frozen side's f32-accurate ones) and a stable sort, so equal scores go to
the lowest position as ``lax.top_k``'s do. Both sides come back to the
host, where the merge runs as the reference's: frozen columns first, a
stable descending sort, so ties go to the frozen side.

tf-idf is the one engine whose index statistics go stale under appends:
the frozen rows have ``w = log1p(n/df)`` folded in at build time. The
O(D) document-frequency vector is kept exactly (integer counts) and the
refreshed weights fold into the QUERY: ``q ⊙ (w_live / w_frozen)`` scores
the frozen rows as a rebuild would, and ``q ⊙ w_live`` scores the raw
buffer rows — so append-then-search stays set-equal to a rebuild without
touching the index.

Buffer mechanics: capacity grows by doubling; the live-row count is a
host integer every search snapshots under the lock. An append within
capacity writes its rows into the buffer IN PLACE, which is safe because
it writes only rows at or past the pending count: a search that took its
snapshot before the append holds a smaller count and masks those rows to
−inf (the reference's ``_buffer_write`` is not donated for the same
reason). Growth and compaction make a NEW buffer tensor, so a snapshot
keeps the one it took. On the sharded path the buffer is one more
shard-local structure (``distributed/sharded_corpus.sharded_row_buffer``,
re-streamed at every append: it is small by construction) merged through
``retrieval/sharded.sharded_buffer_topk``.

Compaction: when pending rows reach ``compact_threshold``, the pending
prefix is folded into a NEW session built from the host mirror — on a
worker thread with ``background=True``, which also makes the host copy of
the grown corpus, on the session's device (the
worker sets it; on one card both threads enqueue on the legacy default
stream, so their device work is ordered) — while searches keep hitting
the old (session, buffer) snapshot. On one rank the worker swaps its
build in itself, under the lock, as soon as it is done (as the
reference's does), so ``frozen_n``, ``pending_rows`` and the
``serve.ingest`` metrics read the new state, and the old frozen index is
freed, without a further call of the index: rows appended mid-build stay
pending, and ids are stable across compactions (append order is the
global id order). A failed build is kept and raised by the next call
(``search_scored``, ``append``, ``compact``, ``flush``), and the index
keeps serving the old snapshot. The landing swaps host arrays and makes
a new append buffer on the device; on a 1-rank streamed mesh that buffer
is the rank's own block (``sharded_row_buffer``), which reads the mesh's
groups but runs no collective on them.

Several ranks (the sharded path): every rank runs the same calls in the
same order, each a collective, and two rules keep the compactor's
collectives apart from the searches'. (1) On the streamed path a
background build's collectives run on process groups of the index's own
(``collectives.new_axis_group``): the build gets a copy of the mesh whose
cache of groups (``collectives.axis_group``) holds them for the corpus
axes, the only axes a build's collectives run over, and the landed
session goes back to the mesh itself. So the worker's collectives never
share a communicator with the main thread's, whose relative order differs
from rank to rank, nor with another index's worker. (2) A finished build
lands not from the worker but at a call point, once every rank's has:
each call while a compaction is in flight all-reduces two flags (a build
still running, a build failed) over the search mesh, so every rank swaps
(or raises) at the same call.

An index takes its groups when it is built and gives them back at
:meth:`LiveIndex.close` (a tenant's eviction, serve/tenants.py) to a free
list kept on the mesh, from which the next index built there takes them;
only when that list is empty are new groups made, collectively. Every
rank builds and closes its indexes at the same calls, so every rank takes
the same groups, and a server whose tenants churn holds at most one set a
resident index (and one for the index built before an eviction). A
closed index still answers searches and takes appends but compacts no
more, since its groups may already serve another index.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.device import resolve_device
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharded_corpus import (resolve_corpus_axes,
                                                    sharded_row_buffer)
from repro_torch.obs import REGISTRY, trace
from repro_torch.obs.locks import make_lock, make_rlock
from repro_torch.obs.metrics import Registry
from repro_torch.retrieval.search_core import SearchConfig, SearchSession
from repro_torch.retrieval.sharded import _top, sharded_buffer_topk

__all__ = ["IngestConfig", "LiveIndex"]


@dataclasses.dataclass(frozen=True)
class IngestConfig:
    """Live-ingest knobs.

    ``append_cap`` is the initial device-buffer capacity in rows (grows by
    doubling); ``compact_threshold`` is the pending-row count that
    triggers a rebuild; ``background=False`` compacts inline
    (deterministic; tests and single-threaded callers)."""

    append_cap: int = 256
    compact_threshold: int = 4096
    background: bool = True


def _buffer_topk(queries: torch.Tensor, buf: torch.Tensor, n_valid: int, *,
                 k: int, id_base: int):
    """Exact top-k over the (single-device) append buffer: rows at position
    >= ``n_valid`` mask to -inf and can never displace a live row; equal
    scores go to the lowest position; ids offset by the frozen size, -1
    where the score is not finite."""
    s = (queries @ buf.T).to(torch.float32)
    pos = torch.arange(buf.shape[0], device=buf.device)
    s = torch.where((pos < n_valid)[None, :], s, -torch.inf)
    top_s, top_p = _top(s, k)
    top_i = torch.where(torch.isfinite(top_s), id_base + top_p, -1)
    return top_s, top_i.to(torch.int32)


_FREE_GROUPS = make_lock("compactor-groups")


def _take_groups(mesh, axes: tuple) -> dict:
    """A compaction worker's process groups over ``axes`` of ``mesh``,
    {axes: group}: a set a closed index gave back (the mesh's free list),
    else a new one (collective)."""
    with _FREE_GROUPS:
        free = mesh.__dict__.setdefault("_compactor_groups", {})
        if free.get(axes):
            return free[axes].pop()
    return {axes: coll.new_axis_group(mesh, axes)}


def _give_groups(mesh, groups: dict) -> None:
    with _FREE_GROUPS:
        free = mesh.__dict__.setdefault("_compactor_groups", {})
        for axes in groups:
            free.setdefault(axes, []).append(groups)


def _df_counts(rows: np.ndarray) -> np.ndarray:
    return (np.asarray(rows) > 0).sum(axis=0).astype(np.int64)


def _host_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


class LiveIndex:
    """Build-once-append-forever search target: a frozen
    :class:`SearchSession` plus a live append buffer, one ``search``/
    ``search_scored`` contract (scores f32[Q, k], ids i32[Q, k] numpy,
    -inf/-1 padding), ids stable across compactions. Runs on ``device``
    (``cuda`` by default; the tests pass ``cpu``).

    Metrics (the shared registry): ``serve.ingest.appended`` rows counter,
    ``serve.ingest.pending`` gauge, ``serve.ingest.compactions`` counter
    (one a landed compaction), ``serve.ingest.searches`` counter; a
    compaction's build runs under a ``serve.compact`` span.
    """

    def __init__(self, corpus_vecs, config: Optional[SearchConfig] = None,
                 *, key: Optional[prng.Key] = None,
                 ingest: Optional[IngestConfig] = None,
                 registry: Registry = REGISTRY, device="cuda",
                 **overrides):
        self._host = np.ascontiguousarray(_host_f32(corpus_vecs))
        if self._host.ndim != 2:
            raise ValueError(
                f"live corpus must be 2-D (N, D); got {self._host.shape}")
        self._lock = make_rlock("live-index")
        self.ingest = ingest or IngestConfig()
        if self.ingest.append_cap < 1 or self.ingest.compact_threshold < 1:
            raise ValueError("append_cap and compact_threshold must be >= 1")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # the card this thread runs on, named for the worker thread
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._key = key if key is not None else prng.prng_key(0)
        self._registry = registry
        self._session = SearchSession(self._host, config, key=self._key,
                                      device=self.device, **overrides)
        cfg = self._session.config
        if cfg.engine == "lsh" and self._session.engine.rerank <= 0:
            raise ValueError(
                "live ingest needs score-comparable results to merge the "
                "append buffer; the lsh engine must run with rerank > 0 "
                "(no-rerank lsh ranks by Hamming distance, which cannot "
                "merge with the buffer's inner products)")
        self._tfidf = cfg.engine == "tfidf"
        self._frozen_df = (_df_counts(self._host) if self._tfidf else None)
        self._pending = np.zeros((0, self.dim), np.float32)
        self._cap = 0
        self._buf = None
        # compaction state: _compacting from the trigger to the landing.
        # One rank: the worker lands its build and leaves a failure in
        # _compact_error. Several: the worker leaves its build, or its
        # failure, in _built, and both trigger and landing are call
        # points, so every rank agrees on _compacting
        self._compacting = False
        self._compactor: Optional[threading.Thread] = None
        self._built = None
        self._compact_error: Optional[BaseException] = None
        self._closed = False
        self._ranks, self._groups = 1, None
        if cfg.sharded:
            axes = resolve_corpus_axes(cfg.mesh, None)
            self._ranks = coll.axis_size(cfg.mesh, axes)
            if cfg.streamed:
                self._groups = _take_groups(cfg.mesh, axes)

    # -- geometry ----------------------------------------------------------
    # Every property below reads state a landing swaps under the lock; the
    # RLock is re-entrant, so holders of the lock can use them freely.

    @property
    def dim(self) -> int:
        with self._lock:
            return int(self._host.shape[1])

    @property
    def frozen_n(self) -> int:
        """Rows covered by the frozen index (grows at each compaction)."""
        with self._lock:
            return self._session.corpus_size

    @property
    def pending_rows(self) -> int:
        with self._lock:
            return int(self._pending.shape[0])

    @property
    def n(self) -> int:
        """Total searchable rows (frozen + pending)."""
        with self._lock:
            return self.frozen_n + self.pending_rows

    @property
    def config(self) -> SearchConfig:
        with self._lock:
            return self._session.config

    # -- ingest ------------------------------------------------------------

    def _rebuild_buffer(self) -> None:
        """Make a new device buffer from the pending host rows (capacity
        growth, a compaction's landing, or any sharded append). Takes the
        (re-entrant) lock itself: callers already hold it, but the buffer
        swap must never run bare."""
        with self._lock:
            cfg = self._session.config
            need = max(self.pending_rows, 1)
            cap = max(self._cap, self.ingest.append_cap)
            while cap < need:
                cap *= 2
            self._cap = cap
            if cfg.sharded:
                self._buf = sharded_row_buffer(
                    self._pending, capacity=cap, dim=self.dim,
                    mesh=cfg.mesh, chunk_rows=cfg.stream_chunk,
                    device=self.device)
            else:
                buf = torch.zeros((cap, self.dim), dtype=torch.float32,
                                  device=self.device)
                buf[:self.pending_rows] = torch.from_numpy(self._pending)
                self._buf = buf

    def append(self, docs) -> Tuple[int, int]:
        """Land new document vectors f32[m, D]; returns their global id
        range [start, stop) — stable across compactions (append order is
        the id order). May trigger a (background) compaction."""
        rows = _host_f32(docs).reshape(-1, self.dim)
        if rows.shape[0] == 0:
            return self.n, self.n
        self._land()
        with self._lock, trace.span("serve.ingest.append",
                                    rows=int(rows.shape[0])):
            start = self.frozen_n + self.pending_rows
            old = self.pending_rows
            self._pending = np.concatenate([self._pending, rows], axis=0)
            if self._session.config.sharded or self._buf is None \
                    or self.pending_rows > self._cap:
                self._rebuild_buffer()
            else:
                # in place at rows >= old: every snapshot masks them
                self._buf[old:self.pending_rows] = torch.from_numpy(
                    self._pending[old:])
            self._registry.counter("serve.ingest.appended").inc(
                int(rows.shape[0]))
            self._registry.gauge("serve.ingest.pending").set(
                self.pending_rows)
            stop = start + int(rows.shape[0])
            full = self.pending_rows >= self.ingest.compact_threshold
        if full:
            self.compact(background=self.ingest.background)
        return start, stop

    # -- search ------------------------------------------------------------

    def _weights(self, frozen_n: int, frozen_df, pending: np.ndarray):
        """(w_frozen, w_live) for the tf-idf query-side refresh: the df
        vector is O(D) and kept exactly (integer counts), so the live
        weights equal what a rebuild over frozen+pending rows would fold
        into the corpus."""
        total = frozen_n + pending.shape[0]
        df_frozen = frozen_df.astype(np.float32) + 1.0
        df_live = (frozen_df + _df_counts(pending)).astype(np.float32) + 1.0
        w_frozen = np.log1p(np.float32(frozen_n) / df_frozen)
        w_live = np.log1p(np.float32(total) / df_live)
        return w_frozen, w_live

    def search_scored(self, queries, *, k: int):
        """(scores f32[Q, k], ids i32[Q, k]) over frozen + pending rows —
        one consistent snapshot: every row appended before this call is
        visible, during a compaction included."""
        self._land()
        with self._lock:
            session = self._session
            buf, n_pend, cap = self._buf, self.pending_rows, self._cap
            frozen_n = session.corpus_size
            frozen_df = self._frozen_df
            pending = self._pending
        self._registry.counter("serve.ingest.searches").inc()
        q = _host_f32(queries)
        total = frozen_n + n_pend
        k_eff = max(1, min(k, total))
        q_frozen = q
        if self._tfidf and n_pend:
            w_frozen, w_live = self._weights(frozen_n, frozen_df, pending)
            q_frozen = q * (w_live / np.maximum(w_frozen, 1e-30))[None, :]
            q_buf = q * w_live[None, :]
        else:
            q_buf = q
        fs, fi = session.search_scored(q_frozen, k=k_eff)
        if n_pend == 0:
            if k_eff < k:
                fs = np.pad(fs, ((0, 0), (0, k - k_eff)),
                            constant_values=-np.inf)
                fi = np.pad(fi, ((0, 0), (0, k - k_eff)),
                            constant_values=-1)
            return fs, fi
        cfg = session.config
        k_buf = min(k_eff, cap)   # cap from the snapshot: matches buf's shape
        qb = torch.tensor(q_buf, device=self.device)
        if cfg.sharded:
            bs, bi = sharded_buffer_topk(buf, n_pend, qb, k=k_buf,
                                         mesh=cfg.mesh, id_base=frozen_n)
        else:
            bs, bi = _buffer_topk(qb, buf, n_pend, k=k_buf, id_base=frozen_n)
        # the frozen side comes back as host arrays and the merge runs on
        # the host, as the reference's: one read of the buffer's top-k
        # lint: disable=torch-host-sync
        bs, bi = bs.cpu().numpy(), bi.cpu().numpy()
        scores = np.concatenate([fs, bs], axis=1)
        ids = np.concatenate([fi, bi], axis=1)
        # stable descending merge: ties break toward the frozen side (the
        # backend tie policy's lower-id-first, since pending ids are >=
        # frozen ids)
        order = np.argsort(-scores, axis=1, kind="stable")[:, :k_eff]
        scores = np.take_along_axis(scores, order, axis=1)
        ids = np.take_along_axis(ids, order, axis=1)
        ids = np.where(np.isfinite(scores), ids, -1)
        if k_eff < k:
            scores = np.pad(scores, ((0, 0), (0, k - k_eff)),
                            constant_values=-np.inf)
            ids = np.pad(ids, ((0, 0), (0, k - k_eff)),
                         constant_values=-1)
        return scores, ids

    def search(self, queries, *, k: int) -> np.ndarray:
        """Top-k ids i32[Q, k] (-1 padding), frozen + pending rows."""
        return self.search_scored(queries, k=k)[1]

    # -- compaction --------------------------------------------------------

    def _build(self, host: np.ndarray, folded: np.ndarray,
               cfg: SearchConfig, groups: Optional[dict] = None):
        """The compacted frozen side, (rows, session, df), for the frozen
        ``host`` rows then the ``folded`` pending ones: the host copy and
        the build both run on the calling thread, on the index's device
        and, given ``groups`` (a worker thread on the streamed path), with
        the build's collectives on them: the build sees a copy of the mesh
        whose group cache holds them, and the session it returns searches
        on the mesh itself."""
        build_cfg = cfg
        if groups is not None:
            alias = copy.copy(cfg.mesh)
            alias.__dict__["_axis_groups"] = dict(groups)
            build_cfg = dataclasses.replace(cfg, mesh=alias)
        with contextlib.ExitStack() as stack:
            if self.device.type == "cuda":
                stack.enter_context(torch.cuda.device(self.device))
            stack.enter_context(trace.span(
                "serve.compact", rows=int(host.shape[0] + folded.shape[0]),
                folded=int(folded.shape[0])))
            host_new = np.concatenate([host, folded], axis=0)
            session = SearchSession(host_new, build_cfg, key=self._key,
                                    device=self.device)
        if groups is not None:
            session.config = dataclasses.replace(session.config,
                                                 mesh=cfg.mesh)
        return (host_new, session,
                _df_counts(host_new) if self._tfidf else None)

    def _swap(self, folded: int, host_new: np.ndarray, session,
              df_new) -> None:
        with self._lock, trace.span(
                "serve.ingest.land", folded=folded,
                thread=threading.current_thread().name):
            self._host = host_new
            self._session = session
            self._frozen_df = df_new
            self._pending = self._pending[folded:]
            self._rebuild_buffer()
            self._registry.gauge("serve.ingest.pending").set(
                self.pending_rows)
        self._registry.counter("serve.ingest.compactions").inc()

    def _land(self) -> None:
        """Raise a failed background compaction (then the old snapshot
        keeps serving); with several ranks, also swap in a finished one.
        On one rank the worker has landed its own build. With several
        this waits for no build but lands only once every rank's has
        finished, agreed by one all-reduce over the search mesh."""
        with self._lock:
            if self._ranks == 1:
                err, self._compact_error = self._compact_error, None
                if not self._compacting:
                    self._compactor = None
            elif self._compactor is None:
                return
            built, worker = self._built, self._compactor
        if self._ranks == 1:
            if err is not None:
                raise RuntimeError("background compaction failed") from err
            return
        cfg = self.config
        flags = torch.tensor(
            [built is None, isinstance(built, BaseException)],
            dtype=torch.int32, device=self.device)
        # every rank reads the agreed flags to land (or raise) at this call
        # lint: disable=torch-host-sync
        running, failed = coll.all_reduce(
            flags, cfg.mesh, resolve_corpus_axes(cfg.mesh, None),
            op="max").tolist()
        if running:
            return
        worker.join()
        with self._lock:
            self._compactor, self._built = None, None
            self._compacting = False
        if isinstance(built, BaseException):
            raise RuntimeError("background compaction failed") from built
        if failed:
            raise RuntimeError("background compaction failed on another "
                               "rank; this rank's build is dropped")
        self._swap(*built)

    def compact(self, *, background: Optional[bool] = None,
                wait: bool = False) -> bool:
        """Fold the current pending rows into a fresh frozen index.

        The rebuild runs on a worker thread (``background=True``) while
        searches keep hitting the old snapshot; rows appended mid-build
        stay pending and remain searchable throughout. Returns False when
        a compaction is already in flight, nothing is pending or the index
        is closed."""
        background = (self.ingest.background if background is None
                      else background)
        self._land()
        with self._lock:
            if self._closed:
                return False
            in_flight = self._compacting
            if not in_flight:
                m = self.pending_rows
                if m == 0:
                    return False
                # both arrays are replaced, never written, by later calls
                host, folded = self._host, self._pending[:m]
                cfg, groups = self._session.config, self._groups
                self._compacting = True
                if background:
                    # started under the lock, so close() finds it to join
                    self._compactor = threading.Thread(
                        target=self._compact_worker,
                        args=(m, host, folded, cfg, groups),
                        name="live-index-compact", daemon=True)
                    self._compactor.start()
        if in_flight:
            if wait:
                self.flush()
            return False
        if not background:
            try:
                built = self._build(host, folded, cfg)
            finally:
                with self._lock:
                    self._compacting = False
            self._swap(m, *built)
            return True
        if wait:
            self.flush()
        return True

    def _compact_worker(self, m: int, host: np.ndarray, folded: np.ndarray,
                        cfg: SearchConfig, groups: Optional[dict]) -> None:
        """The background compaction: build, then on one rank land the
        build (or keep its failure for the next call); with several ranks
        leave it in ``_built`` for the call that all of them land it at."""
        out = RuntimeError("the compaction worker stopped early")
        try:
            out = (m, *self._build(host, folded, cfg, groups))
            if self._ranks == 1:
                self._swap(*out)
        except Exception as e:   # raised by the next call
            out = e
        finally:
            with self._lock:
                if self._ranks > 1:
                    self._built = out
                else:
                    self._compacting = False
                    if isinstance(out, BaseException):
                        self._compact_error = out

    def flush(self) -> None:
        """Block until any in-flight compaction lands (tests, shutdown, a
        tenant's eviction); raises its failure."""
        with self._lock:
            t = self._compactor
        if t is not None:
            t.join()
        self._land()

    def close(self) -> None:
        """Let any in-flight compaction land, then give this index's
        compaction groups back to its mesh for the next index built there
        (a tenant's eviction). The index still answers searches and takes
        appends, but compacts no more."""
        with self._lock:
            self._closed = True
        self.flush()
        with self._lock:
            groups, self._groups = self._groups, None
        if groups is not None:
            _give_groups(self.config.mesh, groups)
