"""Sharded-from-birth corpora (port of
``repro/distributed/sharded_corpus.py``).

A host-resident corpus is streamed, chunk by chunk, straight into the
shard buffer of the rank that owns it, and everything downstream
(per-shard index construction in ``retrieval/sharded.py``, the shard-local
graph build in ``core/sharded_pipeline.py``) consumes the row-partitioned
array without ever gathering it. Peak memory a device is O(corpus /
n_shards + chunk).

The reference assembles one global ``jax.Array`` from the per-device
buffers; here each rank holds its own block, and the geometry (rows per
shard, zero-padded tail, queries per shard) is the reference's:

  * :class:`ShardedCorpus` — this rank's f32[rows_per_shard, D] block of
    the row-partitioned corpus (zero rows pad the tail shard; their global
    ids are >= n, and every consumer masks them).
  * :class:`ShardedQRels` — a QRel table routed by query shard at birth:
    shard ``q // queries_per_shard`` owns every row of query q, in the
    original row order (the stable compaction of
    ``core/sharded_pipeline._route_by_query``), invalid rows dropped.
    Each rank holds its (n_buf,) row of the reference's (d, n_buf) buffers.

Each rank copies its block ``chunk_rows`` rows at a time into a buffer
allocated once on its device, so the transient footprint is the shard
plus one chunk; each shard's transfer is a ``search.build.shard`` /
``sampling.graph.shard`` trace span. Every rank reads the host table (it
is host-resident) and routes it the same way, keeping only its own rows.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.collectives import (all_gather, axis_size,
                                                 flat_axis_index)
from repro_torch.distributed.sharding import (GNN_RULES, RETRIEVAL_RULES,
                                              partition_axes)
from repro_torch.obs import trace

__all__ = ["ShardedCorpus", "ShardedQRels", "sharded_row_buffer",
           "stream_to_sharded", "resolve_corpus_axes", "resolve_query_axes"]


def resolve_corpus_axes(mesh, axes: Optional[tuple]) -> tuple:
    """Mesh axes the corpus rows partition over (retrieval rule set)."""
    if axes is None:
        axes = partition_axes(mesh, "corpus", RETRIEVAL_RULES)
    axes = tuple(axes) if axes else ()
    if not axes:
        raise ValueError(
            f"mesh {mesh} has none of the retrieval corpus axes "
            f"({RETRIEVAL_RULES['corpus']})")
    return axes


def resolve_query_axes(mesh, axes: Optional[tuple]) -> tuple:
    """Mesh axes the QRel query shards partition over (GNN rule set)."""
    if axes is None:
        axes = partition_axes(mesh, "queries", GNN_RULES)
    axes = tuple(axes) if axes else ()
    if not axes:
        raise ValueError(f"mesh {mesh} has none of the GNN query axes "
                         f"({GNN_RULES['queries']})")
    return axes


def _stream_block(block, device: torch.device, buf_rows: int, *,
                  chunk_rows: int) -> torch.Tensor:
    """Copy rows (a numpy array, or a tensor on any device) onto
    ``device`` as a new ``buf_rows``-row buffer (zero-padded tail),
    ``chunk_rows`` rows at a time."""
    if isinstance(block, np.ndarray):
        if block.shape[0] == buf_rows <= chunk_rows:
            return torch.from_numpy(np.array(block, copy=True)).to(device)
        block = torch.from_numpy(block)
    buf = torch.zeros((buf_rows,) + tuple(block.shape[1:]),
                      dtype=block.dtype, device=device)
    for r0 in range(0, block.shape[0], chunk_rows):
        chunk = block[r0:r0 + chunk_rows]
        buf[r0:r0 + chunk.shape[0]].copy_(chunk)
    return buf


def stream_to_sharded(host, mesh, axes: tuple, global_rows: int, *,
                      device="cuda", chunk_rows: int = 65536,
                      span: Optional[str] = None,
                      **span_attrs) -> torch.Tensor:
    """This rank's block of a leading-dim row partition of ``host`` (a
    numpy array, or a tensor already on a device) over ``axes`` into
    ``global_rows`` rows (rows beyond ``host.shape[0]`` are zero padding),
    streamed without more than the block and one chunk on the device."""
    if not isinstance(host, torch.Tensor):
        host = np.asarray(host)
    chunk_rows = max(1, int(chunk_rows))
    d = axis_size(mesh, axes)
    if global_rows % d:
        raise ValueError(f"{global_rows} rows do not split over {d} shards")
    rows = global_rows // d
    i = flat_axis_index(mesh, axes)
    start, stop = i * rows, (i + 1) * rows
    block = host[start:min(stop, host.shape[0])]
    dev = resolve_device(device)
    if span:
        with trace.span(span, shard=i, rows=int(block.shape[0]),
                        buf_rows=rows, **span_attrs):
            return _stream_block(block, dev, rows, chunk_rows=chunk_rows)
    return _stream_block(block, dev, rows, chunk_rows=chunk_rows)


class ShardedCorpus(NamedTuple):
    """Row-partitioned corpus vectors, sharded from birth: ``vecs`` is this
    rank's f32[rows_per_shard, D] block, ``n`` the true corpus row count
    (global rows run to rows_per_shard * num_shards)."""

    vecs: Any
    n: int
    mesh: Any
    axes: Tuple[str, ...]

    @property
    def num_shards(self) -> int:
        return axis_size(self.mesh, self.axes)

    @property
    def shard(self) -> int:
        return flat_axis_index(self.mesh, self.axes)

    @property
    def rows_per_shard(self) -> int:
        return self.vecs.shape[0]

    @property
    def dim(self) -> int:
        return self.vecs.shape[1]

    @property
    def pad(self) -> int:
        return self.rows_per_shard * self.num_shards - self.n

    @classmethod
    def from_host(cls, vecs, *, mesh, axes: Optional[tuple] = None,
                  chunk_rows: int = 65536, device="cuda",
                  span: str = "search.build.shard") -> "ShardedCorpus":
        """Stream a corpus f32[N, D] (host-resident, or a tensor a device
        already holds) into per-shard buffers."""
        if isinstance(vecs, torch.Tensor):
            host = vecs.to(torch.float32)
        else:
            host = np.asarray(vecs).astype(np.float32, copy=False)
        if host.ndim != 2:
            raise ValueError(f"corpus must be 2-D (N, D); got "
                             f"{tuple(host.shape)}")
        axes = resolve_corpus_axes(mesh, axes)
        d = axis_size(mesh, axes)
        n = int(host.shape[0])
        rows = -(-n // d)
        block = stream_to_sharded(host, mesh, axes, rows * d, device=device,
                                  chunk_rows=chunk_rows, span=span)
        return cls(block, n, mesh, axes)


def sharded_row_buffer(host_rows: np.ndarray, *, capacity: int, dim: int,
                       mesh, axes: Optional[tuple] = None,
                       chunk_rows: int = 65536, device="cuda",
                       span: str = "serve.ingest.shard") -> torch.Tensor:
    """This rank's block of a fixed-capacity row-sharded append buffer
    (the serving tier's live-ingest structure): the first
    ``len(host_rows)`` global rows carry the pending documents, the rest
    is zeroed spare capacity, in a corpus's geometry
    (ceil(capacity / d) rows a shard). Which rows are live is the caller's
    ``n_valid`` (retrieval/sharded.sharded_buffer_topk)."""
    host = np.asarray(host_rows, np.float32).reshape(-1, dim)
    if host.shape[0] > capacity:
        raise ValueError(f"{host.shape[0]} pending rows exceed the buffer "
                         f"capacity {capacity}")
    axes = resolve_corpus_axes(mesh, axes)
    d = axis_size(mesh, axes)
    rows = -(-max(int(capacity), 1) // d)
    return stream_to_sharded(host, mesh, axes, rows * d, device=device,
                             chunk_rows=chunk_rows, span=span)


class QRelRows(NamedTuple):
    """Flat QRel rows, field-compatible with ``core.graph_builder.
    QRelTable`` (defined here so ``table()`` needs no distributed -> core
    import)."""

    query_ids: Any
    entity_ids: Any
    scores: Any
    valid: Any


class ShardedQRels(NamedTuple):
    """Query-routed QRel buffers, sharded from birth.

    This rank's (n_buf,) row of four (d, n_buf) buffers: shard
    ``q // queries_per_shard`` owns every row of query q, in the original
    table's row order. Query ids are GLOBAL; invalid rows were dropped at
    routing time; unused slots have ``valid == 0``.
    """

    query_ids: Any    # i32[n_buf]
    entity_ids: Any   # i32[n_buf]
    scores: Any       # f32[n_buf]
    valid: Any        # i32[n_buf]
    num_queries: int
    num_entities: int
    queries_per_shard: int
    mesh: Any
    axes: Tuple[str, ...]

    @property
    def num_shards(self) -> int:
        return axis_size(self.mesh, self.axes)

    @property
    def buffer_rows(self) -> int:
        return self.query_ids.shape[0]

    def table(self) -> "QRelRows":
        """Every shard's routed rows as one flat :class:`QRelRows` (global
        query ids, shard-major order; all-gathered, so every rank holds
        it), what the per-draw stages consume: their result does not
        depend on the row order."""
        g = lambda x: all_gather(x, self.mesh, self.axes)
        return QRelRows(g(self.query_ids), g(self.entity_ids),
                        g(self.scores), g(self.valid).to(torch.bool))

    @classmethod
    def from_host(cls, qrels, *, num_queries: int, num_entities: int,
                  mesh, axes: Optional[tuple] = None,
                  chunk_rows: int = 65536, device="cuda",
                  span: str = "sampling.graph.shard") -> "ShardedQRels":
        """Route a host-resident QRel table into per-shard buffers.

        ``qrels`` is anything with ``query_ids / entity_ids / scores /
        valid`` fields (a ``QRelTable`` or numpy equivalent).
        """
        as_np = lambda x: (x.cpu().numpy() if isinstance(x, torch.Tensor)
                           else np.asarray(x))
        q = as_np(qrels.query_ids).astype(np.int32, copy=False)
        e = as_np(qrels.entity_ids).astype(np.int32, copy=False)
        s = as_np(qrels.scores).astype(np.float32, copy=False)
        v = as_np(qrels.valid).astype(bool)
        axes = resolve_query_axes(mesh, axes)
        d = axis_size(mesh, axes)
        i = flat_axis_index(mesh, axes)
        qps = -(-int(num_queries) // d)
        # stable routing in original row order; invalid rows -> drop bucket
        shard = np.where(v, q // qps, d)
        order = np.argsort(shard, kind="stable")
        counts = np.bincount(shard[order], minlength=d + 1)[:d]
        n_buf = max(int(counts.max()) if counts.size else 0, 1)
        offsets = np.concatenate([[0], np.cumsum(counts)])
        owned = order[offsets[i]:offsets[i + 1]]
        dev = resolve_device(device)
        bufs = []
        with trace.span(span, shard=i, rows=int(owned.size), buf_rows=n_buf):
            for field, dtype in ((q, np.int32), (e, np.int32),
                                 (s, np.float32), (v, np.int32)):
                bufs.append(_stream_block(
                    field[owned].astype(dtype), dev, n_buf,
                    chunk_rows=max(1, int(chunk_rows))))
        return cls(*bufs, int(num_queries), int(num_entities), qps, mesh,
                   axes)
