"""IVF-Flat vector index — the pgvector ``ivfflat`` index of the paper's
experiments (port of ``repro/retrieval/ivfflat.py``).

Build: k-means (Lloyd) clusters the corpus into ``n_lists`` inverted lists,
stored as a padded block (n_lists, cap, d). Search: score the query against
the centroids, probe the ``nprobe`` nearest lists, then score their members
through the scoring backend's ``gathered_rows_topk`` primitive
(retrieval/backends.py). Where the reference gathers the probed lists into
a (Q, nprobe*cap, d) block, the port hands the backend the list table and
the probed rows: at the main path's size that block would take a gigabyte
per query.

Translations of the reference's JAX idioms:

  * ``jax.random.choice(replace=False)`` -> ``prng.choice`` (bit-equal);
  * ``lax.top_k`` on the centroid scores -> a stable descending sort, ties
    to the lowest list;
  * ``associative_scan(max)`` -> ``torch.cummax``;
  * ``.at[row, col].set(mode="drop")`` -> an explicit mask of the rows that
    fit.

The k-means centroid sums are ``index_add_`` on the CPU, which sums in the
order that reproduces the reference's ``segment_sum`` bit for bit. On a
CUDA device ``index_add_`` adds with atomics in an order that changes from
run to run, so there the rows are sorted by list and each list summed as
one segment with ``segment_reduce``, which has no atomics (as
``core/segment_utils.segment_sum`` does): the same centroids on every run.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import prng
from repro_torch.retrieval.backends import get_backend


class IVFFlatIndex(NamedTuple):
    centroids: torch.Tensor  # (n_lists, d)
    vecs: torch.Tensor       # (n_lists, cap, d)
    ids: torch.Tensor        # (n_lists, cap) original ids, -1 padding
    mask: torch.Tensor       # (n_lists, cap)


def _sq_dist(data: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """The reference's |x|^2 - 2 x.c + |c|^2, term for term."""
    return ((data ** 2).sum(1)[:, None] - 2.0 * data @ cent.T
            + (cent ** 2).sum(1)[None])


def _cluster_sums(data: torch.Tensor, assign: torch.Tensor,
                  n_clusters: int):
    """(sums (n_clusters, d), counts (n_clusters, 1)) of the rows of each
    cluster, in an order fixed by the inputs on either device."""
    cnts = torch.bincount(assign, minlength=n_clusters)
    if data.is_cuda:
        order = torch.sort(assign, stable=True).indices
        sums = torch.segment_reduce(data[order], "sum", lengths=cnts,
                                    unsafe=True, initial=0.0)
    else:
        sums = torch.zeros((n_clusters, data.shape[1]), dtype=data.dtype)
        sums.index_add_(0, assign, data)
    return sums, cnts.to(data.dtype)[:, None]


def kmeans(key: prng.Key, data: torch.Tensor, n_clusters: int,
           iters: int = 10) -> torch.Tensor:
    """Lloyd's algorithm; returns centroids (n_clusters, d)."""
    n = data.shape[0]
    cent = data[prng.choice(key, n, n_clusters, data.device)]
    for _ in range(iters):
        assign = torch.argmin(_sq_dist(data, cent), dim=1)
        sums, cnts = _cluster_sums(data, assign, n_clusters)
        cent = torch.where(cnts > 0, sums / torch.clamp(cnts, min=1.0), cent)
    return cent


def build_ivfflat(key: prng.Key, corpus: torch.Tensor, *, n_lists: int,
                  cap_factor: float = 2.0,
                  kmeans_iters: int = 10) -> IVFFlatIndex:
    n, d = corpus.shape
    dev = corpus.device
    cent = kmeans(key, corpus, n_lists, kmeans_iters)
    assign = torch.argmin(_sq_dist(corpus, cent), dim=1)     # (N,)
    cap = int(cap_factor * n / n_lists) + 1
    # rank of each vector within its list
    order = torch.sort(assign, stable=True).indices
    sorted_assign = assign[order]
    starts = torch.ones(n, dtype=torch.bool, device=dev)
    starts[1:] = sorted_assign[1:] != sorted_assign[:-1]
    iota = torch.arange(n, device=dev)
    gstart = torch.cummax(torch.where(starts, iota, 0), 0).values
    rank = iota - gstart
    ok = rank < cap                          # members past cap are dropped
    slot = sorted_assign[ok] * cap + rank[ok]
    vecs = torch.zeros((n_lists * cap, d), dtype=corpus.dtype, device=dev)
    vecs[slot] = corpus[order[ok]]
    ids = torch.full((n_lists * cap,), -1, dtype=torch.int32, device=dev)
    ids[slot] = order[ok].to(torch.int32)
    mask = torch.zeros(n_lists * cap, dtype=torch.bool, device=dev)
    mask[slot] = True
    return IVFFlatIndex(cent, vecs.reshape(n_lists, cap, d),
                        ids.reshape(n_lists, cap), mask.reshape(n_lists, cap))


def probe_candidates(index: IVFFlatIndex, queries: torch.Tensor, *,
                     nprobe: int):
    """Select the ``nprobe`` nearest lists per query (ties to the lower
    list, as ``lax.top_k``) and name their members as a per-query candidate
    set: (cand_rows (Q, nprobe*cap) rows of ``index.vecs.reshape(-1, d)``,
    cand_ids (Q, nprobe*cap) with -1 marking padding slots), both int32."""
    cscore = queries @ index.centroids.T                   # (Q, n_lists)
    probe = torch.sort(cscore, dim=1, descending=True,
                       stable=True).indices[:, :nprobe]    # (Q, nprobe)
    cap = index.ids.shape[1]
    slots = torch.arange(cap, device=queries.device)
    rows = (probe[:, :, None] * cap + slots).reshape(queries.shape[0], -1)
    ids = torch.where(index.mask[probe], index.ids[probe], -1)
    return rows.to(torch.int32), ids.reshape(queries.shape[0], -1)


def search_ivfflat(index: IVFFlatIndex, queries: torch.Tensor, *, k: int,
                   nprobe: int = 8, backend: str = "torch"):
    """queries (Q, d) -> (scores (Q, k), ids (Q, k)); inner product metric,
    probe scoring dispatched through ``backend``."""
    cand_rows, cand_ids = probe_candidates(index, queries, nprobe=nprobe)
    table = index.vecs.reshape(-1, index.vecs.shape[2])
    return get_backend(backend).gathered_rows_topk(queries, table, cand_rows,
                                                   cand_ids, k=k)
