"""GraphBuilder — Algorithm 1 of the WindTunnel paper (port of
``repro/core/graph_builder.py``).

Builds the weighted entity-affinity graph from a QRel table:

  Step 1 (map):    keep (q, e, s) with s > tau.
  Step 1 (reduce): for every query, emit every entity pair (e1 < e2) that
                   shares it, with affinity S = min(qrel(q,e1), qrel(q,e2)).
  Step 2:          dedup pairs keeping the MAX affinity.

The reduce-by-query self-join is a degree-capped ELL expansion: QRels are
sorted by (query, -score), the top ``fanout`` entities per query form a
dense (num_queries, fanout) table, and pair enumeration is a static
(fanout choose 2) broadcast. Dedup is sort + segment_max.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import segment_utils as su


class QRelTable(NamedTuple):
    """Padded relational QRel table: (entity_id, query_id, score) rows."""
    query_ids: torch.Tensor   # i32[n]
    entity_ids: torch.Tensor  # i32[n]
    scores: torch.Tensor      # f32[n]
    valid: torch.Tensor       # bool[n]

    def to(self, device) -> "QRelTable":
        """The table as tensors on ``device`` (numpy fields are converted)."""
        return QRelTable(*(torch.as_tensor(x).to(device) for x in self))


class EdgeList(NamedTuple):
    """Padded undirected weighted edge list (u < v canonical)."""
    u: torch.Tensor      # i32[m]
    v: torch.Tensor      # i32[m]
    w: torch.Tensor      # f32[m]
    valid: torch.Tensor  # bool[m]

    @property
    def num_valid(self):
        return self.valid.sum()


def nanquantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.nanquantile(x, q)`` (linear method) bit for bit: sort with NaN
    last, index with float32 arithmetic on the count of non-NaN values.
    ``torch.nanquantile`` rounds differently and refuses > 2**24 values."""
    s, _ = torch.sort(x.to(torch.float32))
    counts = (~torch.isnan(s)).sum().to(torch.float32)
    qq = torch.tensor(q, dtype=torch.float32, device=x.device) * (counts - 1)
    low = torch.floor(qq)
    high = torch.ceil(qq)
    high_weight = qq - low
    low_weight = 1 - high_weight
    top = counts - 1
    low = torch.maximum(torch.zeros_like(low), torch.minimum(low, top))
    high = torch.maximum(torch.zeros_like(high), torch.minimum(high, top))
    low_value = s[low.to(torch.int64)]
    high_value = s[high.to(torch.int64)]
    return low_value * low_weight + high_value * high_weight


def threshold_tau(qrels: QRelTable, tau_quantile: float) -> torch.Tensor:
    """Score value such that scores strictly above it survive Step 1 (the
    paper's 'top 50%' filter as a quantile of the valid scores)."""
    s = torch.where(qrels.valid, qrels.scores, torch.nan)
    return nanquantile(s, tau_quantile)


def filter_qrels(qrels: QRelTable, tau: torch.Tensor) -> QRelTable:
    """Step 1 map phase: Emit (q, (e, s)) if s > tau."""
    keep = qrels.valid & (qrels.scores > tau)
    return QRelTable(qrels.query_ids, qrels.entity_ids, qrels.scores, keep)


def build_ell(qrels: QRelTable, num_queries: int, fanout: int):
    """Group QRels by query into a dense ELL table of the top-``fanout``
    entities per query (by score).

    Returns (ell_e i32[num_queries, fanout] with -1 padding,
             ell_s f32[num_queries, fanout]).
    """
    dev = qrels.query_ids.device
    qk = torch.where(qrels.valid, qrels.query_ids, su.I32_MAX)
    neg_s = torch.where(qrels.valid, -qrels.scores, torch.inf)
    (qs, ss), (es, vs) = su.sort_by(
        (qk, neg_s), (qrels.entity_ids, qrels.valid.to(torch.int32)))
    rank = su.group_rank(su.run_starts(qs))
    ok = (vs == 1) & (rank < fanout) & (qs < num_queries)
    row, col = qs[ok].to(torch.int64), rank[ok]
    ell_e = torch.full((num_queries, fanout), -1, dtype=torch.int32,
                       device=dev)
    ell_e[row, col] = es[ok].to(torch.int32)
    ell_s = torch.zeros((num_queries, fanout), dtype=torch.float32,
                        device=dev)
    ell_s[row, col] = -ss[ok]
    return ell_e, ell_s


def affinity_pairs(ell_e: torch.Tensor, ell_s: torch.Tensor) -> EdgeList:
    """Step 1 reduce phase: enumerate entity pairs sharing a query.

    S_affinity = min(qrel(q, e1), qrel(q, e2)) along the 2-hop path
    (e1 -> q -> e2). Canonical orientation u < v.
    """
    fanout = ell_e.shape[1]
    iu, ju = torch.triu_indices(fanout, fanout, offset=1,
                                device=ell_e.device)
    ea, eb = ell_e[:, iu], ell_e[:, ju]           # (Q, P)
    sa, sb = ell_s[:, iu], ell_s[:, ju]
    valid = (ea >= 0) & (eb >= 0) & (ea != eb)
    u = torch.minimum(ea, eb)
    v = torch.maximum(ea, eb)
    w = torch.minimum(sa, sb)
    return EdgeList(u.reshape(-1), v.reshape(-1), w.reshape(-1),
                    valid.reshape(-1))


def dedup_edges(edges: EdgeList) -> EdgeList:
    """Step 2: one edge per (u, v) pair, keeping max affinity.

    Output is aligned to run-starts of the (u, v)-sorted order; non-start
    positions are masked out.
    """
    n = edges.u.shape[0]
    uk = torch.where(edges.valid, edges.u, su.I32_MAX)
    vk = torch.where(edges.valid, edges.v, su.I32_MAX)
    (us, vs), (ws, vals) = su.sort_by(
        (uk, vk), (edges.w, edges.valid.to(torch.int32)))
    starts = su.run_starts(us, vs)
    seg = su.run_segment_ids(starts)
    wmax = su.segment_max(torch.where(vals == 1, ws, -torch.inf), seg,
                          num_segments=n)
    keep = starts & (vals == 1)
    return EdgeList(us, vs, wmax[seg], keep)


def build_affinity_graph(qrels: QRelTable, *, num_queries: int,
                         tau_quantile: float = 0.5, fanout: int = 16
                         ) -> EdgeList:
    """Full Algorithm 1: threshold -> ELL group-by -> pair gen -> dedup."""
    tau = threshold_tau(qrels, tau_quantile)
    kept = filter_qrels(qrels, tau)
    ell_e, ell_s = build_ell(kept, num_queries, fanout)
    pairs = affinity_pairs(ell_e, ell_s)
    return dedup_edges(pairs)


def symmetrize(edges: EdgeList) -> tuple:
    """Undirected edge list -> directed (src, dst, w, valid) with both
    orientations, for message passing."""
    src = torch.cat([edges.u, edges.v])
    dst = torch.cat([edges.v, edges.u])
    w = torch.cat([edges.w, edges.w])
    valid = torch.cat([edges.valid, edges.valid])
    return src, dst, w, valid


def node_degrees(edges: EdgeList, num_nodes: int) -> torch.Tensor:
    """Node degree histogram support (Fig. 4 of the paper): the degree of an
    entity is its number of unique affinity-graph neighbours."""
    _, dst, _, valid = symmetrize(edges)
    keep = valid & su.in_range_rows(dst, num_nodes)
    deg = torch.zeros(num_nodes, dtype=torch.int32, device=dst.device)
    return deg.index_add_(0, dst[keep].to(torch.int64),
                          torch.ones_like(dst[keep]))
