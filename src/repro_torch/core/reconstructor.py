"""CorpusReconstructor — joins the sampled entity set back to the relational
inputs, emitting (Queries, Corpus, QRels) with the SAME SCHEMA as the input
(paper §II 'Output'). Port of ``repro/core/reconstructor.py``; pure mask
algebra.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import segment_utils as su
from repro_torch.core.graph_builder import QRelTable
from repro_torch.core.sampler import xla_sum


class ReconstructedSample(NamedTuple):
    qrels: QRelTable           # original rows, valid-mask restricted
    entity_mask: torch.Tensor  # bool[num_entities]
    query_mask: torch.Tensor   # bool[num_queries] queries with >=1 kept entity

    @property
    def num_entities(self):
        return self.entity_mask.to(torch.int32).sum()

    @property
    def num_queries(self):
        return self.query_mask.to(torch.int32).sum()


def _count_rows(ids: torch.Tensor, rows: torch.Tensor, n: int, dtype):
    """out[i] = number of ``rows`` with id i (rows outside [0, n) dropped)."""
    sel = ids[rows & su.in_range_rows(ids, n)]
    out = torch.zeros(n, dtype=dtype, device=ids.device)
    return out.index_add_(0, sel.to(torch.int64),
                          torch.ones_like(sel, dtype=dtype))


def _kept_rows(qrels: QRelTable, entity_mask: torch.Tensor) -> torch.Tensor:
    ent = torch.clamp(qrels.entity_ids, min=0).to(torch.int64)
    return qrels.valid & entity_mask[ent]


def reconstruct(qrels: QRelTable, entity_mask: torch.Tensor, *,
                num_queries: int) -> ReconstructedSample:
    """Keep QRel rows whose entity survived; keep queries with >=1 kept row."""
    keep_row = _kept_rows(qrels, entity_mask)
    qm = _count_rows(qrels.query_ids, keep_row, num_queries, torch.int32)
    sub = QRelTable(qrels.query_ids, qrels.entity_ids, qrels.scores, keep_row)
    return ReconstructedSample(sub, entity_mask, qm > 0)


def associated_queries(qrels: QRelTable, entity_mask, *, num_queries: int,
                       max_queries: Optional[int] = None, seed: int = 0):
    """Host-side mirror of :func:`reconstruct`'s query-association rule.

    Returns ``(assoc bool[num_queries], qids i64[<=max_queries])``: queries
    with >=1 relevant kept entity, plus a deterministic subsample of their
    ids capped at ``max_queries`` (the eval grid's per-sample query budget).
    """
    q, e, v, mask = (np.asarray(torch.as_tensor(x).cpu()) for x in (
        qrels.query_ids, qrels.entity_ids, qrels.valid, entity_mask))
    num_entities = mask.shape[0]
    assoc = np.zeros(num_queries, bool)
    rows = v & mask[np.clip(e, 0, num_entities - 1)]
    assoc[q[rows]] = True
    qids = np.nonzero(assoc)[0]
    if max_queries is not None and qids.size > max_queries:
        rng = np.random.default_rng(seed)
        qids = np.sort(rng.choice(qids, max_queries, replace=False))
    return assoc, qids


def query_density(qrels: QRelTable, entity_mask: torch.Tensor,
                  query_mask: torch.Tensor, *, num_queries: int,
                  num_entities: int) -> torch.Tensor:
    """rho_q of Table II: mean over sampled queries of the fraction of the
    query's relevant entities that survive in the sample. The sum over
    queries runs in XLA:CPU's order (:func:`~repro_torch.core.sampler.
    xla_sum`), so rho_q is the reference's bit for bit."""
    del num_entities
    keep_row = _kept_rows(qrels, entity_mask)
    rel_kept = _count_rows(qrels.query_ids, keep_row, num_queries,
                           torch.float32)
    rel_all = _count_rows(qrels.query_ids, qrels.valid, num_queries,
                          torch.float32)
    frac = torch.where(rel_all > 0,
                       rel_kept / torch.clamp(rel_all, min=1.0), 0.0)
    qn = query_mask.to(torch.float32).sum()
    total = xla_sum(torch.where(query_mask, frac, 0.0))
    return total / torch.clamp(qn, min=1.0)
