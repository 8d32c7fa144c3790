"""IR evaluation metrics over the QRel judgments: precision@k (paper Table I
— 'the relevance percentage of entities responding to each query'),
recall@k, binary-relevance nDCG@k, and MRR.  All take the (Q, >=k) retrieved
id matrix (−1 padding ignored) plus the judged-relevant structures built by
:func:`qrel_set` / :func:`qrel_dict`.  A numpy copy of
``repro/retrieval/metrics.py``."""
from __future__ import annotations

import numpy as np


def precision_at_k(retrieved_ids: np.ndarray, query_ids: np.ndarray,
                   qrel_pairs: set, k: int = 3) -> float:
    """retrieved_ids (Q, >=k) entity ids per query; qrel_pairs a set of
    (query_id, entity_id) judged-relevant pairs. Mean p@k over queries."""
    hits = 0
    total = 0
    for qi, row in zip(query_ids, retrieved_ids[:, :k]):
        for e in row:
            if e >= 0:
                hits += int((int(qi), int(e)) in qrel_pairs)
                total += 1
    return hits / max(total, 1)


def recall_at_k(retrieved_ids: np.ndarray, query_ids: np.ndarray,
                qrel_by_query: dict, k: int = 10) -> float:
    rec = []
    for qi, row in zip(query_ids, retrieved_ids[:, :k]):
        rel = qrel_by_query.get(int(qi), set())
        if rel:
            rec.append(len(rel & set(int(e) for e in row)) / len(rel))
    return float(np.mean(rec)) if rec else 0.0


def ndcg_at_k(retrieved_ids: np.ndarray, query_ids: np.ndarray,
              qrel_by_query: dict, k: int = 10) -> float:
    """Binary-relevance nDCG@k: DCG = sum_i rel_i / log2(i + 1) over ranks
    i = 1..k, ideal DCG puts the query's min(|rel|, k) judged entities
    first.  Mean over queries with >=1 judgment."""
    vals = []
    for qi, row in zip(query_ids, retrieved_ids[:, :k]):
        rel = qrel_by_query.get(int(qi), set())
        if not rel:
            continue
        dcg = sum(1.0 / np.log2(i + 2.0)
                  for i, e in enumerate(row) if e >= 0 and int(e) in rel)
        idcg = sum(1.0 / np.log2(i + 2.0) for i in range(min(len(rel), k)))
        vals.append(dcg / idcg)
    return float(np.mean(vals)) if vals else 0.0


def mrr(retrieved_ids: np.ndarray, query_ids: np.ndarray,
        qrel_by_query: dict, k: int | None = None) -> float:
    """Mean reciprocal rank of the first judged-relevant entity (0 when no
    relevant entity appears in the top-k), averaged over all queries."""
    rows = retrieved_ids if k is None else retrieved_ids[:, :k]
    rrs = []
    for qi, row in zip(query_ids, rows):
        rel = qrel_by_query.get(int(qi), set())
        rr = 0.0
        for i, e in enumerate(row):
            if e >= 0 and int(e) in rel:
                rr = 1.0 / (i + 1.0)
                break
        rrs.append(rr)
    return float(np.mean(rrs)) if rrs else 0.0


def qrel_set(query_ids, entity_ids, valid) -> set:
    q = np.asarray(query_ids)[np.asarray(valid)]
    e = np.asarray(entity_ids)[np.asarray(valid)]
    return set(zip(q.tolist(), e.tolist()))


def qrel_dict(query_ids, entity_ids, valid) -> dict:
    out: dict = {}
    q = np.asarray(query_ids)[np.asarray(valid)]
    e = np.asarray(entity_ids)[np.asarray(valid)]
    for qi, ei in zip(q.tolist(), e.tolist()):
        out.setdefault(qi, set()).add(ei)
    return out
