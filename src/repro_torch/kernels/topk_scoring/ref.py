"""Plain PyTorch versions for the top-k scoring kernels (port of
``repro/kernels/topk_scoring/ref.py``)."""
from __future__ import annotations

import torch


def pad_topk(s: torch.Tensor, i: torch.Tensor, k: int):
    """Pad (Q, k_eff) top-k results back to (Q, k) with the miss
    convention every scoring path shares: score -inf, id -1."""
    k_eff = s.shape[1]
    if k_eff >= k:
        return s, i
    pad = (s.shape[0], k - k_eff)
    return (torch.cat([s, s.new_full(pad, -torch.inf)], 1),
            torch.cat([i, i.new_full(pad, -1)], 1))


def blocked_topk(score, queries: torch.Tensor, corpus: torch.Tensor, *,
                 k: int, block: int):
    """Top-k of ``score(queries, corpus_block)`` (f32 [Q, block]) over the
    corpus, block by block with a running merge so the (Q, N) score matrix
    never materialises. Ties go to the lowest id, as ``lax.top_k`` gives
    them in the reference: the merge is a stable descending sort over
    [running best, block], both already in id order (``torch.topk``
    promises no order among ties)."""
    qn, n = queries.shape[0], corpus.shape[0]
    dev = queries.device
    best_s = torch.full((qn, k), -torch.inf, dtype=torch.float32, device=dev)
    best_i = torch.full((qn, k), -1, dtype=torch.int32, device=dev)
    for b0 in range(0, n, block):
        blk = corpus[b0:b0 + block]
        s = score(queries, blk)
        ids = torch.arange(b0, b0 + blk.shape[0], dtype=torch.int32,
                           device=dev).expand(qn, -1)
        cat_s = torch.cat([best_s, s], 1)
        cat_i = torch.cat([best_i, ids], 1)
        pos = torch.sort(cat_s, dim=1, descending=True,
                         stable=True).indices[:, :k]
        best_s = torch.gather(cat_s, 1, pos)
        best_i = torch.gather(cat_i, 1, pos)
    return best_s, best_i


def topk_scores_ref(queries: torch.Tensor, corpus: torch.Tensor, *, k: int,
                    block: int = 4096):
    """Inner-product top-k of (Q, D) queries over an (N, D) corpus ->
    (scores f32[Q, k], ids i32[Q, k]); a k beyond N leaves -inf / -1 in the
    tail. On a CUDA tensor the product follows
    ``torch.backends.cuda.matmul.allow_tf32`` (False unless the caller sets
    it), so it runs in full f32 by default."""
    return blocked_topk(lambda q, c: (q @ c.T).to(torch.float32), queries,
                         corpus, k=k, block=block)


def topk_scores_int8_ref(q_codes: torch.Tensor, c_codes: torch.Tensor, *,
                         k: int, block: int = 4096):
    """int8-code oracle: the exact integer dot (|dot| <= 127^2 * D, exact
    in f64), ranked as f32 like the kernel's partials and the reference's
    ``topk_scores_int8_ref``."""
    return blocked_topk(
        lambda q, c: (q.to(torch.float64) @ c.to(torch.float64).T)
        .to(torch.float32), q_codes, c_codes, k=k, block=block)


def gathered_topk_ref(queries: torch.Tensor, table: torch.Tensor,
                      cand_rows: torch.Tensor, cand_ids: torch.Tensor, *,
                      k: int, chunk_bytes: int = 1 << 30):
    """Per-query candidate sets: candidate c of query q is the row
    ``table[cand_rows[q, c]]`` (queries f32[Q, D], table f32[R, D],
    cand_rows/cand_ids i32[Q, C], id -1 marking an invalid slot) -> top-k
    (scores f32[Q, k], ids i32[Q, k]) for k <= C. Invalid slots score -inf
    and come back as id -1; ties go to the earlier candidate position, as
    ``lax.top_k`` gives them in the reference. The reference's dense form,
    cand_vecs (Q, C, D), is ``table = cand_vecs.reshape(Q * C, D)`` with
    ``cand_rows[q, c] = q * C + c``.

    Queries go in chunks whose gathered (q, C, D) block stays under
    ``chunk_bytes``, so the ivfflat probe's candidate vectors never exist
    for all queries at once."""
    qn, c = cand_ids.shape
    per_query = max(1, c * table.shape[1] * table.element_size())
    step = max(1, chunk_bytes // per_query)
    out_s, out_i = [], []
    for q0 in range(0, qn, step):
        rows = cand_rows[q0:q0 + step].clamp(min=0).long()
        ids = cand_ids[q0:q0 + step]
        s = torch.einsum("qd,qcd->qc", queries[q0:q0 + step],
                         table[rows]).to(torch.float32)
        s = torch.where(ids >= 0, s, -torch.inf)
        pos = torch.sort(s, dim=1, descending=True, stable=True).indices[:, :k]
        top_s = torch.gather(s, 1, pos)
        top_i = torch.gather(ids, 1, pos).to(torch.int32)
        out_s.append(top_s)
        out_i.append(torch.where(torch.isfinite(top_s), top_i, -1))
    if not out_s:
        dev = queries.device
        return (torch.empty((0, k), dtype=torch.float32, device=dev),
                torch.empty((0, k), dtype=torch.int32, device=dev))
    return torch.cat(out_s), torch.cat(out_i)
