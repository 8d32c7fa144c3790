"""Sign-random-projection LSH index (port of ``repro/retrieval/lsh.py``).

Vectors hash to ``n_bits`` sign bits packed into int32 words; search ranks
by Hamming distance (XOR + popcount) with optional exact rerank of the top
candidates. The Hamming scan dispatches through the scoring-backend
registry (retrieval/backends.py): ``torch`` streams the plain version over
blocks of the corpus, ``cuda`` runs the Hamming kernel
(kernels/lsh_hamming).

The projection is ``prng.normal``, bit-equal to ``jax.random.normal``
(core/prng.py); a code bit can differ from the reference's only where the
projection products, summed in another order, land on either side of zero.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import prng
from repro_torch.kernels.lsh_hamming.ref import popcount32
from repro_torch.retrieval.backends import get_backend, rerank_candidates

__all__ = ["LSHIndex", "build_lsh", "encode", "popcount32", "search_lsh"]


class LSHIndex(NamedTuple):
    proj: torch.Tensor    # (d, n_bits) random projection
    codes: torch.Tensor   # (N, n_words) packed int32
    vecs: torch.Tensor    # (N, d) kept for rerank


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """bits (..., n_bits) bool -> (..., n_bits/32) int32, bit j of a word
    from bit 32*w + j."""
    n_bits = bits.shape[-1]
    if n_bits % 32:
        raise ValueError(f"n_bits={n_bits} is not a multiple of 32")
    b = bits.reshape(bits.shape[:-1] + (n_bits // 32, 32)).to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=bits.device) << \
        torch.arange(32, device=bits.device)
    words = (b * weights).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32,
                       words).to(torch.int32)


def encode(proj: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    return _pack_bits((vecs @ proj) > 0)


def build_lsh(key: prng.Key, corpus: torch.Tensor, *,
              n_bits: int = 128) -> LSHIndex:
    proj = prng.normal(key, (corpus.shape[1], n_bits), corpus.device)
    return LSHIndex(proj, encode(proj, corpus), corpus)


def search_lsh(index: LSHIndex, queries: torch.Tensor, *, k: int,
               rerank: int = 0, backend: str = "torch"):
    """Hamming-distance ANN; if ``rerank`` > 0, exact-rerank that many
    Hamming candidates with true inner products (higher score = better);
    with ``rerank`` <= 0 the first result is the POSITIVE Hamming distance
    (lower = better, +inf for misses), as the reference returns it."""
    bk = get_backend(backend)
    qc = encode(index.proj, queries)                      # (Q, W)
    if rerank <= 0:
        neg, ids = bk.hamming_topk(qc, index.codes, k=k)
        return (-neg).to(queries.dtype), ids
    _, cand = bk.hamming_topk(qc, index.codes, k=rerank)  # (Q, rerank)
    return rerank_candidates(index.vecs, queries, cand, k=k)
