"""Deterministic tf-idf bag-of-words embedder — the reference embedding
model for fast benchmarks (the trained transformer encoder is the primary
embedder; this one is seed-free, instant, and exhibits the same retrieval
geometry, so Table I/II benchmarks stay cheap and reproducible). A numpy
copy of ``repro/retrieval/tfidf.py``."""
from __future__ import annotations

import numpy as np


def tfidf_vectors(tokens: np.ndarray, vocab_size: int,
                  df: np.ndarray | None = None):
    """tokens (N, L) -> L2-normalised tf-idf vectors (N, vocab_size)."""
    n = tokens.shape[0]
    m = np.zeros((n, vocab_size), np.float32)
    np.add.at(m, (np.repeat(np.arange(n), tokens.shape[1]), tokens.ravel()),
              1.0)
    if df is None:
        df = (m > 0).sum(0) + 1
    m *= np.log(max(n, 2) / df)[None]
    m /= np.linalg.norm(m, axis=1, keepdims=True) + 1e-9
    return m, df
