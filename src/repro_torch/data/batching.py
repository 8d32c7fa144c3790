"""Deterministic batching for training pipelines (a numpy copy of
``repro/data/batching.py``).

Batches are a pure function of (seed, step): restarts resume mid-epoch with
no iterator state to checkpoint — only the step counter. This is the
fault-tolerance-friendly data-order design used by large-scale LM stacks.
"""
from __future__ import annotations

import numpy as np


class TokenBatcher:
    """Contrastive (query, positive-passage) batches from a SyntheticCorpus,
    plus plain LM token batches for decoder training."""

    def __init__(self, corpus, batch_size: int, seed: int = 0):
        self.corpus = corpus
        self.batch_size = batch_size
        self.seed = seed
        q = np.asarray(corpus.qrels.query_ids)
        e = np.asarray(corpus.qrels.entity_ids)
        v = np.asarray(corpus.qrels.valid)
        self._pairs = np.stack([q[v], e[v]], axis=1)
        # same-community hard negatives: topic -> entity list (the in-batch
        # negatives are cross-topic; the within-community margin — exactly
        # what Table I measures — must be trained explicitly)
        topics = np.asarray(corpus.entity_topic)
        order = np.argsort(topics, kind="stable")
        self._ents_by_topic = order
        n_topics = topics.max() + 1
        self._topic_lo = np.searchsorted(topics[order], np.arange(n_topics))
        self._topic_hi = np.searchsorted(topics[order], np.arange(n_topics),
                                         side="right")
        self._rel_set = set(map(tuple, self._pairs.tolist()))

    def _perm(self, step: int) -> np.ndarray:
        epoch = (step * self.batch_size) // self._pairs.shape[0]
        rng = np.random.default_rng(self.seed * 1_000_003 + epoch)
        return rng.permutation(self._pairs.shape[0])

    def contrastive_batch(self, step: int):
        n = self._pairs.shape[0]
        perm = self._perm(step)
        start = (step * self.batch_size) % n
        idx = perm[(start + np.arange(self.batch_size)) % n]
        qi, ei = self._pairs[idx, 0], self._pairs[idx, 1]
        # hard negative: same-topic entity that is not relevant to the query
        rng = np.random.default_rng(self.seed * 11_000_003 + step)
        t = np.asarray(self.corpus.query_topic)[qi]
        lo, hi = self._topic_lo[t], self._topic_hi[t]
        ni = np.empty_like(ei)
        for j in range(self.batch_size):
            cand = -1
            for _ in range(8):
                c = self._ents_by_topic[rng.integers(lo[j], max(hi[j], lo[j] + 1))]
                if (int(qi[j]), int(c)) not in self._rel_set:
                    cand = c
                    break
            ni[j] = cand if cand >= 0 else rng.integers(
                0, self.corpus.num_entities)
        return {
            "query_tokens": self.corpus.query_tokens[qi],
            "passage_tokens": self.corpus.passage_tokens[ei],
            "negative_tokens": self.corpus.passage_tokens[ni],
            "query_ids": qi.astype(np.int32),
            "entity_ids": ei.astype(np.int32),
        }

    def lm_batch(self, step: int, seq_len: int):
        """Concatenate passages into fixed-length LM training rows."""
        rng = np.random.default_rng(self.seed * 7_000_003 + step)
        n_ent, plen = self.corpus.passage_tokens.shape
        per_row = (seq_len + plen - 1) // plen
        ids = rng.integers(0, n_ent, size=(self.batch_size, per_row))
        toks = self.corpus.passage_tokens[ids].reshape(self.batch_size, -1)
        toks = toks[:, :seq_len]
        return {"tokens": toks.astype(np.int32)}
