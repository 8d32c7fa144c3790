"""Synthetic MSMarco-like corpus generation.

The container is offline, so the benchmark corpus is synthesized with the
statistics the paper measures on MSMarco:

* Entity qrel-multiplicities follow a **Yule-Simon power law** with
  gamma = 1 + 1/(1 - alpha): queries arrive and attach to entities by a
  Simon preferential-attachment (copy) process. alpha = 0.5 -> gamma = 3,
  matching the paper's fitted gamma = 2.94.
* **Planted community structure**: the copy process runs *within topics*, so
  entities sharing queries share topics — exactly the latent communities
  WindTunnel must preserve (paper Fig. 1/2: thematically consistent
  communities).
* Text: each topic owns a boosted word subset over a Zipfian background
  vocabulary; passages/queries sample from their topic's mixture. An
  embedding model trained on (query, passage) pairs therefore embeds
  communities as clusters — giving the distractor geometry of paper Fig. 1.
* **Auxiliary entities** (paper §I-A): a configurable fraction of corpus
  entities appear in no QRel; they act as distractors in indexing only.

Generation is host-side numpy (data pipeline), downstream consumption is
PyTorch. This is a copy of ``repro/data/synthetic.py``: the same seed gives
the same corpus in both packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graph_builder import QRelTable


@dataclasses.dataclass
class SyntheticCorpus:
    qrels: QRelTable                # padded table (numpy arrays)
    num_queries: int
    num_entities: int               # includes auxiliary entities
    num_primary: int                # entities that appear in QRels
    passage_tokens: np.ndarray      # i32[num_entities, passage_len]
    query_tokens: np.ndarray        # i32[num_queries, query_len]
    entity_topic: np.ndarray        # i32[num_entities] ground-truth community
    query_topic: np.ndarray         # i32[num_queries]
    vocab_size: int


def _simon_block(n_slots: int, alpha: float, rng: np.random.Generator):
    """One Simon preferential-attachment process over ``n_slots`` qrel slots.

    Returns local entity ids per slot (0..n_new-1). Vectorized via pointer
    jumping: slot t either mints a new entity (prob alpha) or copies the
    entity of a uniformly random earlier slot.
    """
    if n_slots == 0:
        return np.zeros((0,), np.int64)
    is_new = rng.random(n_slots) < alpha
    is_new[0] = True
    # copy target: uniform over strictly earlier slots
    copy_src = (rng.random(n_slots) * np.arange(n_slots)).astype(np.int64)
    ptr = np.where(is_new, np.arange(n_slots), copy_src)
    # pointer jumping: after ceil(log2 n) rounds every slot points at a minter
    rounds = max(1, int(np.ceil(np.log2(max(n_slots, 2)))) + 1)
    for _ in range(rounds):
        ptr = ptr[ptr]
    local_ids = np.cumsum(is_new) - 1
    return local_ids[ptr]


def generate_qrels(*, num_queries: int, qrels_per_query: int = 8,
                   alpha: float = 0.5, num_topics: int = 64,
                   topic_concentration: float = 1.2,
                   seed: int = 0):
    """Bipartite (query, entity, score) table with Yule-Simon entity degrees
    and planted topic communities.

    Returns (q_ids, e_ids, scores, entity_topic, query_topic, num_entities),
    all numpy, un-padded.
    """
    rng = np.random.default_rng(seed)
    # power-law-ish topic sizes (Zipf over topics)
    topic_w = 1.0 / np.arange(1, num_topics + 1) ** topic_concentration
    topic_w /= topic_w.sum()
    query_topic = rng.choice(num_topics, size=num_queries, p=topic_w)

    q_ids, e_ids, topics = [], [], []
    entity_topic = []
    offset = 0
    for t in range(num_topics):
        qs = np.nonzero(query_topic == t)[0]
        n_slots = qs.size * qrels_per_query
        local = _simon_block(n_slots, alpha, rng)
        n_new = int(local.max()) + 1 if n_slots else 0
        q_ids.append(np.repeat(qs, qrels_per_query))
        e_ids.append(local + offset)
        entity_topic.append(np.full(n_new, t, np.int64))
        offset += n_new
    q_ids = np.concatenate(q_ids)
    e_ids = np.concatenate(e_ids)
    entity_topic = np.concatenate(entity_topic)
    scores = rng.random(q_ids.shape[0]).astype(np.float32)
    return (q_ids.astype(np.int32), e_ids.astype(np.int32), scores,
            entity_topic.astype(np.int32), query_topic.astype(np.int32),
            offset)


def _query_words(query_ids: np.ndarray, k: np.ndarray,
                 vocab_size: int) -> np.ndarray:
    """Deterministic per-query intent-word set hashed into the vocab.
    Hash collisions across queries are intentional: at full-corpus scale
    they are the lexically-similar-but-irrelevant matches that drive the
    paper's low full-corpus precision (Table I: 0.105)."""
    return ((query_ids * 7919 + k * 104729 + 13) % vocab_size).astype(np.int32)


class _TokenModel:
    """Token model giving the embedding geometry the paper measures.

    Every QUERY owns a small intent-word set. A PASSAGE mixes the intent
    words of the queries it answers + its community's topic words + Zipf
    background (real passages answer several intents). A QUERY's text is
    drawn from its own intent words plus its two-hop neighbourhood (the
    intent words of queries sharing a relevant passage) — real queries are
    fragments of their relevant documents. Consequences:

    * relevant passages embed closest to the query (shared intent words);
    * passages of co-community queries are the strong distractors —
      preserved by WindTunnel sampling, thinned by uniform sampling, which
      is exactly why uniform sampling inflates precision (paper §IV);
    * auxiliary entities borrow intent words of random same-topic queries:
      strong community distractors invisible to shared-query edges — the
      paper's own explanation of why even the WindTunnel sample's
      precision sits above the full corpus.
    """

    def __init__(self, vocab_size, num_topics, topic_words, rng,
                 intent_words: int = 8):
        self.vocab = vocab_size
        self.iw = intent_words
        self.rng = rng
        bg = 1.0 / np.arange(1, vocab_size + 1) ** 1.1
        self.bg = bg / bg.sum()
        self.owned = rng.integers(0, vocab_size, size=(num_topics, topic_words))
        self.topic_words = topic_words

    def _mix(self, topic_ids, length, qsrc, p_intent, p_topic):
        """qsrc: (n, R) query ids (pad -1) to borrow intent words from."""
        n = topic_ids.shape[0]
        rng = self.rng
        u = rng.random((n, length))
        out = rng.choice(self.vocab, size=(n, length), p=self.bg).astype(np.int32)
        topic_tok = self.owned[topic_ids][
            np.arange(n)[:, None],
            rng.integers(0, self.topic_words, size=(n, length))]
        out = np.where(u < p_intent + p_topic, topic_tok, out)
        pick = rng.integers(0, qsrc.shape[1], size=(n, length))
        chosen = qsrc[np.arange(n)[:, None], pick]
        intent = _query_words(np.maximum(chosen, 0),
                              rng.integers(0, self.iw, size=(n, length)),
                              self.vocab)
        out = np.where((u < p_intent) & (chosen >= 0), intent, out)
        return out

    def passages(self, topic_ids, length, entity_queries):
        """entity_queries: (n, M) ids of queries each passage answers."""
        return self._mix(topic_ids, length, entity_queries,
                         p_intent=0.35, p_topic=0.30)

    def queries(self, topic_ids, length, own_and_neighbors):
        """own_and_neighbors: (n, R) = own id (repeated for weight) + co-
        community query ids (two-hop via shared passages)."""
        return self._mix(topic_ids, length, own_and_neighbors,
                         p_intent=0.55, p_topic=0.25)


def generate_corpus(*, num_queries: int = 2048, qrels_per_query: int = 8,
                    alpha: float = 0.5, num_topics: int = 64,
                    aux_fraction: float = 0.3, vocab_size: int = 4096,
                    passage_len: int = 64, query_len: int = 16,
                    topic_words: int = 64, seed: int = 0,
                    pad_multiple: int = 1024) -> SyntheticCorpus:
    rng = np.random.default_rng(seed + 1)
    (q_ids, e_ids, scores, entity_topic, query_topic,
     num_primary) = generate_qrels(
        num_queries=num_queries, qrels_per_query=qrels_per_query,
        alpha=alpha, num_topics=num_topics, seed=seed)

    # auxiliary entities: indexed but never relevant (paper §I-A)
    num_aux = int(num_primary * aux_fraction)
    aux_topics = rng.choice(num_topics, size=num_aux,
                            p=np.bincount(entity_topic,
                                          minlength=num_topics) /
                              max(entity_topic.size, 1))
    entity_topic = np.concatenate([entity_topic, aux_topics.astype(np.int32)])
    num_entities = num_primary + num_aux

    tm = _TokenModel(vocab_size, num_topics, topic_words, rng)

    # entity -> answered-queries table (padded -1), capped at M per entity
    M = 4
    ent_q = np.full((num_entities, M), -1, np.int64)
    order = np.argsort(e_ids, kind="stable")
    es, qs = e_ids[order], q_ids[order]
    starts = np.concatenate([[True], es[1:] != es[:-1]])
    rank = np.arange(es.size) - np.maximum.accumulate(
        np.where(starts, np.arange(es.size), 0))
    sel = rank < M
    ent_q[es[sel], rank[sel]] = qs[sel]

    # aux entities: strong same-topic distractors — each borrows the intent
    # words of ONE random query of its topic at full strength (unjudged
    # near-duplicates, invisible to shared-query edges). These are what
    # drags full-corpus precision down to the paper's 0.105 regime.
    if num_aux:
        qt_order = np.argsort(query_topic, kind="stable")
        sorted_qt = query_topic[qt_order]
        t_lo = np.searchsorted(sorted_qt, entity_topic[num_primary:])
        t_hi = np.searchsorted(sorted_qt, entity_topic[num_primary:],
                               side="right")
        has_q = t_hi > t_lo
        pick = t_lo + (rng.random(num_aux) * np.maximum(t_hi - t_lo, 1)
                       ).astype(np.int64)
        ent_q[num_primary:, 0] = np.where(
            has_q, qt_order[np.minimum(pick, qt_order.size - 1)], -1)

    passage_tokens = tm.passages(entity_topic, passage_len, ent_q)

    # query -> relevant entities (for two-hop neighbour intent sampling)
    rel = np.full((num_queries, qrels_per_query), -1, np.int64)
    order = np.argsort(q_ids, kind="stable")
    qs2, es2 = q_ids[order], e_ids[order]
    starts = np.concatenate([[True], qs2[1:] != qs2[:-1]])
    rank = np.arange(qs2.size) - np.maximum.accumulate(
        np.where(starts, np.arange(qs2.size), 0))
    sel = rank < qrels_per_query
    rel[qs2[sel], rank[sel]] = es2[sel]

    # neighbour queries: random query of a random relevant entity
    R2 = 6
    re_pick = rel[np.arange(num_queries)[:, None],
                  rng.integers(0, rel.shape[1], (num_queries, R2))]
    nb = np.where(re_pick >= 0,
                  ent_q[np.maximum(re_pick, 0),
                        rng.integers(0, M, (num_queries, R2))], -1)
    own = np.repeat(np.arange(num_queries, dtype=np.int64)[:, None], 4, 1)
    qsrc = np.concatenate([own, nb], axis=1)     # half own, half two-hop
    query_tokens = tm.queries(query_topic, query_len, qsrc)

    # pad the relational table to a static length
    n = q_ids.shape[0]
    n_pad = ((n + pad_multiple - 1) // pad_multiple) * pad_multiple
    pad = n_pad - n
    qrels = QRelTable(
        query_ids=np.concatenate([q_ids, np.zeros(pad, np.int32)]),
        entity_ids=np.concatenate([e_ids, np.zeros(pad, np.int32)]),
        scores=np.concatenate([scores, np.zeros(pad, np.float32)]),
        valid=np.concatenate([np.ones(n, bool), np.zeros(pad, bool)]),
    )
    return SyntheticCorpus(qrels, num_queries, num_entities, num_primary,
                           passage_tokens, query_tokens,
                           entity_topic, query_topic, vocab_size)
