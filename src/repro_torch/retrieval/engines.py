"""Retrieval-engine registry (port of ``repro/retrieval/engines.py``).

Each vector index is a registered object behind one protocol:

  * ``build(key, vecs)`` — one-time index construction over the corpus
    vectors (f32[N, D] on the search device); ``key`` is a threefry key
    (core/prng.py) for the engines that draw at build time.
  * ``search(index, queries, k)`` — top-k ids i32[Q, k] (-1 for misses).
  * ``search_scored(index, queries, k)`` — (scores f32[Q, k], ids).

Registered engines: ``exact`` (blocked brute-force inner product, the
oracle), ``ivfflat`` (k-means inverted lists, pgvector's index), ``lsh``
(sign-random-projection Hamming search with exact rerank) and ``tfidf``
(IDF-reweighted exact search). Every engine carries a ``backend`` field
naming a scoring backend (retrieval/backends.py), which the search core
sets uniformly.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Protocol, runtime_checkable

import torch

from repro_torch.retrieval.backends import get_backend
from repro_torch.retrieval.exact import exact_topk
from repro_torch.retrieval.ivfflat import build_ivfflat, search_ivfflat
from repro_torch.retrieval.lsh import build_lsh, search_lsh


@runtime_checkable
class RetrievalEngine(Protocol):
    """A vector index behind a uniform build/search interface."""

    name: str

    def build(self, key, vecs: torch.Tensor) -> Any:
        ...

    def search(self, index: Any, queries: torch.Tensor, *,
               k: int) -> torch.Tensor:
        ...

    def search_scored(self, index: Any, queries: torch.Tensor, *,
                      k: int) -> Any:
        ...


_REGISTRY: Dict[str, RetrievalEngine] = {}


def register_retrieval_engine(cls):
    """Class decorator: instantiate and register an engine under its name."""
    engine = cls()
    _REGISTRY[engine.name] = engine
    return cls


def get_retrieval_engine(name: str) -> RetrievalEngine:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown retrieval engine {name!r}; registered engines: "
            f"{', '.join(available_retrieval_engines())}") from None


def available_retrieval_engines() -> tuple:
    return tuple(sorted(_REGISTRY))


@register_retrieval_engine
@dataclasses.dataclass(frozen=True)
class ExactEngine:
    """Blocked brute-force top-k — the recall oracle for the ANN engines."""

    block: int = 2048
    backend: Optional[str] = None
    name: str = "exact"

    def build(self, key, vecs):
        del key  # deterministic
        return get_backend(self.backend).prepare_corpus(vecs)

    def search(self, index, queries, *, k: int):
        return self.search_scored(index, queries, k=k)[1]

    def search_scored(self, index, queries, *, k: int):
        return exact_topk(queries, index, k=k, block=self.block,
                          backend=self.backend)


@register_retrieval_engine
@dataclasses.dataclass(frozen=True)
class IVFFlatEngine:
    """k-means inverted lists (pgvector ``ivfflat``). ``n_lists`` shrinks to
    N//8 on small sampled corpora so every list keeps enough members."""

    n_lists: int = 64
    nprobe: int = 8
    cap_factor: float = 2.0
    backend: Optional[str] = None
    name: str = "ivfflat"

    def build(self, key, vecs):
        n_lists = min(self.n_lists, max(1, vecs.shape[0] // 8))
        return build_ivfflat(key, vecs, n_lists=n_lists,
                             cap_factor=self.cap_factor)

    def search(self, index, queries, *, k: int):
        return self.search_scored(index, queries, k=k)[1]

    def search_scored(self, index, queries, *, k: int):
        nprobe = min(self.nprobe, index.centroids.shape[0])
        return search_ivfflat(index, queries, k=k, nprobe=nprobe,
                              backend=self.backend)


@register_retrieval_engine
@dataclasses.dataclass(frozen=True)
class LSHEngine:
    """Sign-random-projection Hamming search with exact rerank of the top
    ``rerank`` Hamming candidates (clamped to [k, N])."""

    n_bits: int = 128
    rerank: int = 64
    backend: Optional[str] = None
    name: str = "lsh"

    def build(self, key, vecs):
        return build_lsh(key, vecs, n_bits=self.n_bits)

    def search(self, index, queries, *, k: int):
        return self.search_scored(index, queries, k=k)[1]

    def search_scored(self, index, queries, *, k: int):
        n = index.codes.shape[0]
        rerank = min(max(self.rerank, k), n) if self.rerank > 0 else 0
        return search_lsh(index, queries, k=k, rerank=rerank,
                          backend=self.backend)


class TfIdfIndex(NamedTuple):
    vecs: Any              # (N, D) IDF-weighted corpus, backend-prepared
    weights: torch.Tensor  # (D,) per-dimension log1p(N/df)


@register_retrieval_engine
@dataclasses.dataclass(frozen=True)
class TfIdfEngine:
    """IDF-reweighted exact search: df_j = |{i : vecs[i, j] > 0}|, corpus
    dimension j scaled by log1p(N/df_j) (corpus side only, so scores are
    sum_j w_j q_j d_j)."""

    block: int = 2048
    backend: Optional[str] = None
    name: str = "tfidf"

    def build(self, key, vecs):
        del key  # deterministic
        n = vecs.shape[0]
        df = (vecs > 0).sum(dim=0).to(torch.float32) + 1.0
        w = torch.log1p(n / df)
        return TfIdfIndex(get_backend(self.backend).prepare_corpus(
            vecs * w[None, :]), w)

    def search(self, index, queries, *, k: int):
        return self.search_scored(index, queries, k=k)[1]

    def search_scored(self, index, queries, *, k: int):
        return exact_topk(queries, index.vecs, k=k, block=self.block,
                          backend=self.backend)
