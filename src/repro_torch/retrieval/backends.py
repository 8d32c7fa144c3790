"""Scoring-backend registry — Layer 1 of the search core (port of
``repro/retrieval/backends.py``).

Every retrieval engine bottoms out in one of three scoring primitives:
``topk`` (dense inner-product top-k against a shared corpus),
``hamming_topk`` (packed sign-code Hamming top-k, the lsh scan) and
``gathered_topk`` (per-query candidate-set top-k, the ivfflat probe).
A backend implements all three behind one protocol. Registered:

  * ``torch`` — plain PyTorch: blocked streaming top-k (the (Q, N) score
                matrix is never materialised); the plain version of the
                kernel. The parity tests map it to the reference's ``jnp``.
  * ``cuda``  — the hand-written CUDA kernels (kernels/topk_scoring and
                kernels/lsh_hamming, csrc/topk_scores.cu and
                csrc/hamming_topk.cu). It runs only on
                a CUDA device (``needs_cuda``); the parity tests map it to
                ``pallas``.
  * ``int8``  — quantized dense scan + float rerank tail, as the
                reference's: the corpus is quantized once at index build
                (``prepare_corpus`` -> :class:`QuantizedCorpus`), queries
                per call; the int8 top-k kernel (its plain version on a CPU
                tensor) scans for the top ``rerank_factor*k`` candidates on
                the raw integer dot, and :func:`rerank_candidates` rescores
                them in f32. It runs on either device. Hamming and
                gathered scoring go to the kernels' wrappers, which run the
                kernel on a CUDA tensor and the plain version on a CPU one,
                as the reference's delegate to its pallas kernels.

``prepare_corpus`` is the build-time hook: engines pass their corpus-side
matrix through it (identity for torch/cuda, quantization for int8).

``gathered_topk`` keeps the reference's dense signature, candidate vectors
(Q, C, D); ``gathered_rows_topk`` is the form the ivfflat probe calls,
candidate c of query q being row ``cand_rows[q, c]`` of a table (the
index's inverted lists), so the (Q, C, D) block is never built. The dense
form maps onto it.

Tie policy, as in the reference: results are score-descending and equal
scores break toward the lower candidate id (``topk``, ``hamming_topk``) or
the earlier candidate position (``gathered_topk``). Misses — k larger than
the candidate count, or invalid slots — come back as score -inf / id -1.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Protocol, runtime_checkable

import torch

from repro_torch.distributed.compression import quantize_int8
from repro_torch.kernels.lsh_hamming import ops as lsh_ops
from repro_torch.kernels.lsh_hamming.ref import hamming_topk_ref
from repro_torch.kernels.topk_scoring import ops as topk_ops
from repro_torch.kernels.topk_scoring.ref import (gathered_topk_ref,
                                                  pad_topk, topk_scores_ref)


@runtime_checkable
class ScoringBackend(Protocol):
    """Execution strategy for the scoring primitives."""

    name: str
    needs_cuda: bool

    def prepare_corpus(self, vecs: torch.Tensor):
        """Build-time hook: corpus f32[N, D] -> whatever layout ``topk``
        consumes (identity for the float backends)."""
        ...

    def topk(self, queries: torch.Tensor, corpus, *, k: int):
        """(Q, D) x prepared corpus -> (scores f32[Q, k], ids i32[Q, k])."""
        ...

    def hamming_topk(self, q_codes, c_codes, *, k: int):
        """Packed codes (Q, W) x (N, W) -> (-distance f32[Q, k], ids)."""
        ...

    def gathered_topk(self, queries, cand_vecs, cand_ids, *, k: int):
        """(Q, D) x (Q, C, D) with ids (Q, C), -1 = invalid slot."""
        ...

    def gathered_rows_topk(self, queries, table, cand_rows, cand_ids, *,
                           k: int):
        """(Q, D) x rows ``cand_rows`` (Q, C) of ``table`` (R, D), ids
        (Q, C), -1 = invalid slot."""
        ...


_REGISTRY: Dict[str, ScoringBackend] = {}


def register_backend(cls):
    """Class decorator: instantiate and register a backend under its name."""
    backend = cls()
    _REGISTRY[backend.name] = backend
    return cls


def get_backend(name: str) -> ScoringBackend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown scoring backend {name!r}; registered backends: "
            f"{', '.join(available_backends())}") from None


def available_backends() -> tuple:
    return tuple(sorted(_REGISTRY))


class QuantizedCorpus(NamedTuple):
    """Int8-quantized corpus built once per index (``prepare_corpus``):
    codes for the kernel scan, the global scale, and the original float
    vectors kept for the exact rerank tail."""

    codes: torch.Tensor   # (N, D) int8
    scale: torch.Tensor   # () f32 global max-abs scale
    vecs: torch.Tensor    # (N, D) f32 originals (rerank + float backends)


def _float_corpus(corpus) -> torch.Tensor:
    """Float view of a prepared corpus, so the float backends can search an
    index an int8-backed engine built."""
    return corpus.vecs if isinstance(corpus, QuantizedCorpus) else corpus


def rerank_candidates(vecs: torch.Tensor, queries: torch.Tensor,
                      cand: torch.Tensor, *, k: int):
    """Exact inner-product rerank of per-query candidate ids (-1 = miss):
    (Q, R) -> top-k (scores, ids), ties to the earlier candidate as
    ``lax.top_k`` gives them."""
    cvecs = vecs[cand.clamp(min=0).long()]                   # (Q, R, D)
    s = torch.einsum("qd,qrd->qr", queries, cvecs)
    s = torch.where(cand >= 0, s, -torch.inf)
    pos = torch.sort(s, dim=1, descending=True,
                     stable=True).indices[:, :min(k, cand.shape[1])]
    top_s = torch.gather(s, 1, pos)
    top_i = torch.gather(cand, 1, pos)
    top_i = torch.where(torch.isfinite(top_s), top_i, -1)
    return pad_topk(top_s, top_i, k)


def _dense_candidates(cand_vecs: torch.Tensor):
    """The reference's dense candidate block (Q, C, D) as a table and rows:
    (cand_vecs.reshape(Q*C, D), rows i32[Q, C] with rows[q, c] = q*C + c)."""
    qn, c, d = cand_vecs.shape
    if qn * c >= 2 ** 31:
        raise ValueError(f"gathered_topk: Q*C = {qn * c} candidate rows "
                         f"exceed int32")
    rows = torch.arange(qn * c, dtype=torch.int32,
                        device=cand_vecs.device).reshape(qn, c)
    return cand_vecs.reshape(qn * c, d), rows


class _AnnPrimitives:
    """``hamming_topk`` / ``gathered_rows_topk`` through the kernels'
    dispatch wrappers (the kernel on a CUDA tensor, its plain version on a
    CPU one), and ``gathered_topk`` mapped onto the row form."""

    def hamming_topk(self, q_codes, c_codes, *, k: int):
        return lsh_ops.hamming_topk(q_codes, c_codes, k=k)

    def gathered_rows_topk(self, queries, table, cand_rows, cand_ids, *,
                           k: int):
        return topk_ops.gathered_topk(queries, table, cand_rows, cand_ids,
                                      k=k)

    def gathered_topk(self, queries, cand_vecs, cand_ids, *, k: int):
        table, rows = _dense_candidates(cand_vecs)
        return self.gathered_rows_topk(queries, table, rows, cand_ids, k=k)


@register_backend
@dataclasses.dataclass(frozen=True)
class TorchBackend(_AnnPrimitives):
    """Plain PyTorch backend (the oracle the cuda backend is tested
    against)."""

    block: int = 4096
    name: str = "torch"
    needs_cuda = False

    def prepare_corpus(self, vecs):
        return vecs

    def topk(self, queries, corpus, *, k: int):
        return topk_scores_ref(queries, _float_corpus(corpus), k=k,
                               block=self.block)

    def hamming_topk(self, q_codes, c_codes, *, k: int):
        k_eff = min(k, c_codes.shape[0])
        return pad_topk(*hamming_topk_ref(q_codes, c_codes, k=k_eff,
                                          block=self.block), k)

    def gathered_rows_topk(self, queries, table, cand_rows, cand_ids, *,
                           k: int):
        k_eff = min(k, cand_ids.shape[1])
        return pad_topk(*gathered_topk_ref(queries, table, cand_rows,
                                           cand_ids, k=k_eff), k)


@register_backend
@dataclasses.dataclass(frozen=True)
class CudaBackend(_AnnPrimitives):
    """The CUDA kernels; the dispatch wrappers in kernels/*/ops.py own
    k-clamping and padding."""

    name: str = "cuda"
    needs_cuda = True

    def prepare_corpus(self, vecs):
        return vecs

    def topk(self, queries, corpus, *, k: int):
        return topk_ops.topk_scores(queries, _float_corpus(corpus), k=k)


@register_backend
@dataclasses.dataclass(frozen=True)
class Int8Backend(_AnnPrimitives):
    """Quantized dense scan + float rerank tail.

    The int8 kernel scans the quantized corpus for the top
    ``rerank_factor*k`` candidates on the raw integer dot (scale-invariant
    ranking: both scales are global positive constants), then
    :func:`rerank_candidates` rescores those candidates with the original
    f32 vectors: exact-at-k whenever the true top-k survives into the int8
    candidate pool (``eval/fidelity.backend_recall_curve`` measures the
    trade).

    Hamming and gathered scoring go to the kernels' wrappers by the
    tensors' device: codes are already 1-bit, and the ivfflat probe has
    already shrunk the candidate set, so quantizing buys nothing there."""

    rerank_factor: int = 4
    name: str = "int8"
    needs_cuda = False

    def prepare_corpus(self, vecs):
        codes, scale = quantize_int8(vecs)
        return QuantizedCorpus(codes, scale, vecs)

    def topk(self, queries, corpus, *, k: int):
        qc = (corpus if isinstance(corpus, QuantizedCorpus)
              else self.prepare_corpus(corpus))
        n = qc.codes.shape[0]
        pool = min(max(self.rerank_factor * k, k), n)
        q_codes, _ = quantize_int8(queries.to(torch.float32))
        _, cand = topk_ops.topk_scores_int8(q_codes, qc.codes, k=pool)
        return rerank_candidates(qc.vecs, queries, cand, k=k)
