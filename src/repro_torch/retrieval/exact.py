"""Exact top-k retrieval (brute-force oracle), dispatched through the
scoring-backend registry (port of ``repro/retrieval/exact.py``): ``torch``
runs the blocked streaming merge, ``cuda`` the top-k kernel."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.retrieval.backends import get_backend


def exact_topk(queries: torch.Tensor, corpus: torch.Tensor, *, k: int,
               block: int = 4096, backend: str = "torch"):
    """queries (Q, D), corpus (N, D) -> (scores (Q, k), ids (Q, k));
    score -inf / id -1 padding when k exceeds the corpus size. ``block``
    tunes the torch backend's streaming block."""
    bk = get_backend(backend)
    if backend == "torch" and block != bk.block:
        bk = dataclasses.replace(bk, block=block)
    return bk.topk(queries, corpus, k=k)
