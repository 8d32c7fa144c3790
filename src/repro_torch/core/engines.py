"""Label-propagation engine registry (port of ``repro/core/engines.py``).

Each execution strategy of the GraphSampler's hot loop (Alg. 2 steps 1-3)
is a registered object behind one protocol, selected by name:

  * ``prepare(src, dst, w, valid, *, num_nodes, max_degree)`` — one-time
    layout transform of the symmetrized edge list;
  * ``round(labels, state)`` — one weighted-LP round;
  * ``finalize(labels, changes)`` — package the result.

Registered engines:

  * ``sort`` — sort/segment reduce-by-key rounds over the raw edge list
               (unbounded degree).
  * ``ell``  — dense degree-capped ELL rounds in plain PyTorch; its round
               is the plain version of the ``cuda`` kernel.
  * ``cuda`` — the same ELL layout with each round in the hand-written
               CUDA kernel (kernels/label_prop, csrc/lp_round.cu), which
               also does the neighbour-label gather. It runs only on a
               CUDA device (``needs_cuda``); the parity tests map it to
               the reference's ``pallas`` engine.

All three produce identical labels on graphs whose maximum degree fits the
ELL cap.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Protocol, runtime_checkable

import torch

from repro_torch.core import label_prop as lp


@runtime_checkable
class LPEngine(Protocol):
    """Execution strategy for weighted label propagation."""

    name: str
    needs_cuda: bool

    def prepare(self, src, dst, w, valid, *, num_nodes: int,
                max_degree: int) -> Any:
        """Edge list -> engine-private adjacency state."""
        ...

    def round(self, labels: torch.Tensor, state: Any) -> torch.Tensor:
        """One LP round: labels i32[N] -> new labels i32[N]."""
        ...

    def finalize(self, labels: torch.Tensor,
                 changes: torch.Tensor) -> lp.LabelPropResult:
        ...


_REGISTRY: Dict[str, LPEngine] = {}


def register(cls):
    """Class decorator: instantiate and register an engine under its name."""
    engine = cls()
    _REGISTRY[engine.name] = engine
    return cls


def get_engine(name: str) -> LPEngine:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown label-prop engine {name!r}; registered engines: "
            f"{', '.join(available_engines())}") from None


def available_engines() -> tuple:
    return tuple(sorted(_REGISTRY))


def run_engine(engine: LPEngine, src, dst, w, valid, *, num_nodes: int,
               max_degree: int, rounds: int) -> lp.LabelPropResult:
    """Shared multi-round driver: prepare once, loop the engine's round."""
    state = engine.prepare(src, dst, w, valid, num_nodes=num_nodes,
                           max_degree=max_degree)
    labels = torch.arange(num_nodes, dtype=torch.int32, device=src.device)
    changes = torch.zeros(rounds, dtype=torch.int32, device=src.device)
    for r in range(rounds):
        new = engine.round(labels, state)
        changes[r] = (new != labels).sum()
        labels = new
    return engine.finalize(labels, changes)


class _EdgeListState(NamedTuple):
    src: torch.Tensor
    dst: torch.Tensor
    w: torch.Tensor
    valid: torch.Tensor
    num_nodes: int


class _EllState(NamedTuple):
    nbr: torch.Tensor   # i32[N, K] neighbour ids, -1 padding
    wgt: torch.Tensor   # f32[N, K]


@register
class SortEngine:
    """Reference engine: reduce-by-(dst,label) + reduce-by-dst argmax as
    sort + segment ops per round. Handles unbounded degree."""

    name = "sort"
    needs_cuda = False

    def prepare(self, src, dst, w, valid, *, num_nodes: int,
                max_degree: int) -> _EdgeListState:
        del max_degree  # the sort engine never caps degree
        return _EdgeListState(src, dst, w, valid, num_nodes)

    def round(self, labels, state: _EdgeListState):
        return lp.sort_round(labels, state.src, state.dst, state.w,
                             state.valid, state.num_nodes)

    def finalize(self, labels, changes):
        return lp.LabelPropResult(labels, changes)


@register
class EllEngine:
    """Dense degree-capped engine: the (N, K) ELL layout the CUDA kernel
    consumes, executed in plain PyTorch."""

    name = "ell"
    needs_cuda = False

    def prepare(self, src, dst, w, valid, *, num_nodes: int,
                max_degree: int) -> _EllState:
        return _EllState(*lp.edges_to_ell(src, dst, w, valid,
                                          num_nodes=num_nodes,
                                          max_degree=max_degree))

    def round(self, labels, state: _EllState):
        return lp.ell_round(labels, state.nbr, state.wgt)

    def finalize(self, labels, changes):
        return lp.LabelPropResult(labels, changes)


@register
class CudaEngine(EllEngine):
    """ELL layout with each round (gather, score, argmax) in the CUDA
    kernel ``lp_round``."""

    name = "cuda"
    needs_cuda = True

    def round(self, labels, state: _EllState):
        from repro_torch.kernels.label_prop.ops import label_prop_round
        return label_prop_round(labels, state.nbr, state.wgt)
