"""Sampling-strategy registry (port of ``repro/core/samplers.py``).

Every sampling strategy is a registered :class:`SamplerStrategy` behind one
``draw`` protocol. The session (``sampling_core.SamplerSession``) stages
the shared state — affinity graph, label propagation — and hands each
strategy only the pieces it declares it needs.

  * ``needs_graph`` / ``needs_labels`` — which staged inputs ``draw``
    consumes (node degrees from Alg. 1; LP labels from Alg. 2).
  * ``draw(state, key, target_size)`` — produce the sampled entity mask
    (and, for cluster sampling, the :class:`ClusterSample` diagnostics).
    ``target_size`` in (0, 1] is a fraction of the strategy's eligible
    universe, > 1 an absolute entity count, ``None`` the strategy default.

Registered strategies: ``windtunnel`` (cluster sampling of LP
communities, the paper), ``uniform`` (Bernoulli over the judged entities),
``full`` (keep everything) and ``degree_stratified`` (equal keep quota per
⌊log2(degree)⌋ bucket). Draws use the threefry keys of ``core/prng.py``, so
each mask equals the reference's bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Protocol, Tuple, runtime_checkable

import torch

from repro_torch.core import prng
from repro_torch.core import sampler as sm
from repro_torch.core import segment_utils as su
from repro_torch.core.graph_builder import QRelTable


class DrawState(NamedTuple):
    """Staged session state a strategy may consume in ``draw``."""

    qrels: QRelTable
    num_entities: int
    labels: Optional[torch.Tensor]    # i32[N] LP labels (needs_labels)
    degrees: Optional[torch.Tensor]   # i32[N] affinity degrees (needs_graph)


@runtime_checkable
class SamplerStrategy(Protocol):
    """A sampling strategy behind a uniform draw interface.

    ``salt`` decorrelates strategies drawn at the same seed: the session
    folds it into the PRNG key before ``draw``; ``salt = 0`` means the raw
    ``PRNGKey(seed)``.
    """

    name: str
    needs_graph: bool
    needs_labels: bool
    salt: int

    def draw(self, state: DrawState, key: prng.Key,
             target_size: Optional[float]
             ) -> Tuple[torch.Tensor, Optional[sm.ClusterSample]]:
        """(bool[N] entity mask, ClusterSample diagnostics or None)."""
        ...


_REGISTRY: Dict[str, SamplerStrategy] = {}


def register_sampler(cls):
    """Class decorator: instantiate and register a strategy under its name."""
    strategy = cls()
    _REGISTRY[strategy.name] = strategy
    return cls


def get_sampler(name: str) -> SamplerStrategy:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown sampler strategy {name!r}; registered strategies: "
            f"{', '.join(available_samplers())}") from None


def available_samplers() -> tuple:
    return tuple(sorted(_REGISTRY))


def judged_entities(qrels: QRelTable, num_entities: int) -> torch.Tensor:
    """bool[N]: entities with >=1 valid QRel row (the sampling universe of
    every judged-corpus baseline)."""
    e = torch.where(qrels.valid, qrels.entity_ids, num_entities)
    keep = su.in_range_rows(e, num_entities)
    cnt = torch.zeros(num_entities, dtype=torch.int32, device=e.device)
    cnt.index_add_(0, e[keep].to(torch.int64),
                   torch.ones_like(e[keep], dtype=torch.int32))
    return cnt > 0


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _resolve_count(target_size, n_eligible):
    """(0, 1) fraction-of-universe -> absolute count; >= 1 passes through."""
    if target_size is not None and target_size < 1.0:
        return _f32(target_size, n_eligible.device) * n_eligible
    return target_size


@register_sampler
@dataclasses.dataclass(frozen=True)
class FullSampler:
    """Keep the whole corpus — the fidelity report's baseline row."""

    name: str = "full"
    needs_graph = False
    needs_labels = False
    salt = 0

    def draw(self, state, key, target_size):
        del key, target_size
        return torch.ones(state.num_entities, dtype=torch.bool,
                          device=state.qrels.valid.device), None


@register_sampler
@dataclasses.dataclass(frozen=True)
class UniformSampler:
    """Bernoulli entity sampling (paper §I-A) over the judged entities, or
    over the whole corpus with ``universe="all"``."""

    universe: str = "judged"
    salt: int = 7
    name: str = "uniform"
    needs_graph = False
    needs_labels = False

    def draw(self, state, key, target_size):
        if target_size is None:
            raise ValueError("uniform sampling needs a target_size "
                             "(fraction in (0, 1] or entity count)")
        n = state.num_entities
        dev = state.qrels.valid.device
        if self.universe == "all":
            eligible = None
        elif self.universe == "judged":
            eligible = judged_entities(state.qrels, n)
        else:
            raise ValueError(f"unknown uniform universe {self.universe!r}; "
                             f"known universes: all, judged")
        if target_size <= 1.0:
            rate = _f32(target_size, dev)     # already a rate
        else:
            n_elig = (_f32(n, dev) if eligible is None
                      else eligible.to(torch.float32).sum())
            rate = _f32(target_size, dev) / torch.clamp(n_elig, min=1.0)
        mask = prng.uniform(key, (n,), dev) < rate
        if eligible is not None:
            mask = mask & eligible
        return mask, None


@register_sampler
@dataclasses.dataclass(frozen=True)
class WindTunnelSampler:
    """Cluster sampling of LP communities (Alg. 2 step 4) — a kept label
    brings ALL of its entities, so community neighbourhoods survive intact."""

    name: str = "windtunnel"
    needs_graph = True
    needs_labels = True
    salt = 0          # raw PRNGKey(seed), as the reference

    def draw(self, state, key, target_size):
        eligible = state.degrees > 0
        target = _resolve_count(target_size,
                                eligible.to(torch.float32).sum())
        sample = sm.cluster_sample(state.labels, key,
                                   num_nodes=state.num_entities,
                                   target_size=target, eligible=eligible)
        return sample.entity_mask, sample


@register_sampler
@dataclasses.dataclass(frozen=True)
class DegreeStratifiedSampler:
    """Degree-stratified random sampling: nodes are bucketed by
    ⌊log2(degree)⌋ (``num_strata`` buckets, top bucket open) and each bucket
    keeps a ``rate × |bucket|`` quota of uniformly-ranked members."""

    num_strata: int = 8
    salt: int = 13
    name: str = "degree_stratified"
    needs_graph = True
    needs_labels = False

    def draw(self, state, key, target_size):
        if target_size is None:
            raise ValueError("degree_stratified sampling needs a target_size "
                             "(fraction in (0, 1] or entity count)")
        deg = state.degrees
        n = state.num_entities
        dev = deg.device
        eligible = deg > 0
        n_elig = torch.clamp(eligible.to(torch.float32).sum(), min=1.0)
        if target_size <= 1.0:
            rate = _f32(target_size, dev)
        else:
            rate = torch.clamp(_f32(target_size, dev) / n_elig, 0.0, 1.0)
        stratum = torch.floor(torch.log2(
            torch.clamp(deg, min=1).to(torch.float32))).to(torch.int32)
        stratum = torch.clamp(stratum, 0, self.num_strata - 1)
        stratum = torch.where(eligible, stratum, self.num_strata)  # drop
        counts = su.segment_sum(torch.ones(n, dtype=torch.int32, device=dev),
                                stratum, self.num_strata + 1)
        quota = torch.round(rate * counts.to(torch.float32)).to(torch.int32)
        # random rank within each stratum: sort by (stratum, uniform draw)
        u = prng.uniform(key, (n,), dev)
        (strat_s, _), (ids_s,) = su.sort_by(
            (stratum, u), (torch.arange(n, dtype=torch.int32, device=dev),))
        rank = su.group_rank(su.run_starts(strat_s))
        top = torch.clamp(strat_s, max=self.num_strata - 1).to(torch.int64)
        keep = (strat_s < self.num_strata) & (rank < quota[top])
        mask = torch.zeros(n, dtype=torch.bool, device=dev)
        mask[ids_s.to(torch.int64)] = keep
        return mask, None
