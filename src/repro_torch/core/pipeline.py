"""WindTunnel pipeline orchestration: GraphBuilder -> GraphSampler ->
CorpusReconstructor (paper Fig. 3); port of ``repro/core/pipeline.py``.

The implementation lives in the sampling core (sampling_core.py, DESIGN.md
§10): a ``SamplerSession`` stages graph build -> label propagation once and
draws many samples against the cached labels. ``run_windtunnel`` and
``run_uniform_baseline`` below are the legacy one-shot entry points, kept
as thin bit-compatible wrappers over a fresh session (one release of
deprecation; see their docstrings). Both run on the card unless
``device="cpu"``.

The GraphSampler execution strategy is resolved through the engine registry
(engines.py): ``WindTunnelConfig.engine`` names any registered ``LPEngine``
— ``sort``, ``ell`` or ``cuda`` (the LP kernel) — or is ``None``, the
device's default (``device.default_engine``: ``cuda`` on a card, ``sort``
on the CPU), as ``SamplerSpec.engine`` is. The reference's field defaults
to ``sort``; a copy of that default would keep ``run_windtunnel`` on the
card off the LP kernel.

The multi-device ``run_windtunnel_sharded`` lives in
``core/sharded_pipeline.py``.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import NamedTuple, Optional

import torch

from repro_torch.core import graph_builder as gb
from repro_torch.core import reconstructor as rc
from repro_torch.core import sampler as sm

log = logging.getLogger("repro_torch.core.pipeline")
_DEPRECATION_NOTED: set = set()


def note_deprecated(name: str, replacement: str) -> None:
    """Log a one-per-process deprecation note for a legacy entry point
    through the ``repro_torch.*`` logger hierarchy."""
    if name not in _DEPRECATION_NOTED:
        _DEPRECATION_NOTED.add(name)
        log.warning("%s is deprecated (one release); use %s",
                    name, replacement)


@dataclasses.dataclass(frozen=True)
class WindTunnelConfig:
    """Configuration of the full sampling pipeline."""
    tau_quantile: float = 0.5     # paper: 'scores in the top 50%'
    fanout: int = 16              # per-query entity cap in Alg. 1 (ELL width)
    lp_rounds: int = 5            # fixed LP round count (Alg. 2 termination)
    max_degree: int = 32          # ELL engine: per-node neighbour cap
    target_size: Optional[float] = None  # None -> paper's exact |L|/N rule
    engine: Optional[str] = None  # None -> the device's default engine
    seed: int = 0


class WindTunnelResult(NamedTuple):
    """Everything one cluster-sampling run produced."""

    edges: gb.EdgeList
    labels: torch.Tensor
    changes_per_round: torch.Tensor
    sample: sm.ClusterSample
    reconstructed: rc.ReconstructedSample
    degrees: torch.Tensor


def run_windtunnel(qrels, *, num_queries: int, num_entities: int,
                   config: WindTunnelConfig, device="cuda"
                   ) -> WindTunnelResult:
    """One-shot GraphBuilder -> GraphSampler -> CorpusReconstructor run.

    .. deprecated:: next release — thin wrapper over
       ``sampling_core.SamplerSession``, kept one release for existing
       callers. The session amortizes graph build + label propagation
       across many ``draw(target_size, seed)`` calls; this wrapper re-pays
       them on every call. Bit-compatible with the reference's
       (tests/test_torch_pipeline.py enforces parity).
    """
    from repro_torch.core.sampling_core import SamplerSession, SamplerSpec
    note_deprecated("run_windtunnel",
                    "sampling_core.SamplerSession (build once, draw many)")
    session = SamplerSession(
        qrels, num_queries=num_queries, num_entities=num_entities,
        spec=SamplerSpec.from_config(config, strategy="windtunnel"),
        device=device)
    return session.result()


def run_uniform_baseline(qrels, *, num_queries: int, num_entities: int,
                         rate: float, seed: int = 0, device="cuda"
                         ) -> rc.ReconstructedSample:
    """The uniform-random baseline the paper compares against.

    .. deprecated:: next release — thin wrapper over
       ``sampling_core.SamplerSession`` with the registered ``uniform``
       strategy (``universe="all"`` reproduces the legacy whole-corpus
       Bernoulli draw bit-exactly), kept one release for existing callers.
    """
    from repro_torch.core.sampling_core import SamplerSession, SamplerSpec
    note_deprecated("run_uniform_baseline",
                    "SamplerSession with the 'uniform' strategy")
    session = SamplerSession(
        qrels, num_queries=num_queries, num_entities=num_entities,
        spec=SamplerSpec(strategy="uniform", seed=seed,
                         strategy_opts={"universe": "all", "salt": 0}),
        device=device)
    return session.draw(target_size=rate).reconstructed
