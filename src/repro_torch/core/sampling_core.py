"""Sampling core front door — build once, draw many (port of
``repro/core/sampling_core.py``).

:class:`SamplerSession` pays the expensive staged state — affinity-graph
construction (Alg. 1) and label propagation (Alg. 2 steps 1-3) — exactly
once, and every ``draw(target_size, seed)`` runs only the cheap
cluster-sampling + reconstruction tail. A size/seed
:meth:`~SamplerSession.sweep` costs one LP run.

Configuration is one declarative :class:`SamplerSpec`:

  * ``strategy`` — a registered sampling strategy (core/samplers.py);
  * ``engine``   — a registered LP engine (core/engines.py), ``None`` for
    the device's default (``cuda`` on a card, ``sort`` on the CPU);
  * ``tau_quantile`` / ``fanout`` / ``lp_rounds`` / ``max_degree``;
  * ``target_size`` / ``seed`` — per-draw defaults (``target_size`` in
    (0, 1] is a fraction of the strategy's eligible universe, > 1 an
    absolute entity count, ``None`` the strategy default).

  * ``sharded`` / ``mesh`` (a ``DeviceMesh``, launch/mesh.py) / ``axes`` —
    route the graph + LP stages through the mesh-partitioned path
    (core/sharded_pipeline.py), one rank per device; draws run on the
    replicated outputs, so a 1-rank mesh is bit-identical to the
    single-device session;
  * ``streamed`` / ``stream_chunk`` — shard the QRel table from birth
    (distributed/sharded_corpus.ShardedQRels): rows are routed host-side
    and streamed straight to their shards; a :class:`ShardedQRels` may
    also be passed directly as ``qrels`` (both imply ``sharded=True``).

The legacy entry points ``run_windtunnel`` / ``run_windtunnel_sharded`` /
``run_uniform_baseline`` are thin wrappers over a session and remain
bit-compatible; new code should construct the session directly.

Stages execute lazily and exactly once per session, with ``executions`` /
``requests`` counters, and draws are cached per (strategy, opts, target,
seed).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import engines as eng
from repro_torch.core import graph_builder as gb
from repro_torch.core import prng
from repro_torch.core import reconstructor as rc
from repro_torch.core import sampler as sm
from repro_torch.core.pipeline import WindTunnelConfig, WindTunnelResult
from repro_torch.core.samplers import DrawState, get_sampler
from repro_torch.core.sharded_pipeline import (check_engine, sharded_degrees,
                                               sharded_graph_and_labels)
from repro_torch.device import (check_runs_on, default_engine, on_device,
                                resolve_device)
from repro_torch.distributed.sharded_corpus import ShardedQRels
from repro_torch.obs import REGISTRY, trace
from repro_torch.obs import memory as obs_memory


@dataclasses.dataclass(frozen=True)
class SamplerSpec:
    """Declarative sampling-core configuration (strategy × engine × mesh)."""

    strategy: str = "windtunnel"
    engine: Optional[str] = None   # None -> device default; see module doc
    tau_quantile: float = 0.5
    fanout: int = 16
    lp_rounds: int = 5
    max_degree: int = 32
    target_size: Optional[float] = None   # default draw target (None = paper)
    seed: int = 0                         # default draw seed
    sharded: bool = False
    mesh: Any = None                      # DeviceMesh when sharded
    axes: Any = None                      # mesh axes override (sharded path)
    streamed: bool = False                # route the QRel table shard-local
    stream_chunk: int = 65536             # host->device streaming chunk rows
    strategy_opts: Optional[Mapping[str, Any]] = None

    def to_config(self) -> WindTunnelConfig:
        """The backend-knob subset as the legacy pipeline config."""
        return WindTunnelConfig(
            tau_quantile=self.tau_quantile, fanout=self.fanout,
            lp_rounds=self.lp_rounds, max_degree=self.max_degree,
            target_size=self.target_size, engine=self.engine, seed=self.seed)

    @classmethod
    def from_config(cls, config: WindTunnelConfig,
                    **overrides) -> "SamplerSpec":
        fields = {f.name: getattr(config, f.name)
                  for f in dataclasses.fields(config)}
        fields.update(overrides)
        return cls(**fields)


class SamplerDraw(NamedTuple):
    """One draw: the mask, cluster-sampling diagnostics (windtunnel only),
    and the reconstructed (Queries, Corpus, QRels) sample."""

    entity_mask: torch.Tensor
    sample: Optional[sm.ClusterSample]
    reconstructed: rc.ReconstructedSample


def _graph_stage(qrels, *, num_queries, num_entities, tau_quantile, fanout):
    edges = gb.build_affinity_graph(qrels, num_queries=num_queries,
                                    tau_quantile=tau_quantile, fanout=fanout)
    return edges, gb.node_degrees(edges, num_entities)


def _labels_stage(edges, *, engine, num_entities, max_degree, rounds):
    src, dst, w, valid = gb.symmetrize(edges)
    res = eng.run_engine(eng.get_engine(engine), src, dst, w, valid,
                         num_nodes=num_entities, max_degree=max_degree,
                         rounds=rounds)
    return res.labels, res.changes_per_round


def _draw_stage(qrels, labels, degrees, seed, *, strategy, opts, target,
                num_queries, num_entities):
    strat = get_sampler(strategy)
    if opts:
        strat = dataclasses.replace(strat, **dict(opts))
    state = DrawState(qrels, num_entities, labels, degrees)
    # per-strategy salt decorrelates same-seed draws across strategies;
    # salt 0 keeps the raw key, as the reference does
    key = prng.prng_key(seed)
    if strat.salt:
        key = prng.fold_in(key, strat.salt)
    mask, sample = strat.draw(state, key, target)
    recon = rc.reconstruct(qrels, mask, num_queries=num_queries)
    return SamplerDraw(mask, sample, recon)


@dataclasses.dataclass
class SweepResult:
    """A size × seed sweep: per-draw results plus the stage counters that
    show graph-build and LP ran once for the whole sweep."""

    strategy: str
    sizes: Tuple[float, ...]
    seeds: Tuple[int, ...]
    draws: Dict[Tuple[float, int], SamplerDraw]
    stage_counts: Dict[str, Tuple[int, int]]

    def to_json(self) -> dict:
        return {
            "strategy": self.strategy,
            "sizes": list(self.sizes),
            "seeds": list(self.seeds),
            "draws": [{"target_size": s, "seed": r,
                       "n_entities": int(d.entity_mask.sum()),
                       "n_queries": int(d.reconstructed.num_queries)}
                      for (s, r), d in sorted(self.draws.items())],
            "stage_counts": {st: {"executions": ex, "requests": rq}
                             for st, (ex, rq) in self.stage_counts.items()},
        }


class SamplerSession:
    """Build-once, draw-many sampling over one QRel table on ``device``.

    Stages — ``graph`` (Alg. 1 edges + degrees), ``labels`` (Alg. 2 LP),
    ``draw`` (cluster sampling / baseline mask + reconstruction) — execute
    lazily, each at most once per distinct draw key, and only when the
    active strategy declares it needs them. ``strategy`` can be overridden
    per draw, so one session serves every registered strategy.
    """

    STAGES = ("graph", "labels", "draw")

    def __init__(self, qrels, *, num_queries: int, num_entities: int,
                 spec: Optional[SamplerSpec] = None, device="cuda",
                 **overrides):
        cfg = spec or SamplerSpec()
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        self.device = resolve_device(device)
        get_sampler(cfg.strategy)        # registry error UX, fail fast
        engine = eng.get_engine(cfg.engine or default_engine(self.device))
        check_runs_on("engine", engine.name, engine.needs_cuda, self.device)
        cfg = dataclasses.replace(cfg, engine=engine.name)
        born = qrels if isinstance(qrels, ShardedQRels) else None
        if born is None and cfg.streamed:
            if cfg.mesh is None:
                raise ValueError("streamed sampling needs a mesh; pass "
                                 "SamplerSpec(mesh=...) (launch.mesh "
                                 "helpers)")
            born = ShardedQRels.from_host(
                qrels, num_queries=num_queries, num_entities=num_entities,
                mesh=cfg.mesh, axes=cfg.axes, chunk_rows=cfg.stream_chunk,
                device=self.device)
        if born is not None:
            # sharded-from-birth tables force the mesh-partitioned stages
            # (the global stages would gather what birth sharding avoids)
            if (born.num_queries, born.num_entities) != (num_queries,
                                                         num_entities):
                raise ValueError(
                    f"ShardedQRels routed for {born.num_queries} queries / "
                    f"{born.num_entities} entities; session asked for "
                    f"{num_queries} / {num_entities}")
            if not on_device(born.query_ids, self.device):
                raise ValueError(
                    f"ShardedQRels live on {born.query_ids.device}; the "
                    f"session runs on {self.device}")
            cfg = dataclasses.replace(cfg, sharded=True, streamed=True,
                                      mesh=born.mesh, axes=born.axes)
        if cfg.sharded:
            if cfg.mesh is None:
                raise ValueError("sharded sampling needs a mesh; pass "
                                 "SamplerSpec(mesh=...) (launch.mesh helpers)")
            check_engine(cfg.engine)
        self.spec = cfg
        self._born = born
        # draws run on the flat table (the born one all-gathered in shard
        # order): reconstruction and every registered strategy are
        # row-order-free, so the born permutation is invisible downstream
        self.qrels = (gb.QRelTable(*born.table()) if born is not None
                      else gb.QRelTable(*qrels).to(self.device))
        self.num_queries = num_queries
        self.num_entities = num_entities
        self._graph = None      # (edges, degrees)
        self._labels = None     # (labels, changes_per_round)
        self._draws: Dict[tuple, SamplerDraw] = {}
        self._counts = {stage: [0, 0] for stage in self.STAGES}

    # -- staged state -------------------------------------------------------

    def _stage_sharded(self) -> None:
        """The mesh-partitioned dataflow computes graph AND labels; both
        stage slots fill from it. It is traced as ``sampling.graph`` (where
        the wall time lives) plus a zero-cost ``sampling.labels`` marker
        with ``fused=True``, so per-stage aggregates list both stages on
        either path. On the born path the degrees sum the ranks' edge
        slices (an integer all-reduce)."""
        born = self._born is not None
        with trace.device_span("sampling.graph", sharded=True,
                               streamed=born, engine=self.spec.engine,
                               n=self.num_entities, q=self.num_queries,
                               fused_labels=True) as sp:
            edges, labels, changes = sharded_graph_and_labels(
                self._born if born else self.qrels,
                num_queries=self.num_queries,
                num_entities=self.num_entities, config=self.spec.to_config(),
                mesh=self.spec.mesh, axes=self.spec.axes)
            degrees = sharded_degrees(
                edges, self.num_entities, born=born, mesh=self.spec.mesh,
                axes=self._born.axes if born else self.spec.axes)
            self._graph = (edges, degrees)
            self._labels = (labels, changes)
            sp.declare(self._graph, self._labels)
        obs_memory.record_build_peak()
        with trace.span("sampling.labels", sharded=True, fused=True,
                        engine=self.spec.engine):
            pass
        self._counts["graph"][0] += 1
        self._counts["labels"][0] += 1

    def graph(self) -> tuple:
        """(EdgeList, degrees i32[N]) — Alg. 1, executed once per session
        (the rank's slice of the edges on the born path)."""
        self._counts["graph"][1] += 1
        if self._graph is None:
            if self.spec.sharded:
                self._stage_sharded()
            else:
                with trace.device_span("sampling.graph",
                                       n=self.num_entities,
                                       q=self.num_queries,
                                       tau=self.spec.tau_quantile,
                                       fanout=self.spec.fanout) as sp:
                    self._graph = _graph_stage(
                        self.qrels, num_queries=self.num_queries,
                        num_entities=self.num_entities,
                        tau_quantile=self.spec.tau_quantile,
                        fanout=self.spec.fanout)
                    sp.declare(self._graph)
                self._counts["graph"][0] += 1
        return self._graph

    def labels(self) -> tuple:
        """(labels i32[N], changes i32[rounds]) — Alg. 2 LP, executed once."""
        self._counts["labels"][1] += 1
        if self._labels is None:
            if self.spec.sharded:
                self._stage_sharded()
            else:
                edges, _ = self.graph()
                with trace.device_span("sampling.labels",
                                       engine=self.spec.engine,
                                       n=self.num_entities,
                                       rounds=self.spec.lp_rounds,
                                       max_degree=self.spec.max_degree) as sp:
                    self._labels = _labels_stage(
                        edges, engine=self.spec.engine,
                        num_entities=self.num_entities,
                        max_degree=self.spec.max_degree,
                        rounds=self.spec.lp_rounds)
                    sp.declare(self._labels)
                self._counts["labels"][0] += 1
        return self._labels

    # -- draws --------------------------------------------------------------

    def _strategy(self, name: Optional[str]):
        strat = get_sampler(name or self.spec.strategy)
        opts = ()
        if self.spec.strategy_opts and strat.name == self.spec.strategy:
            opts = tuple(sorted(dict(self.spec.strategy_opts).items()))
            strat = dataclasses.replace(strat, **dict(opts))
        return strat, opts

    def draw(self, target_size: Optional[float] = None,
             seed: Optional[int] = None,
             strategy: Optional[str] = None) -> SamplerDraw:
        """One sample at (target_size, seed); cached per distinct draw key.

        ``target_size`` / ``seed`` default to the spec's; ``strategy``
        overrides the spec's strategy for this draw only.
        """
        strat, opts = self._strategy(strategy)
        target = self.spec.target_size if target_size is None else target_size
        target = None if target is None else float(target)
        seed = self.spec.seed if seed is None else int(seed)
        key = (strat.name, opts, target, seed)
        self._counts["draw"][1] += 1
        hit = key in self._draws
        REGISTRY.counter(
            "sampling.draw.hit" if hit else "sampling.draw.miss").inc()
        if not hit:
            labels = self.labels()[0] if strat.needs_labels else None
            degrees = self.graph()[1] if strat.needs_graph else None
            with trace.device_span("sampling.draw",
                                   compile_key=f"sampling.draw/{strat.name}",
                                   strategy=strat.name, target=target,
                                   seed=seed, cache="miss") as sp:
                self._draws[key] = _draw_stage(
                    self.qrels, labels, degrees, seed, strategy=strat.name,
                    opts=opts, target=target, num_queries=self.num_queries,
                    num_entities=self.num_entities)
                sp.declare(self._draws[key])
            self._counts["draw"][0] += 1
        return self._draws[key]

    def result(self, target_size: Optional[float] = None,
               seed: Optional[int] = None) -> WindTunnelResult:
        """Full :class:`WindTunnelResult` (edges, labels, changes, sample,
        reconstruction, degrees) for cluster-sampling strategies."""
        draw = self.draw(target_size, seed)
        if draw.sample is None:
            raise ValueError(
                f"strategy {self.spec.strategy!r} has no cluster-sample "
                f"diagnostics; use draw() for baseline strategies")
        edges, degrees = self.graph()
        labels, changes = self.labels()
        return WindTunnelResult(edges, labels, changes, draw.sample,
                                draw.reconstructed, degrees)

    def sweep(self, sizes, seeds, *,
              strategy: Optional[str] = None) -> SweepResult:
        """Draw every (target_size, seed) cell; graph + LP run at most once
        for the whole sweep (``stage_counts`` records this sweep's delta)."""
        sizes = tuple(float(s) for s in sizes)
        seeds = tuple(int(r) for r in seeds)
        strat, _ = self._strategy(strategy)
        before = self.stage_counts()
        draws = {(s, r): self.draw(target_size=s, seed=r, strategy=strategy)
                 for s in sizes for r in seeds}
        after = self.stage_counts()
        delta = {st: (after[st][0] - before[st][0],
                      after[st][1] - before[st][1]) for st in after}
        return SweepResult(strat.name, sizes, seeds, draws, delta)

    # -- observability ------------------------------------------------------

    def stage_counts(self) -> Dict[str, Tuple[int, int]]:
        """stage -> (executions, requests)."""
        return {stage: tuple(c) for stage, c in self._counts.items()}

    def summary(self) -> str:
        lines = ["stage      executed  requested  shared"]
        for stage in self.STAGES:
            ex, rq = self._counts[stage]
            lines.append(f"{stage:<10s} {ex:8d} {rq:10d} {rq - ex:7d}")
        return "\n".join(lines)
