"""Declarative experiment plans with trie-shared stage execution (a copy of
``repro/eval/plans.py``; framework-free).

A grid of runs (sampler × engine × k × metric) is declared as a
:class:`GridSpec` and expanded into :class:`RunSpec` cells.  Each cell names
the same six-stage pipeline

    corpus → embed → sample → index → search → metric

and cells that agree on a prefix share it: the stage trie keys every node by
its full path, so the corpus and its embeddings materialise once, each
sampler's mask once, each (sampler, engine) index once, and each
(sampler, engine, k) search once — only the final metric is per-cell.  This
is the PyTerrier declarative-pipeline pattern (Macdonald 2020) combined with
the trie-based experiment-plan optimisation of Anu & Macdonald: common
pipeline prefixes across a grid of runs execute exactly once.

Per-node ``executions``/``requests`` counters make the saving observable —
``PlanTrie.summary()`` prints, per stage, how many cell walks were served
from cache instead of recomputed.  The counters live in a per-trie
:class:`~repro_torch.obs.metrics.Registry` (``plan.executions.<stage>`` /
``plan.requests.<stage>``; ``stage_counts()`` reads them back in the
legacy shape), and every stage-node execution runs inside an
``eval.<stage>`` span, so a grid's trace shows exactly which nodes ran
and for how long (DESIGN.md §12).

The trie is deliberately generic: stages are supplied as callables by the
runner (``runner.py``), so new stage semantics (a different embedder, a
sharded index build) plug in without touching the plan machinery.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, List, Mapping, Tuple

from repro_torch.obs import Registry, trace

#: Stage order of the experiment pipeline; also the trie depth order.
STAGES = ("corpus", "embed", "sample", "index", "search", "metric")


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Declarative (sampler × engine × k × metric) experiment grid."""

    samplers: Tuple[str, ...] = ("full", "uniform", "windtunnel")
    engines: Tuple[str, ...] = ("exact", "ivfflat", "lsh", "tfidf")
    ks: Tuple[int, ...] = (3, 10)
    metrics: Tuple[str, ...] = ("precision", "recall", "ndcg", "mrr")
    sample_frac: float = 0.15     # sample size as a fraction of judged corpus
    max_queries: int = 512        # per-sample query subsample cap
    seed: int = 0

    @property
    def num_cells(self) -> int:
        return (len(self.samplers) * len(self.engines) * len(self.ks)
                * len(self.metrics))


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """One grid cell: a full root-to-leaf path through the stage trie."""

    sampler: str
    engine: str
    k: int
    metric: str

    def path(self) -> Tuple[tuple, ...]:
        """Stage segments in trie order; prefixes shared between cells that
        agree on the leading coordinates."""
        return (("corpus",), ("embed",), ("sample", self.sampler),
                ("index", self.engine), ("search", self.k),
                ("metric", self.metric))

    @property
    def key(self) -> Tuple[str, str, int, str]:
        return (self.sampler, self.engine, self.k, self.metric)


def expand_grid(spec: GridSpec) -> List[RunSpec]:
    """Cross product of the grid axes, in deterministic order."""
    return [RunSpec(s, e, k, m) for s, e, k, m in itertools.product(
        spec.samplers, spec.engines, spec.ks, spec.metrics)]


@dataclasses.dataclass
class PlanNode:
    path: Tuple[tuple, ...]
    stage: str
    value: Any = None
    executions: int = 0   # times the stage fn actually ran (0 or 1)
    requests: int = 0     # times a cell walk touched this node


class PlanTrie:
    """Path-keyed stage cache: each node computes once, later walks hit.

    Counters are kept in a per-trie metrics :class:`Registry` (isolated,
    so parallel tries / repeated grids never cross-count) as
    ``plan.requests.<stage>`` / ``plan.executions.<stage>``;
    ``stage_counts()`` re-exports them in the legacy dict shape (parity
    with the per-node sums is enforced by the reference's tests/test_obs.py).
    """

    def __init__(self, metrics: Registry | None = None):
        self.nodes: Dict[Tuple[tuple, ...], PlanNode] = {}
        self._order: List[Tuple[tuple, ...]] = []
        self.metrics = metrics if metrics is not None else Registry()

    @staticmethod
    def _node_label(path: Tuple[tuple, ...]) -> str:
        return "/".join("-".join(str(p) for p in seg) for seg in path)

    def run(self, path: Tuple[tuple, ...], fn: Callable[[], Any]) -> Any:
        node = self.nodes.get(path)
        if node is None:
            node = PlanNode(path=path, stage=path[-1][0])
            self.nodes[path] = node
            self._order.append(path)
        node.requests += 1
        self.metrics.counter(f"plan.requests.{node.stage}").inc()
        if node.executions == 0:
            with trace.span(f"eval.{node.stage}", stage=node.stage,
                            node=self._node_label(path)):
                node.value = fn()
            node.executions = 1
            self.metrics.counter(f"plan.executions.{node.stage}").inc()
        return node.value

    def stage_counts(self) -> Dict[str, Tuple[int, int]]:
        """stage -> (executions, requests), read from the registry
        counters in first-touch stage order (the legacy shape)."""
        counters = self.metrics.snapshot()["counters"]
        out: Dict[str, Tuple[int, int]] = {}
        for path in self._order:
            stage = self.nodes[path].stage
            if stage not in out:
                out[stage] = (counters.get(f"plan.executions.{stage}", 0),
                              counters.get(f"plan.requests.{stage}", 0))
        return out

    def summary(self) -> str:
        lines = ["stage      executed  requested  shared"]
        for stage in STAGES:
            if stage not in self.stage_counts():
                continue
            ex, rq = self.stage_counts()[stage]
            lines.append(f"{stage:<10s} {ex:8d} {rq:10d} {rq - ex:7d}")
        return "\n".join(lines)


def execute_plan(runs: List[RunSpec],
                 stage_fns: Mapping[str, Callable[[Any, RunSpec], Any]],
                 trie: PlanTrie | None = None
                 ) -> Tuple[Dict[Tuple[str, str, int, str], Any], PlanTrie]:
    """Walk every run root-to-leaf through the trie.

    ``stage_fns[stage](parent_value, run)`` computes a node's value from its
    parent's; it runs only on the first walk that reaches the node.  Returns
    the leaf (metric) value per cell key plus the trie with its counters.
    """
    trie = trie if trie is not None else PlanTrie()
    results: Dict[Tuple[str, str, int, str], Any] = {}
    for run in runs:
        value: Any = None
        prefix: Tuple[tuple, ...] = ()
        for seg in run.path():
            prefix = prefix + (seg,)
            fn = stage_fns[seg[0]]
            parent = value
            value = trie.run(
                prefix, lambda fn=fn, parent=parent, run=run: fn(parent, run))
        results[run.key] = value
    return results, trie
