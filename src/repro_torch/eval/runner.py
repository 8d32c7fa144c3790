"""Grid runner — stage implementations for the experiment-plan trie (port
of ``repro/eval/runner.py``).

``run_grid`` walks every (sampler × engine × k × metric) cell of a
:class:`~repro_torch.eval.plans.GridSpec` through the stage trie over one
:class:`~repro_torch.data.synthetic.SyntheticCorpus`:

  corpus  — qrel lookup structures (pair set + per-query dict), built once.
  embed   — entity + query vectors from a pluggable embedder (default: the
            deterministic tf-idf embedder), built once and moved to the
            device once.
  sample  — entity mask from one shared
            :class:`~repro_torch.core.sampling_core.SamplerSession`, so the
            affinity graph and label propagation are staged at most once
            for the whole grid; associated queries and query density.
  index   — a :class:`~repro_torch.retrieval.search_core.SearchSession`
            over the sample's kept vectors, once per (sampler, engine).
  search  — chunked search mapped back to global entity ids, once per
            (sampler, engine, k).
  metric  — scalar from the metric registry, per cell.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import associated_queries, prng, query_density
from repro_torch.core.samplers import available_samplers, get_sampler
from repro_torch.core.sampling_core import SamplerSession, SamplerSpec
from repro_torch.data.synthetic import SyntheticCorpus
from repro_torch.device import resolve_device
from repro_torch.eval.plans import (GridSpec, PlanTrie, RunSpec,
                                    execute_plan, expand_grid)
from repro_torch.retrieval.metrics import (mrr, ndcg_at_k, precision_at_k,
                                           qrel_dict, qrel_set, recall_at_k)
from repro_torch.retrieval.search_core import SearchConfig, SearchSession
from repro_torch.retrieval.tfidf import tfidf_vectors

__all__ = ["GridResult", "run_grid", "tfidf_embedder", "available_samplers"]

log = logging.getLogger("repro_torch.eval.runner")


# metric registry: name -> fn(global_ids, qids, ctx, k) -> float, where ctx
# is the corpus-stage value ({"pairs": set, "by_query": dict}).
METRICS: Dict[str, Callable[..., float]] = {
    "precision": lambda ids, qids, ctx, k:
        precision_at_k(ids, qids, ctx["pairs"], k=k),
    "recall": lambda ids, qids, ctx, k:
        recall_at_k(ids, qids, ctx["by_query"], k=k),
    "ndcg": lambda ids, qids, ctx, k:
        ndcg_at_k(ids, qids, ctx["by_query"], k=k),
    "mrr": lambda ids, qids, ctx, k:
        mrr(ids, qids, ctx["by_query"], k=k),
}


def tfidf_embedder(corpus: SyntheticCorpus):
    """Default embedder: deterministic tf-idf bag-of-words vectors for both
    entities and queries (document df reused for the queries)."""
    ev, df = tfidf_vectors(corpus.passage_tokens, corpus.vocab_size)
    qv, _ = tfidf_vectors(corpus.query_tokens, corpus.vocab_size, df=df)
    return ev, qv


@dataclasses.dataclass
class GridResult:
    spec: GridSpec
    cells: Dict[Tuple[str, str, int, str], float]
    sampler_stats: Dict[str, Dict[str, float]]
    trie: PlanTrie

    def to_json(self) -> dict:
        return {
            "spec": dataclasses.asdict(self.spec),
            "cells": [{"sampler": s, "engine": e, "k": k, "metric": m,
                       "value": v}
                      for (s, e, k, m), v in sorted(self.cells.items())],
            "sampler_stats": self.sampler_stats,
            "stage_counts": {st: {"executions": ex, "requests": rq}
                             for st, (ex, rq)
                             in self.trie.stage_counts().items()},
        }


def run_grid(corpus: SyntheticCorpus, spec: GridSpec, *,
             embedder: Optional[Callable] = None, query_chunk: int = 256,
             search: Optional[SearchConfig] = None,
             sampler: Optional[SamplerSpec] = None,
             verbose: bool = False, device="cuda") -> GridResult:
    """Execute every cell of ``spec`` over ``corpus`` via the plan trie, on
    ``device``.

    ``search`` configures the search core (backend) for the index+search
    stages; ``sampler`` configures the sampling core (LP engine, knobs).
    The grid's ``sample_frac``/``seed`` override the sampler spec's
    defaults so every strategy is size-matched at the same fraction of the
    judged corpus.
    """
    dev = resolve_device(device)
    embedder = embedder or tfidf_embedder
    search = search or SearchConfig()
    sampler_spec = dataclasses.replace(
        sampler or SamplerSpec(),
        target_size=spec.sample_frac * corpus.num_primary, seed=spec.seed)
    sampler_stats: Dict[str, Dict[str, float]] = {}

    session_box: list = []

    def _session() -> SamplerSession:
        """One SamplerSession shared by every sampler in the grid."""
        if not session_box:
            session_box.append(SamplerSession(
                corpus.qrels, num_queries=corpus.num_queries,
                num_entities=corpus.num_entities, spec=sampler_spec,
                device=dev))
        return session_box[0]

    def stage_corpus(parent: Any, run: RunSpec) -> dict:
        del parent, run
        qr = corpus.qrels
        return {"pairs": qrel_set(qr.query_ids, qr.entity_ids, qr.valid),
                "by_query": qrel_dict(qr.query_ids, qr.entity_ids, qr.valid)}

    def stage_embed(ctx: dict, run: RunSpec) -> dict:
        del run
        ev, qv = embedder(corpus)
        return {**ctx, "ev": torch.as_tensor(np.asarray(ev)).to(dev),
                "qv": torch.as_tensor(np.asarray(qv)).to(dev)}

    def stage_sample(ctx: dict, run: RunSpec) -> dict:
        get_sampler(run.sampler)   # registry error UX before any staging
        session = _session()
        draw = session.draw(strategy=run.sampler)
        mask = draw.entity_mask.cpu().numpy()
        kept_ids = np.nonzero(mask)[0]
        assoc, qids = associated_queries(
            corpus.qrels, mask, num_queries=corpus.num_queries,
            max_queries=spec.max_queries, seed=spec.seed)
        rho = float(query_density(
            session.qrels, draw.entity_mask,
            torch.as_tensor(assoc).to(dev), num_queries=corpus.num_queries,
            num_entities=corpus.num_entities))
        sampler_stats[run.sampler] = {"n_entities": int(kept_ids.size),
                                      "n_queries": int(qids.size),
                                      "rho_q": rho}
        log.log(logging.INFO if verbose else logging.DEBUG,
                "  sample[%s]: %d entities, %d queries, rho_q=%.3f",
                run.sampler, kept_ids.size, qids.size, rho)
        return {**ctx, "kept_ids": kept_ids, "qids": qids}

    def stage_index(ctx: dict, run: RunSpec) -> dict:
        cfg = dataclasses.replace(search, engine=run.engine,
                                  query_chunk=query_chunk)
        kept = torch.as_tensor(ctx["kept_ids"]).to(dev)
        session = SearchSession(ctx["ev"][kept], cfg,
                                key=prng.prng_key(spec.seed),
                                ids_map=ctx["kept_ids"], device=dev)
        return {**ctx, "session": session}

    def stage_search(ctx: dict, run: RunSpec) -> dict:
        qids = torch.as_tensor(ctx["qids"]).to(dev)
        global_ids = ctx["session"].search(ctx["qv"][qids], k=run.k)
        return {**ctx, "global_ids": global_ids}

    def stage_metric(ctx: dict, run: RunSpec) -> float:
        try:
            metric = METRICS[run.metric]
        except KeyError:
            raise ValueError(
                f"unknown metric {run.metric!r}; registered metrics: "
                f"{', '.join(sorted(METRICS))}") from None
        return float(metric(ctx["global_ids"], ctx["qids"], ctx, run.k))

    cells, trie = execute_plan(expand_grid(spec), {
        "corpus": stage_corpus, "embed": stage_embed,
        "sample": stage_sample, "index": stage_index,
        "search": stage_search, "metric": stage_metric,
    })
    return GridResult(spec, cells, sampler_stats, trie)
