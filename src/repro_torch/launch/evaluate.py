"""Experiment-grid evaluation CLI on PyTorch (port of
``repro/launch/evaluate.py``) — runs a declarative (sampler × retrieval
engine × k × metric) grid over the synthetic corpus through the
trie-shared plan executor and prints the sample-fidelity report.

  PYTHONPATH=src python -m repro_torch.launch.evaluate --grid default
  PYTHONPATH=src python -m repro_torch.launch.evaluate --grid smoke
  PYTHONPATH=src python -m repro_torch.launch.evaluate --grid smoke \
      --device cpu --json results/eval.json

The default grid is the reference's ``GridSpec()``: 3 samplers x 4 engines
(exact, ivfflat, lsh, tfidf) x 2 ks x 4 metrics = 96 cells, the paper's own
comparison. ``--sharded``/``--streamed``/``--mesh`` wait for ROADMAP queue
1 item 12 and ``--no-tuned-kernels`` for the tuner (item 10).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os

from repro_torch.data.synthetic import generate_corpus
from repro_torch.device import resolve_device
from repro_torch.eval import (GridSpec, SearchConfig, available_backends,
                              available_retrieval_engines,
                              available_samplers, backend_recall_curve,
                              build_fidelity_report, format_backend_curve,
                              format_fidelity_report, get_backend,
                              get_retrieval_engine, get_sampler, run_grid,
                              tfidf_embedder)
from repro_torch.launch.logs import (add_logging_args, add_obs_args,
                                     init_obs, setup_logging, write_metrics)

log = logging.getLogger("repro_torch.launch.evaluate")

GRIDS = {
    # 3 samplers x 4 engines x 2 ks x 4 metrics = 96 cells
    "default": GridSpec(),
    # minimal end-to-end check: 3 samplers x 2 engines x 1 k x 2 metrics
    "smoke": GridSpec(engines=("exact", "tfidf"), ks=(3,),
                      metrics=("precision", "mrr"), max_queries=128),
}


def _csv(s):
    return tuple(x for x in s.split(",") if x)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--grid", default="default", choices=sorted(GRIDS),
                   help="grid preset; axis flags below override it")
    p.add_argument("--samplers", default=None,
                   help="comma list from " + ",".join(available_samplers()))
    p.add_argument("--engines", default=None,
                   help="comma list from "
                        + ",".join(available_retrieval_engines()))
    p.add_argument("--ks", default=None, help="comma list of cutoffs")
    p.add_argument("--metrics", default=None,
                   help="comma list of precision,recall,ndcg,mrr")
    p.add_argument("--backend", default=None,
                   help="scoring backend for the search core "
                        "(retrieval/backends.py): "
                        + ",".join(available_backends())
                        + "; default cuda on a card, torch on the CPU")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda or cpu)")
    p.add_argument("--no-backend-curve", action="store_true",
                   help="skip the backend recall-vs-speed curve appended to "
                        "the fidelity output")
    p.add_argument("--sample-frac", type=float, default=None)
    p.add_argument("--max-queries", type=int, default=None)
    p.add_argument("--queries", type=int, default=512,
                   help="synthetic corpus size (queries)")
    p.add_argument("--qrels-per-query", type=int, default=16)
    p.add_argument("--topics", type=int, default=48)
    p.add_argument("--aux-fraction", type=float, default=1.0)
    p.add_argument("--vocab", type=int, default=2048)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json", default=None, metavar="PATH",
                   help="persist grid cells + fidelity report as JSON")
    add_logging_args(p)
    add_obs_args(p)
    args = p.parse_args(argv)
    setup_logging(args)
    init_obs(args)
    device = resolve_device(args.device)

    spec = GRIDS[args.grid]
    overrides = {}
    if args.samplers:
        overrides["samplers"] = _csv(args.samplers)
    if args.engines:
        overrides["engines"] = _csv(args.engines)
    if args.ks:
        overrides["ks"] = tuple(int(k) for k in _csv(args.ks))
    if args.metrics:
        overrides["metrics"] = _csv(args.metrics)
    if args.sample_frac is not None:
        overrides["sample_frac"] = args.sample_frac
    if args.max_queries is not None:
        overrides["max_queries"] = args.max_queries
    overrides["seed"] = args.seed
    spec = dataclasses.replace(spec, **overrides)

    # unknown sampler/engine/backend names fail here with the registry's
    # error message, before any corpus work
    for name in spec.samplers:
        get_sampler(name)
    for name in spec.engines:
        get_retrieval_engine(name)
    if args.backend is not None:
        get_backend(args.backend)
    search = SearchConfig(backend=args.backend)

    corpus = generate_corpus(
        num_queries=args.queries, qrels_per_query=args.qrels_per_query,
        num_topics=args.topics, aux_fraction=args.aux_fraction,
        vocab_size=args.vocab, query_len=24, seed=args.seed)
    log.info("corpus: %d entities (%d judged), %d queries",
             corpus.num_entities, corpus.num_primary, corpus.num_queries)
    log.info("grid: %d samplers x %d engines x %d ks x %d metrics "
             "= %d cells (backend=%s, device=%s)",
             len(spec.samplers), len(spec.engines), len(spec.ks),
             len(spec.metrics), spec.num_cells, args.backend or "default",
             device)

    result = run_grid(corpus, spec, search=search, verbose=True,
                      device=device)

    log.info("\ncells (sampler, engine, k, metric -> value):")
    for (s, e, k, m), v in sorted(result.cells.items()):
        log.info("  %-11s %-8s k=%-3d %-10s %.4f", s, e, k, m, v)

    log.info("\nplan-trie stage counters (shared prefixes executed once):")
    log.info("%s", result.trie.summary())

    report = None
    if "full" in spec.samplers:
        report = build_fidelity_report(result.cells, spec)
        log.info("\n%s", format_fidelity_report(report, spec))
    else:
        log.info("\n(no 'full' sampler in the grid -> skipping the "
                 "fidelity report; add full to --samplers for deltas and "
                 "Kendall-tau)")

    curve = None
    if not args.no_backend_curve:
        # backend-level recall-vs-speed on the grid's own embedding
        ev, qv = tfidf_embedder(corpus)
        nq = min(128, qv.shape[0])
        curve = backend_recall_curve(ev, qv[:nq], k=10, device=device)
        log.info("\n%s", format_backend_curve(curve, k=10))

    out = {"grid": result.to_json()}
    if report is not None:
        out["fidelity"] = report.to_json()
    if curve is not None:
        out["backend_curve"] = curve
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
        log.info("\nwrote %s", args.json)
    metrics_path = write_metrics(
        args, {"plan": result.trie.metrics.snapshot()})
    if metrics_path:
        log.info("wrote %s", metrics_path)
    return out


if __name__ == "__main__":
    main()
