"""WindTunnel sampling CLI on PyTorch — the paper's end-to-end pipeline
through the sampling-core front door (port of ``repro/launch/sample.py``).

  PYTHONPATH=src python -m repro_torch.launch.sample --queries 1280 \
      --target-frac 0.15 --out results/sample            # on the card
  PYTHONPATH=src python -m repro_torch.launch.sample --device cpu ...

  # size x seed sweep: graph build + label propagation run ONCE
  PYTHONPATH=src python -m repro_torch.launch.sample --sweep-sizes 0.05,0.1 \
      --sweep-seeds 0,1,2

Generates a corpus, stages GraphBuilder -> GraphSampler state in a
:class:`~repro_torch.core.sampling_core.SamplerSession`, draws the
sample(s), reports community statistics and the Yule-Simon fit, and writes
``sample.npz`` (entity mask, labels, qrel validity) and ``stats.json``.
The reference's ``--sharded`` / ``--streamed`` / ``--mesh`` wait for the
multi-device port (ROADMAP queue 1 item 12).
"""
from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np

from repro_torch.core import (SamplerSession, SamplerSpec, available_engines,
                              available_samplers, fit_em, get_sampler)
from repro_torch.core.engines import get_engine
from repro_torch.data.synthetic import generate_corpus
from repro_torch.device import resolve_device
from repro_torch.launch.logs import (add_logging_args, add_obs_args,
                                     init_obs, setup_logging, write_metrics)

log = logging.getLogger("repro_torch.launch.sample")


def _csv_floats(s):
    return tuple(float(x) for x in s.split(",") if x)


def _csv_ints(s):
    return tuple(int(x) for x in s.split(",") if x)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--queries", type=int, default=1280)
    p.add_argument("--qrels-per-query", type=int, default=32)
    p.add_argument("--topics", type=int, default=96)
    p.add_argument("--aux-fraction", type=float, default=2.0)
    p.add_argument("--strategy", default="windtunnel",
                   help="sampling strategy from the registry "
                        "(core/samplers.py): " + ",".join(available_samplers()))
    p.add_argument("--target-frac", type=float, default=0.15)
    p.add_argument("--tau-quantile", type=float, default=0.5)
    p.add_argument("--fanout", type=int, default=16)
    p.add_argument("--lp-rounds", type=int, default=5)
    p.add_argument("--engine", default=None,
                   help="label-prop engine from the registry "
                        "(core/engines.py): " + ",".join(available_engines())
                        + "; default cuda on a card, sort on the CPU")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda or cpu)")
    p.add_argument("--sweep-sizes", default=None, metavar="S1,S2,...",
                   help="comma list of target sizes (<=1: fraction of the "
                        "eligible universe; >1: entity count); runs "
                        "session.sweep against ONE staged graph+LP")
    p.add_argument("--sweep-seeds", default=None, metavar="R1,R2,...",
                   help="comma list of draw seeds for --sweep-sizes "
                        "(default: just --seed)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None)
    add_logging_args(p)
    add_obs_args(p)
    args = p.parse_args(argv)
    setup_logging(args)
    init_obs(args)
    device = resolve_device(args.device)
    # unknown names fail with the registry's error message before any
    # corpus work — the same error contract as launch/evaluate.py
    get_sampler(args.strategy)
    if args.engine is not None:
        get_engine(args.engine)

    corpus = generate_corpus(
        num_queries=args.queries, qrels_per_query=args.qrels_per_query,
        num_topics=args.topics, aux_fraction=args.aux_fraction,
        seed=args.seed)
    log.info("corpus: %d entities (%d judged), %d queries",
             corpus.num_entities, corpus.num_primary, corpus.num_queries)

    spec = SamplerSpec(
        strategy=args.strategy, engine=args.engine,
        tau_quantile=args.tau_quantile, fanout=args.fanout,
        lp_rounds=args.lp_rounds,
        target_size=args.target_frac * corpus.num_primary, seed=args.seed)
    session = SamplerSession(corpus.qrels, num_queries=corpus.num_queries,
                             num_entities=corpus.num_entities, spec=spec,
                             device=device)
    log.info("device %s, LP engine %s", device, session.spec.engine)

    stats = {}
    if args.sweep_sizes:
        sizes = _csv_floats(args.sweep_sizes)
        seeds = (_csv_ints(args.sweep_seeds) if args.sweep_seeds
                 else (args.seed,))
        sweep = session.sweep(sizes, seeds)
        log.info("sweep: %d sizes x %d seeds (strategy=%s)",
                 len(sizes), len(seeds), sweep.strategy)
        for (size, seed), draw in sorted(sweep.draws.items()):
            log.info("  size=%-10g seed=%-3d -> %d entities, %d queries",
                     size, seed, int(draw.entity_mask.sum()),
                     int(draw.reconstructed.num_queries))
        log.info("session stage counters (graph+LP staged once per sweep):")
        log.info("%s", session.summary())
        stats["sweep"] = sweep.to_json()
        first = sweep.draws[(sweep.sizes[0], sweep.seeds[0])]
        mask = first.entity_mask.cpu().numpy()
        recon_valid = first.reconstructed.qrels.valid.cpu().numpy()
        labels = (session.labels()[0].cpu().numpy()
                  if get_sampler(args.strategy).needs_labels
                  else np.zeros(corpus.num_entities, np.int32))
    else:
        draw = session.draw()
        mask = draw.entity_mask.cpu().numpy()
        recon_valid = draw.reconstructed.qrels.valid.cpu().numpy()
        strat = get_sampler(args.strategy)
        labels = np.zeros(corpus.num_entities, np.int32)
        if strat.needs_graph:
            edges, degrees = session.graph()
            fit = fit_em(degrees[degrees > 0], max_iters=300)
            log.info("affinity graph: %d edges; degree-law gamma = %.3f "
                     "(se %.2e)", int(edges.num_valid), float(fit.gamma),
                     float(fit.stderr))
            stats["gamma"] = float(fit.gamma)
            stats["edges"] = int(edges.num_valid)
        if strat.needs_labels:
            labels_t, changes = session.labels()
            labels = labels_t.cpu().numpy()
            n_comm = int((draw.sample.community_sizes > 0).sum())
            log.info("%d communities; LP changes/round = %s", n_comm,
                     changes.cpu().tolist())
            stats["communities"] = n_comm
            stats["changes_per_round"] = changes.cpu().tolist()
        log.info("sample[%s]: %d entities, %d associated queries",
                 args.strategy, int(mask.sum()),
                 int(draw.reconstructed.num_queries))

    stats["entities"] = int(mask.sum())
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        np.savez(os.path.join(args.out, "sample.npz"),
                 entity_mask=mask, labels=labels, qrel_valid=recon_valid)
        with open(os.path.join(args.out, "stats.json"), "w") as f:
            json.dump(stats, f, indent=2)
        log.info("wrote %s/sample.npz", args.out)
    metrics_path = write_metrics(
        args, {"session_stage_counts": {
            st: {"executions": ex, "requests": rq}
            for st, (ex, rq) in session.stage_counts().items()}})
    if metrics_path:
        log.info("wrote %s", metrics_path)
    return stats


if __name__ == "__main__":
    main()
