"""Serving-tier CLI on PyTorch (port of ``repro/launch/serve.py``) — drive
a :class:`~repro_torch.serve.engine.SearchServer` (bounded queue ->
microbatch scheduler -> per-tenant live indexes) as a load generator or
for a single query, on the card unless ``--device cpu``.

  # load-generate: 512 requests over 4 tenants, report throughput + p50/p99
  PYTHONPATH=src python -m repro_torch.launch.serve --requests 512 \
      --tenants 4 --rate 2000 --out results/serve.json

  # one query against a warm single-tenant server, on the CPU
  PYTHONPATH=src python -m repro_torch.launch.serve --single --k 5 \
      --device cpu

  # live ingest mid-run: append documents every N requests
  PYTHONPATH=src python -m repro_torch.launch.serve --append-every 128 \
      --append-rows 64 --compact-threshold 256

  # each tenant's corpus sharded from birth over a 1-rank mesh
  PYTHONPATH=src python -m repro_torch.launch.serve --streamed --mesh host

  # observe it: spans to a trace, metrics snapshot on exit
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --trace results/trace.jsonl --metrics-json results/metrics.json
  PYTHONPATH=src python -m repro_torch.launch.trace results/trace.jsonl \
      --filter serve.

Engine and backend names resolve through the same registries as every
other CLI, so an unknown name fails fast with the registry's message, and
a kernel backend on the CPU (``--backend cuda --device cpu``) raises. The
backend defaults to the device's (``cuda`` on a card, ``torch`` on the
CPU). After the load, every tenant's in-flight compaction is let land.
"""
from __future__ import annotations

import argparse
import collections
import json
import logging
import os
from typing import Optional

import numpy as np

from repro_torch.device import check_runs_on, default_backend, resolve_device
from repro_torch.kernels import build
from repro_torch.launch.logs import (add_logging_args, add_obs_args,
                                     init_obs, setup_logging, write_metrics)
from repro_torch.launch.mesh import is_main_rank, parse_mesh
from repro_torch.obs import recompile
from repro_torch.retrieval.backends import get_backend
from repro_torch.retrieval.engines import (available_retrieval_engines,
                                           get_retrieval_engine)
from repro_torch.retrieval.search_core import SearchConfig
from repro_torch.serve import (IngestConfig, LoadSpec, SchedulerConfig,
                               SearchServer, run_load)

log = logging.getLogger("repro_torch.launch.serve")


def _tenant_corpus(tenant: str, *, docs: int, dim: int, seed: int):
    """Deterministic per-tenant synthetic corpus — the provider the
    TenantCache rebuilds evicted tenants from (the reference's draw)."""
    tid = int(tenant.rsplit("-", 1)[-1]) if "-" in tenant else 0
    rng = np.random.default_rng(seed * 100_003 + tid)
    return rng.normal(size=(docs, dim)).astype(np.float32)


def build_server(args) -> SearchServer:
    device = resolve_device(args.device)
    mesh = (parse_mesh(args.mesh, device)
            if args.sharded or args.streamed else None)
    config = SearchConfig(
        engine=args.engine, backend=args.backend,
        sharded=args.sharded or args.streamed, streamed=args.streamed,
        mesh=mesh,
        engine_opts=json.loads(args.engine_opts) if args.engine_opts
        else None)
    return SearchServer(
        lambda t: _tenant_corpus(t, docs=args.docs, dim=args.dim,
                                 seed=args.seed),
        config=config,
        scheduler=SchedulerConfig(max_queue=args.max_queue,
                                  max_batch=args.max_batch,
                                  k_max=max(args.k_max, args.k)),
        ingest=IngestConfig(append_cap=args.append_cap,
                            compact_threshold=args.compact_threshold),
        max_tenants=args.max_tenants, device=device)


def _launched() -> dict:
    """Each kernel's launches so far by shape (its entry point's integer
    arguments, ``kernels/build.Kernel.shapes``)."""
    return {kern.name: collections.Counter(kern.shapes)
            for kern in build.kernels()}


def run_recompile_check(server, rng, *, dim: int, k: int,
                        n_ticks: int) -> dict:
    """The scheduler's steady-state contract, measured: let any compaction
    land, warm every batch bucket once, mark the waterline, then drive
    ``n_ticks`` more ticks across the bucket set. ``steady_recompiles``
    counts nvcc builds past the mark (the recompile sentinel), and
    ``steady_new_shapes`` the kernel launches past it at a shape no launch
    before it had — a shape that escaped the bucket/k_max pinning, which
    is what an XLA recompile is in the reference. ``warmup_shapes`` gives,
    for each kernel the warm-up launched, its distinct shapes there."""
    sched = server.scheduler
    buckets = sched.config.bucket_set()

    def _submit_fill(fill: int) -> None:
        for _ in range(fill):
            q = rng.normal(size=(dim,)).astype(np.float32)
            if server.submit(q, k=k, tenant="tenant-0") is None:
                raise RuntimeError("queue full during recompile check; "
                                   "raise --max-queue")

    server.flush()                       # a landing would change N
    before = _launched()
    for b in buckets:                    # warmup: one shape per bucket
        _submit_fill(b)
        sched.tick()
    recompile.mark()
    marked = _launched()
    warmup = {name: sum(n > before.get(name, {}).get(shape, 0)
                     for shape, n in c.items())
              for name, c in marked.items()}
    steady_ticks = 0
    for i in range(n_ticks):             # steady state: every shape warm
        _submit_fill(buckets[i % len(buckets)])
        if sched.tick():
            steady_ticks += 1
    new = sum(n for name, c in _launched().items()
              for shape, n in c.items() if shape not in marked.get(name, {}))
    return {"steady_ticks": steady_ticks,
            "steady_recompiles": recompile.since(),
            "steady_new_shapes": new,
            "warmup_shapes": {name: n for name, n in warmup.items() if n}}


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(
        description="load-generate against (or query) the serving tier")
    p.add_argument("--docs", type=int, default=4096,
                   help="synthetic corpus rows per tenant")
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--engine", default="exact",
                   help="retrieval engine (retrieval/engines.py): "
                        + ",".join(available_retrieval_engines()))
    p.add_argument("--backend", default=None,
                   help="scoring backend (retrieval/backends.py): torch, "
                        "cuda, int8; default cuda on a card, torch on the "
                        "CPU")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (cuda or cpu)")
    p.add_argument("--engine-opts", default=None, metavar="JSON",
                   help='engine overrides, e.g. \'{"n_lists": 16}\'')
    p.add_argument("--sharded", action="store_true",
                   help="mesh-partitioned search (retrieval/sharded.py)")
    p.add_argument("--streamed", action="store_true",
                   help="shard each tenant's corpus from birth "
                        "(implies --sharded)")
    p.add_argument("--mesh", default="host", choices=["host", "auto"],
                   help="mesh for --sharded/--streamed: the 1-rank host "
                        "mesh, or every rank torchrun started")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--single", action="store_true",
                   help="submit ONE query, print scores/ids (and write "
                        "them to --out), exit")
    p.add_argument("--requests", type=int, default=256,
                   help="load-generator arrivals")
    p.add_argument("--rate", type=float, default=float("inf"),
                   help="offered load, requests/s (default: back-to-back)")
    p.add_argument("--tenants", type=int, default=1,
                   help="tenant count, arrivals round-robin")
    p.add_argument("--max-tenants", type=int, default=8,
                   help="tenant-cache capacity (LRU evicts past this)")
    p.add_argument("--max-queue", type=int, default=256)
    p.add_argument("--max-batch", type=int, default=32)
    p.add_argument("--k-max", type=int, default=16,
                   help="fixed top-k width of every dispatched batch")
    p.add_argument("--append-every", type=int, default=0, metavar="N",
                   help="live-ingest --append-rows docs to tenant-0 every "
                        "N requests of the load (0: no ingest)")
    p.add_argument("--append-rows", type=int, default=64)
    p.add_argument("--append-cap", type=int, default=256)
    p.add_argument("--compact-threshold", type=int, default=4096)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--recompile-check", type=int, default=0, metavar="N",
                   help="after the load: warm every scheduler bucket, mark "
                        "the waterline, run N more ticks and exit 1 on any "
                        "nvcc build or any kernel launch at a shape the "
                        "warm-up did not launch. The check runs without "
                        "appends (--append-every drives the load only, "
                        "unlike the reference's): a compaction changes N, "
                        "a legitimate new shape")
    p.add_argument("--out", default=None, metavar="PATH",
                   help="write the load report JSON (with --single: the "
                        "ids and scores) to PATH")
    add_logging_args(p)
    add_obs_args(p)
    args = p.parse_args(argv)
    setup_logging(args)
    init_obs(args)
    if args.recompile_check > 0:
        recompile.enable()
    # fail fast with the registry error messages, before any build
    device = resolve_device(args.device)
    get_retrieval_engine(args.engine)
    backend = get_backend(args.backend or default_backend(device))
    check_runs_on("backend", backend.name, backend.needs_cuda, device)

    server = build_server(args)
    main_rank = is_main_rank()
    if not main_rank:           # rank 0 alone logs and writes results
        logging.getLogger("repro_torch").setLevel(logging.WARNING)
    rng = np.random.default_rng(args.seed + 1)

    def write(obj) -> None:
        if args.out and main_rank:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(obj, f, indent=2)
            log.info("wrote %s", args.out)

    if args.single:
        q = rng.normal(size=(args.dim,)).astype(np.float32)
        req = server.submit(q, k=args.k, tenant="tenant-0")
        if req is None:
            log.error("queue full")
            return 1
        server.drain()
        scores, ids = req.result(timeout=0)
        log.info("top-%d ids:    %s", args.k, ids.tolist())
        log.info("top-%d scores: %s",
                 args.k, [round(float(s), 4) for s in scores])
        write({"ids": ids.tolist(), "scores": scores.tolist()})
        if main_rank:
            write_metrics(args)
        return 0

    queries = rng.normal(size=(min(args.requests, 512),
                               args.dim)).astype(np.float32)
    spec = LoadSpec(n_requests=args.requests, rate=args.rate,
                    tenants=args.tenants, k=args.k, seed=args.seed)
    log.info("load: %d requests @ %s req/s over %d tenant(s), "
             "max_batch=%d engine=%s backend=%s device=%s", spec.n_requests,
             "inf" if not np.isfinite(spec.rate) else f"{spec.rate:g}",
             spec.tenants, args.max_batch, args.engine, backend.name, device)

    if args.append_every > 0:
        # interleave ingest with load: append via a wrapped scheduler tick
        done = {"n": 0}
        base_tick = server.scheduler.tick

        def tick_with_ingest():
            n = base_tick()
            done["n"] += n
            if n and done["n"] % max(args.append_every, 1) < n:
                server.append("tenant-0", rng.normal(
                    size=(args.append_rows, args.dim)).astype(np.float32))
            return n

        server.scheduler.tick = tick_with_ingest

    report = run_load(server.scheduler, queries, spec)
    vars(server.scheduler).pop("tick", None)     # the load's ingest ends
    server.flush()
    row = report.to_row()
    log.info("throughput %.1f req/s   p50 %.2f ms   p99 %.2f ms   "
             "(%d completed, %d rejected, mean batch %.1f)",
             report.throughput_rps, report.p50_s * 1e3, report.p99_s * 1e3,
             report.completed, report.rejected, report.mean_batch)
    steady = None
    if args.recompile_check > 0:
        steady = run_recompile_check(server, rng, dim=args.dim, k=args.k,
                                     n_ticks=args.recompile_check)
        row.update(steady)
        log.info("recompile check: %d steady ticks, %d nvcc builds and %d "
                 "launches at a new shape past the warmup mark (builds per "
                 "region: %s; warm-up shapes per kernel: %s)",
                 steady["steady_ticks"], steady["steady_recompiles"],
                 steady["steady_new_shapes"], recompile.counts(),
                 steady["warmup_shapes"])
    write(row)
    metrics_path = write_metrics(args) if main_rank else None
    if metrics_path:
        log.info("wrote %s", metrics_path)
    if steady is not None and (steady["steady_recompiles"]
                               or steady["steady_new_shapes"]):
        log.error("steady state built a kernel or launched one at a new "
                  "shape: the scheduler's bucket/k_max pinning leaked a "
                  "shape")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
