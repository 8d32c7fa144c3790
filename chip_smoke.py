#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

From the root of a checkout, with one card. In order:

1. Device: the card's name and power limit; no card is a failure.
2. Build: every CUDA source under src/repro_torch/csrc, one nvcc each,
   started together; prints each build's ``-Xptxas -v`` report. The
   recompile sentinel (``obs/recompile``) is on from here: it must count
   one build for each source whose library was not built yet, and none in
   phases 5-18.
3. Kernel vs plain: each kernel's wrapper (lp_round, the f32 top-k, the
   int8 top-k, the gathered top-k, the Hamming top-k, flash attention)
   against its plain PyTorch version on the card, at the main path's
   shapes and at odd ones (for the dense top-k kernels, Q, N, D and k on
   both sides of their tiles, MMA depth and list layouts, f32 rows whose
   magnitudes span 2**-20..2**20, and one operand's rows near 2**-120
   against the other's near 2**100; for lp_round, -1 padding scattered in
   any slot, K 0 and 70, and the sampling run's shape as a block of rows
   from half of N, ``row0``; for the Hamming top-k, W 1, 3, 8 and 12, k = N
   and k > N, all codes equal and few distinct codes, so the threshold
   distance is one large tie). The gathered kernel's main shape
   is the ivfflat
   probe of the evaluation path's full corpus (its tf-idf embedding, 5.2e5
   x 2048, indexed as the ivfflat engine does: 64 lists, nprobe 8) for 512
   queries, and Table I's probe: 128-wide unit-norm vectors of the same
   corpus and of a 4e4-row sample, indexed the same way, 256 queries (the
   search's chunk) at k = 3; its odd shapes include candidates cut into
   pieces of length 1, repeated rows, runs across row tiles and a tile
   probed by more queries than a block takes. Flash attention's are the
   encoder's passage and query batches (256 x 64 and 256 x 24 tokens, 4
   heads of 32), the reference's test grid, bf16, Skv on both sides of
   the short-row kernel's limit of 128 with GQA groups of 1, 2 and 8,
   every instance of that kernel (each head width, type, key bucket and
   row block) once, and the LM configs' head layout (S 2048, 32 heads
   over 4 kv heads of 128, causal and causal + window, bf16).
4. Times: each kernel, its plain version and, where one PyTorch call
   computes the same function, that call, with CUDA events after a
   warm-up, beside the least time the card could take (an f32 inner
   product counted as three TF32 products at the tensor cores' rate, the
   least an f32-accurate one takes there; a Hamming distance W popcounts
   at the rate ``tools/mma_rate.popc_rate`` measures in this run); the
   f32 top-k also at a grid search's shape (256 queries over the rows of
   the evaluation grid's uniform sample) and at the serving tick's (a full
   bucket of 32 queries over a 1,048,576 x 768 tenant at k 16, checked in
   phase 3 too), the gathered kernel also at
   Table I's probe, the Hamming kernel's three kernels and the flash
   kernel and ``scaled_dot_product_attention`` also by the profiler's
   device time a call; ``topk_merge`` alone on the f32 kernel's partial
   lists at k 10, held equal to its plain version (two stable sorts).
5. Sampling: ``repro_torch.launch.sample`` at 65536 queries with the LP
   kernel engine (about 2.1M qrel rows and 3.1M entities); then the degree
   histogram of the ELL table its LP rounds ran on, and lp_round timed on
   that table.
6. Evaluation: ``repro_torch.launch.evaluate --grid default --backend
   cuda`` at 32768 queries (about 5e5 entities x 2048 f32 of corpus): the
   paper's grid, 3 samplers x 4 engines (exact, ivfflat, lsh, tfidf) x 2
   ks x 4 metrics = 96 cells, with its default backend recall curve, whose
   int8 rows run the int8 kernel; then the Hamming top-k timed at each
   distinct shape the run launched it at (query chunks of 256 over the
   full corpus and over each sample).
7. Table I: ``repro_torch.retrieval.experiment.run_table1_experiment``
   on the evaluation phase's corpus (32768 queries, vocab 2048, passages
   of 64 tokens, queries of 24): the default encoder (d_model 128, 4
   layers, 4 heads) trained 300 steps at batch 64, the whole corpus and
   its queries embedded through the flash-attention kernel, a WindTunnel
   draw through the LP kernel and an ivfflat search of each sample through
   the gathered kernel; p@3 and rho_q of the full, uniform and WindTunnel
   rows. Then ``torch.profiler`` over 20 training steps and 20 embedding
   batches: the device's idle share in each, and the flash kernel's
   device time a launch at the main path's passage shape (a profiler
   window of its own, after the Table I run).
   Phases 5-7 print their trace as ``repro_torch.launch.trace`` tables it,
   the wall time outside every span, and the ``build.peak_bytes_per_device``
   gauge with the allocator's peak over the run.
8. Small-input check: the sampling and evaluation entry points on the
   card and on the CPU's plain path must give equal outputs; ``prng.normal``
   (the lsh projection's draw) equal bit for bit on both; for the default
   grid, the lsh projection equal and the ivfflat centroids within a
   stated rtol (cuBLAS and the CPU sum in other orders). The
   encoder: 5 training steps give losses within a stated rtol, the CPU's
   parameters embed within a stated tolerance on both, and
   ``evaluate_sample`` on the CPU's embeddings gives equal results. The
   serve CLI at its defaults (4096 x 64 a tenant): equal ``--single`` ids,
   and equal completed, rejected, ticks and mean batch over a load of 256.
9. Pipeline: ``core.run_windtunnel`` with a default ``WindTunnelConfig``
   on phase 5's corpus (its engine left to the card: the LP kernel, one
   launch a round), labels and entity mask equal bit for bit to a
   ``SamplerSession`` draw of the same spec; ``run_uniform_baseline``
   once, its mask equal to ``uniform_sample``'s.
10. Autotuner: ``kernels/tuning.autotune`` on the card for ``topk``
    (float32, int8) and ``hamming_topk`` over the le65536 and gt65536
    buckets, each bucket measured at the calls phases 5-7 launched in it
    (a cell they never launched gets no entry), its table written under
    build/chip_smoke and printed; every
    split-target candidate against the default at the main path's shapes
    (f32 Q 128 x N 524288 x D 2048 k 3, int8 the same at k 40, Hamming Q
    512 x N 524288 x W 4 k 64): ids and scores equal, each one's CUDA-event
    time; then the default grid at 8192 queries (full-corpus searches of
    1.3e5 rows: a tuned bucket) with the table active and under
    ``--no-tuned-kernels``: equal cells, fidelity report and curve recall.
11. Host time: the sampling and evaluation CLIs once more at phases 5 and
    6's sizes under cProfile, the 15 functions with the largest cumulative
    and the largest own time in each (profiles kept in build/chip_smoke).
12. Sharded sampling at full width: ``repro_torch.launch.sample --streamed
    --mesh host`` on phase 5's arguments, a 1-rank NCCL group on the card
    (the QRel table sharded from birth, the LP kernel on the rank's rows);
    ``sample.npz`` equal bit for bit to phase 5's. Then a legacy
    ``--sharded`` ``SamplerSession`` in-process on phase 5's corpus, its
    labels and changes equal to phase 5's. 5 ``lp_round`` launches each;
    the wall and the ``build.peak_bytes_per_device`` gauge, which the
    sharded stage records.
13. Sharded evaluation at full width: ``repro_torch.launch.evaluate --grid
    default --backend cuda --streamed --mesh host`` at 32768 queries (every
    index built per shard from a streamed corpus, every search merged
    across shards); cells and fidelity report equal to phase 6's; the
    kernels' launches by shape, device ms and the gauge.
14. Two ranks on the card: two processes in one gloo group made through
    the API, each on the one H100, at 8192 queries. A stand-in for two
    cards: NCCL refuses two ranks on one device, and this machine has one
    card; gloo carries the card's tensors through host copies. A streamed
    ``SamplerSession`` (``lp_round`` on each rank's rows, ``row0`` not 0
    on rank 1), then a streamed ``SearchSession`` for each engine on the
    ``cuda`` backend and the born ``int8`` plan, with N odd so every pad
    path runs. Rank 0 holds them to a 1-rank run on the card: labels,
    changes and mask equal; exact, tfidf and lsh top-k set-equal; ivfflat
    recall against exact within ``SHARDED_RECALL_TOL`` of the 1-rank
    index's (distributed Lloyd sums in another order); int8 recall logged.
15. Serving tier at full width: ``repro_torch.launch.serve``'s ``main`` in
    process, tenants of 1,048,576 x 768 f32 (each drawn once on the host
    and shared by the runs), buckets up to 32, k_max 16. 15a: 2 tenants,
    4096 requests at rate inf, 256 rows appended to tenant-0 every 512
    requests, compaction at 1024 pending (in the background): every
    request completed or rejected, a compaction landed; then a background
    compaction of tenant-0's pending rows whose worker is joined with no
    further call of the index: ``frozen_n``, ``pending_rows``, the pending
    gauge and the compactions counter read the state after it; then 64
    fixed queries on tenant-0 (256 rows more pending, no compaction in flight:
    one state on both sides) through the scheduler equal
    to ``LiveIndex.search_scored`` on the same batches, and held to an
    exact plain f32 search over its frozen + pending rows (phase 3's bound,
    ids equal away from near-ties). 15b: ``--single --k 5``, held the same
    way. 15c: ``--recompile-check 64`` with no appends: no build, no launch
    at a shape the warm-up did not launch, one ``topk_partial`` shape a
    bucket in the warm-up. 15d: one tenant, 1024 requests with appends, on
    ``--backend int8``, ``--engine ivfflat`` and ``--engine lsh`` (rerank
    64): each launches its kernel, which is held to its plain version on
    the run's own inputs at every shape the run called its wrapper at; the
    64 queries (256 rows more pending) through the scheduler equal
    ``LiveIndex.search_scored``, and equal (int8, Hamming) or agree within
    phase 3's bound away from near-ties (gathered) with the same
    ``LiveIndex`` search through the plain versions. 15e: 15a's arguments
    at 1024 requests with compaction at 256 pending, unsharded and
    ``--streamed --mesh host`` (a 1-rank NCCL group): each run compacts in
    the background, every landing on the ``live-index-compact`` worker
    (its ``serve.ingest.land`` spans), build and landing seconds logged;
    after the leftover pending rows are folded and 128 rows appended on
    both, the 64 queries give equal results bit for bit; the process
    groups are counted before and after the streamed run and after every
    tenant's eviction and tenant-0's rebuild, which must make no group.
    Each run logs its ``--out`` row (throughput, p50, p99), trace table,
    launches by shape, device ms and allocator peak.
16. Analyzer: ``python -m repro_torch.launch.lint --json src/repro_torch``
    on this machine's Python against ``lint_baseline_torch.json``: any
    finding the baseline does not hold fails the run; counts by severity
    and seconds logged.
17. The LM decoder and RAG serving. 17a: the reduced configs of the five
    LM archs (f32, TF32 off) on the card against the CPU's plain path from
    the same seed: ``init_transformer`` bit for bit; ``prefill``'s logits
    and caches (mixtral's window and llama4's chunk roll a 24-token
    prompt), ``lm_loss`` at vocab_chunks 1 and 4 within ``LM_F32_TOL``; a
    ``ServeEngine`` drain of 4 requests over 3 slots (one reused) the
    same greedy tokens. 17b: gemma-2b at its published config (bf16,
    remat "full"), its f32 tree drawn on the card from a seed: as many
    elements as ``count_params`` (2,506,172,416); ``prefill`` of 8 x 512
    tokens against 512 ``decode_step``s of the same tokens, last-token
    logits and caches within ``LM_BF16_TOL``, argmax equal wherever the
    top-two gap exceeds it; decode step times. 17c: the RAG stack of
    ``examples/serve_rag.py`` at full width: a WindTunnel sample (the LP
    kernel) of a synthetic corpus of 8192 queries, tf-idf vectors, a
    ``RetrievalFrontend`` on ivfflat (the gathered top-k and merge
    kernels) and a ``RagEngine`` over a gemma-2b ``ServeEngine`` (8 slots,
    512 positions, 32 new tokens, 24 context tokens); 64 queries, the
    engine stepped whenever its batch is full, then drained: every
    request 32 tokens, the retrieved ids equal to ``session.search``
    called directly, and 16 requests re-run alone with ``decode_step``
    fed the engine's tokens, each engine token's logit within
    ``LM_BF16_TOL`` of its step's largest. Logged: steps, tokens/s,
    ``serve.step`` p50/p99, request latency p50/p99, the allocator peak,
    the kernels' device ms, and a step's bytes bound (the layer and tied
    head parameters in bf16 over the rate a 2 GiB copy shows).
18. LM training (no kernel lies on it: the reference trains with the plain
    attention, and every launch count must stay 0). 18a: the reduced
    configs of the five LM archs (f32, TF32 off): 3 steps of
    ``launch/cells.build_lm_cell``'s train step from ``launch/train``'s
    initial draw on the card against the CPU's plain path, losses within
    ``LM_F32_TOL`` and parameters and moments within 2 lr(step) a step; the
    donated update (``adamw_update_``) bit-equal to ``adamw_update`` on the
    card with no leaf moved; ``launch/train`` for 12 steps, then resumed
    to 20, bit-equal to 20 uninterrupted (losses and step-20 checkpoint).
    18b: gemma-2b at its published config (bf16 compute, f32 parameters,
    remat "full") drawn on the card, ``build_lm_cell("gemma-2b",
    "train_4k", ...)``'s step on ``TRAIN_BATCH`` x 4097 tokens (the global
    batch cut from 256 for memory, the reckoning logged): ``train_loop``
    for 2 steps, then an ``AsyncCheckpointer`` save of the 30.1 GB state
    at step 2, written while step 3 runs (one full-width save: the card's
    machine caps what a run writes to its disk at 45 GiB, and
    ``train_loop``'s final save would be a second); every loss finite,
    every leaf's pointer kept through each step, the allocator peak under
    the reckoning plus 10 %; the step-2 checkpoint restored into a fresh
    tree equal to the saved state (two 64-bit checksums a leaf), and step
    3 from it the run's loss and final state bit for bit. Logged: step
    times (CUDA events) against the flop bound, a profiled step's busy
    share and launches, the save's bytes and seconds with the disk's free
    space before it, the restore's seconds, the allocator peak.

19. The recsys rankers and MACE (the dense top-k kernel and its merge on
    the retrieval cell's path; no kernel lies on the train and serve
    steps, whose launch counts must stay 0). 19a: the reduced configs of
    DCN-v2, AutoInt, DIEN and DLRM (train_batch, serve_p99,
    retrieval_cand) and MACE (molecule, full_graph_sm, minibatch_lg) on
    the card against the CPU's plain path from ``launch/train``'s draws:
    3 train steps' losses within ``SMALL_TOL``, parameters and moments
    within 2 lr(step) a step; serve outputs within ``SMALL_TOL``;
    retrieval ids equal and scores within phase 3's bound;
    ``launch/train --arch dcn-v2`` and ``--arch mace`` resumed at 12
    bit-equal to 20 uninterrupted. 19b: DCN-v2 at its published config
    (26 Criteo Kaggle tables, 2.16 GB, drawn on the card): train_batch
    (65,536 rows) step times by CUDA events over ``RECSYS_STEPS`` steps,
    the allocator peak and a profiled step; serve_p99 and serve_bulk
    forward times; retrieval_cand (1 x 1,000,000 candidates of its largest
    table, k 100) through the kernels, ids equal to the plain path's on
    the card away from near-ties, timed against matmul + stable sort;
    then one AutoInt and one DIEN train_batch step at their published
    configs. 19c: MACE at its published config: molecule (128 graphs)
    energies and forces card vs CPU within ``MACE_TOL``, second-order
    train step times and peak; minibatch_lg: a ``NeighborSampler`` over a
    Reddit-sized graph drawn from a seed (232,965 nodes, 114,615,892
    edges; host times for the draw, the CSR build and the sample), 1024
    nodes at fanouts (15, 10) laid into the cell's padded 180,224-node,
    179,200-edge block, and its train step's times, peak and rate against
    ``mace_flops``. dlrm-mlperf's published tables (91.1 GB) and MACE's
    ogb_products (285 GB a message set) do not fit one card and wait for
    ROADMAP.md item 15(d).

Launch counts are set to 0 just before each main-path run (5, 6, 7, 9, 12,
13, 15's, 17c, 18, 19b's retrieval and its train and serve steps) and
read just after; a kernel the run did not launch is a failure (in 18 and
19b's train and serve steps, a kernel it did launch). No tuned
table is active outside phase 10, whatever ``REPRO_TORCH_TUNED_KERNELS``
names: a launch that resolves through one is a failure, so every other
phase runs today's split plans. Each run
also logs its launches by shape (the entry point's integer arguments) and
each kernel's device time summed over the run (CUDA events recorded
around every launch, ``Kernel.timed``). No phase
catches its own failure: any error exits nonzero. The last three lines of
stdout are the kernel table (JSON), the nvidia-smi line and the result
(JSON).
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
OUT = os.path.join(ROOT, "build", "chip_smoke")

SAMPLE_QUERIES = 65536
EVAL_QUERIES = 32768
PROBE_QUERIES = 512             # the grid's per-sample query cap
INDEX_RTOL = 1e-5               # centroids / projection, card vs CPU
ATTN_F32_TOL = (1e-5, 2e-5)     # rtol, atol: the reference's kernel tolerance
ATTN_BF16_TOL = 2e-2            # the reference's bf16 tolerance
ENCODER_BATCH = 256             # embed_corpus's batch of passages
ENCODER_LAYERS = 4              # EncoderConfig's default depth
ENCODER_DIM = 128               # EncoderConfig's default d_model
SAMPLE_ROWS = 40_000            # about a Table I sample's entities
EMBED_TOL = (1e-4, 2e-5)        # rtol, atol: unit-norm embeddings, card vs CPU
LOSS_RTOL = 1e-4                # 5 training steps, card vs CPU
TUNED_GRID_QUERIES = 8192       # the tuned-table grid: full-corpus searches
                                # of about 1.3e5 rows, a tuned bucket
TWO_RANK_QUERIES = 8192         # phase 14's corpora
TWO_RANK_TIMEOUT = 600          # s, phase 14's two processes together
SHARDED_RECALL_TOL = 0.01       # ivfflat recall@10 vs exact: 2 ranks vs 1
PROFILE_TOP = 15                # functions listed per cProfile ordering
SERVE_DOCS = 1_048_576          # a tenant's rows (MS MARCO's 8.8M passages,
                                # cut for the host's corpus draw)
SERVE_DIM = 768                 # BERT-base dense retrievers' width
SERVE_BATCH = 32                # the serve CLI's --max-batch: its top bucket
SERVE_KMAX = 16                 # --k-max: every tick's k
SERVE_K = 10                    # --k: what each request asks for
SERVE_REQUESTS = 4096           # phase 15a's load
SERVE_SIDE_REQUESTS = 1024      # phases 15d and 15e
SERVE_E_THRESHOLD = 256         # 15e's compaction threshold: its appends
                                # of 256 rows each reach it
SERVE_QUERIES = 64              # the fixed queries held to the direct and
                                # the plain search
LM_F32_TOL = (1e-4, 1e-5)       # rtol, atol: reduced LMs in f32, card vs
                                # CPU (other summation orders, TF32 off)
LM_BF16_TOL = 0.25              # |logit| and |k|, |v| of gemma-2b in bf16:
                                # prefill vs decode, values of order 1 (2**-8
                                # relative a rounding, 18 layers deep)
GEMMA_BATCH, GEMMA_SEQ = 8, 512  # 17b's prompts
RAG_CORPUS_QUERIES = 8192       # 17c's synthetic corpus
RAG_REQUESTS = 64               # RAG queries served in 17c
RAG_NEW_TOKENS = 32             # tokens each request generates
RAG_CTX_TOKENS = 24             # passage tokens prepended to a prompt
RAG_FORCED = 16                 # requests re-run alone, teacher-forced
TRAIN_BATCH = 2                 # 18b's sequences a step: train_4k's 256 cut
                                # for one card's memory (logits of 256000)
SMALL_TOL = (1e-4, 1e-5)        # rtol, atol: 19a's reduced recsys and MACE
                                # cells in f32, card vs CPU
RECSYS_STEPS = 6                # 19b's timed dcn-v2 train steps
MACE_TOL = 1e-4                 # 19c: molecule energies and forces, card vs
                                # CPU, relative to their largest magnitude


# phase 14's child: one rank of two in a gloo group on the one card;
# argv: rank, FileStore path, queries, ivfflat recall tolerance. It prints
# "    rank r: ..." lines, then one JSON report as its last line; rank 0
# holds the sharded results to a 1-rank run and raises on a difference.
TWO_RANK_CHILD = r"""
import dataclasses, json, sys, time
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

rank, store, nq, tol = (int(sys.argv[1]), sys.argv[2], int(sys.argv[3]),
                        float(sys.argv[4]))
dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank,
                        world_size=2)
mesh = DeviceMesh("cpu", torch.arange(2).reshape(2, 1),
                  mesh_dim_names=("data", "model"))
from repro_torch.core import SamplerSession, SamplerSpec
from repro_torch.data.synthetic import generate_corpus
from repro_torch.eval import tfidf_embedder
from repro_torch.kernels.label_prop.ops import LP_ROUND
from repro_torch.kernels.lsh_hamming.ops import HAMMING_TOPK
from repro_torch.kernels.topk_scoring.ops import (
    GATHERED_TILES, TOPK_INT8_PARTIAL, TOPK_MERGE, TOPK_PARTIAL)
from repro_torch.obs import recompile
from repro_torch.retrieval.search_core import SearchConfig, SearchSession

torch.backends.cuda.matmul.allow_tf32 = False
recompile.enable()
recompile.reset()
KERNELS = (LP_ROUND, TOPK_PARTIAL, TOPK_INT8_PARTIAL, GATHERED_TILES,
           HAMMING_TOPK, TOPK_MERGE)
ENGINES = ("exact", "tfidf", "lsh", "ivfflat")
K = 10


def reset():
    for kern in KERNELS:
        kern.launches = 0
        kern.shapes.clear()


def counts():
    return {kern.name: {"launches": kern.launches,
                        "shapes": sorted(list(s) for s in kern.shapes)}
            for kern in KERNELS}


def log(msg):
    print(f"    rank {rank}: {msg}", flush=True)


def check(ok, msg):
    if not ok:
        raise AssertionError(msg)


report = {"rank": rank}
corpus = generate_corpus(num_queries=nq, qrels_per_query=32, num_topics=96,
                         aux_fraction=2.0, seed=0)
kw = dict(num_queries=corpus.num_queries, num_entities=corpus.num_entities,
          device="cuda")
spec = SamplerSpec(engine="cuda", target_size=0.15 * corpus.num_primary)
reset()
t0 = time.perf_counter()
born = SamplerSession(corpus.qrels, spec=dataclasses.replace(
    spec, streamed=True, mesh=mesh), **kw)
labels, changes = born.labels()
mask = born.draw().entity_mask
degrees = born.graph()[1]
torch.cuda.synchronize()
report["sampling"] = counts()
report["changes"] = changes.tolist()
log(f"streamed SamplerSession, {corpus.num_entities} entities: "
    f"{time.perf_counter() - t0:.2f} s; lp_round {LP_ROUND.launches} "
    f"launches at (rows, K, row0) {sorted(LP_ROUND.shapes)}; changes "
    f"{changes.tolist()}")
if rank == 0:
    single = SamplerSession(corpus.qrels, spec=spec, **kw)
    check(torch.equal(single.labels()[0], labels), "labels != 1 rank")
    check(torch.equal(single.labels()[1], changes), "changes != 1 rank")
    check(torch.equal(single.graph()[1], degrees), "degrees != 1 rank")
    check(torch.equal(single.draw().entity_mask, mask), "mask != 1 rank")
    log("labels, changes, degrees and mask equal to a 1-rank run")
    del single
del born

ecorpus = generate_corpus(num_queries=nq, qrels_per_query=16, num_topics=48,
                          aux_fraction=1.0, vocab_size=2048, query_len=24,
                          seed=0)
ev, qv = tfidf_embedder(ecorpus)
n = ev.shape[0] - (1 - ev.shape[0] % 2)       # odd: every pad path runs
ev, q = ev[:n], qv[:256]
reset()
t0 = time.perf_counter()
got = {}
for engine, backend in [(e, "cuda") for e in ENGINES] + [("exact", "int8")]:
    s = SearchSession(ev, SearchConfig(engine=engine, backend=backend,
                                       streamed=True, mesh=mesh),
                      device="cuda")
    got[(engine, backend)] = s.search(q, k=K)
    del s
torch.cuda.synchronize()
report["search"] = counts()
log(f"streamed SearchSession x5 (exact, tfidf, lsh, ivfflat on cuda; "
    f"exact on int8) over N={n} x {ev.shape[1]}, {q.shape[0]} queries, "
    f"k {K}: {time.perf_counter() - t0:.2f} s; launches "
    + ", ".join(f"{k} {v['launches']}" for k, v in report["search"].items()))
if rank == 0:
    want = {key: SearchSession(ev, SearchConfig(engine=key[0],
                                                backend=key[1]),
                               device="cuda").search(q, k=K)
            for key in got}
    for engine in ("exact", "tfidf", "lsh"):
        check(np.array_equal(np.sort(got[(engine, "cuda")], 1),
                             np.sort(want[(engine, "cuda")], 1)),
              f"{engine} top-k not set-equal to 1 rank")
    exact = want[("exact", "cuda")]

    def recall(ids):
        return float(np.mean([len(set(a) & set(b)) / K
                              for a, b in zip(ids, exact)]))

    r2, r1 = recall(got[("ivfflat", "cuda")]), recall(want[("ivfflat",
                                                            "cuda")])
    check(abs(r2 - r1) <= tol, f"ivfflat recall {r2} vs 1 rank {r1}")
    i2, i1 = recall(got[("exact", "int8")]), recall(want[("exact", "int8")])
    report["recall"] = {"ivfflat": [r2, r1], "int8": [i2, i1]}
    log(f"exact, tfidf, lsh top-k set-equal to 1 rank; recall@{K} vs exact: "
        f"ivfflat {r2:.4f} (1 rank {r1:.4f}, tolerance {tol}), int8 "
        f"{i2:.4f} (1 rank {i1:.4f})")
report["builds"] = recompile.total()
dist.destroy_process_group()
print(json.dumps(report), flush=True)
"""


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound(n_bytes: float, n_ops: float, peak_ops: float = None):
    """The least time (ms) the card could take, and what sets it: the
    larger of ``kernels/tuning.roofline``'s two terms at the H100's
    data-sheet peaks (f32 outside the tensor cores unless ``peak_ops``)."""
    from repro_torch.kernels import tuning
    t = tuning.roofline(n_bytes, n_ops, peak_ops or tuning.H100_F32_FLOPS)
    t_bytes, t_ops = t["memory_ms"], t["compute_ms"]
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def lp_bytes(nbr) -> int:
    """Bytes one lp_round must move on this input: every neighbour id, the
    32-byte sectors of weights that valid slots touch (the kernel loads no
    weight of a padding slot), and the labels in and out."""
    import torch
    n, k = nbr.shape
    flat = torch.nonzero((nbr >= 0).flatten()).flatten()
    sectors = torch.unique_consecutive(flat * 4 // 32).numel()
    return n * k * 4 + sectors * 32 + 2 * n * 4


# --------------------------------------------------------------------------
# inputs
# --------------------------------------------------------------------------

def lp_inputs(n: int, k: int, *, seed: int, quarter: bool, device):
    """ELL adjacency with a heavy-tailed degree law, isolated nodes and -1
    padding; weights exactly representable (multiples of 0.25) or random."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    u = torch.rand(n, generator=g)
    deg = torch.clamp((1.0 / (u + 1e-3)).floor().to(torch.int64) - 1, 0, k)
    nbr = torch.randint(0, n, (n, k), generator=g, dtype=torch.int32)
    nbr[torch.arange(k)[None, :] >= deg[:, None]] = -1
    if quarter:
        wgt = torch.randint(1, 8, (n, k), generator=g).float() * 0.25
    else:
        wgt = torch.rand(n, k, generator=g)
    wgt[nbr < 0] = 0.0
    labels = torch.randint(0, max(n // 5, 1), (n,), generator=g,
                           dtype=torch.int32)
    return (labels.to(device), nbr.to(device), wgt.to(device),
            int((deg ** 2).sum()))


def topk_inputs(q: int, n: int, d: int, *, seed: int, negative: bool,
                device, wide: bool = False, tiny: str = ""):
    """Normal vectors; ``negative``: every score negative; ``wide``: each
    row scaled by a power of two from 2**-20 to 2**20; ``tiny``
    ("queries" or "corpus"): that operand's rows scaled to near 2**-120
    (2**-123..2**-117), the other's by 2**100, so products are normal
    f32 near 2**-20."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    qs = torch.randn(q, d, generator=g)
    cs = torch.randn(n, d, generator=g)
    if negative:                    # every score negative
        qs, cs = qs.abs(), -cs.abs()
    if wide:
        for x in (qs, cs):
            x *= 2.0 ** torch.randint(-20, 21, (x.shape[0], 1), generator=g)
    if tiny:
        small, big = (qs, cs) if tiny == "queries" else (cs, qs)
        small *= 2.0 ** (torch.randint(-3, 4, (small.shape[0], 1),
                                       generator=g) - 120.0)
        big *= 2.0 ** 100
    return qs.to(device), cs.to(device)


# --------------------------------------------------------------------------
# phase 3: kernel vs plain
# --------------------------------------------------------------------------

def scatter_slots(nbr, wgt, seed: int):
    """The same ELL rows with each row's slots in a random order, so -1
    padding lies anywhere, not packed last as ``edges_to_ell`` packs it."""
    import torch
    n, k = nbr.shape
    g = torch.Generator(device="cpu").manual_seed(seed)
    perm = torch.argsort(torch.rand(n, k, generator=g), dim=1).to(nbr.device)
    return (torch.gather(nbr, 1, perm).contiguous(),
            torch.gather(wgt, 1, perm).contiguous())


def check_lp(labels, nbr, wgt, row0: int = 0) -> None:
    import torch
    from repro_torch.core.label_prop import ell_round
    from repro_torch.kernels.label_prop.ops import lp_round_cuda
    got = lp_round_cuda(labels, nbr, wgt, row0)
    torch.cuda.synchronize()
    want = ell_round(labels, nbr, wgt, row0)
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        fail(f"lp_round kernel != plain ell_round on {bad} of "
             f"{nbr.shape[0]} nodes (N={nbr.shape[0]}, K={nbr.shape[1]}, "
             f"row0={row0})")


def int8_inputs(q: int, n: int, d: int, *, seed: int, negative: bool,
                device):
    """Random int8 codes in [-127, 127], half the corpus rows duplicating
    the other half (exact ties)."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    qc = torch.randint(-127, 128, (q, d), generator=g, dtype=torch.int8)
    cc = torch.randint(-127, 128, (n, d), generator=g, dtype=torch.int8)
    if negative:                    # every score negative
        qc, cc = qc.abs(), -cc.abs()
    cc[n // 2:] = cc[:n - n // 2].clone()
    return qc.to(device), cc.to(device)


def check_topk_int8(qc, cc, k: int) -> None:
    """Kernel vs plain int8 top-k: both rank exact integer dots as f32, so
    scores and ids must be equal, ties included."""
    import torch
    from repro_torch.kernels.topk_scoring.ops import topk_scores_int8
    from repro_torch.kernels.topk_scoring.ref import topk_scores_int8_ref
    s, i = topk_scores_int8(qc, cc, k=k)
    torch.cuda.synchronize()
    n = cc.shape[0]
    k_eff = min(k, n)
    s_ref, i_ref = topk_scores_int8_ref(qc, cc, k=k_eff)
    shape = f"Q={qc.shape[0]} N={n} D={cc.shape[1]} k={k}"
    if s.shape != (qc.shape[0], k) or i.shape != (qc.shape[0], k):
        fail(f"int8 topk shape {tuple(s.shape)} for {shape}")
    if not (torch.equal(s[:, :k_eff], s_ref)
            and torch.equal(i[:, :k_eff], i_ref)):
        fail(f"int8 topk kernel != plain for {shape}")
    if not (bool((i[:, k_eff:] == -1).all())
            and bool(torch.isneginf(s[:, k_eff:]).all())):
        fail(f"int8 topk misses are not -inf/-1 for {shape}")


def check_topk(qs, cs, k: int):
    """Kernel vs plain top-k. Scores must agree within the f32 summation
    bound D * 2**-24 * sum_d |q_d c_d| (the two sum in different orders);
    ids must be equal except where the kernel picked a different id whose
    exact score lies within that tolerance of the plain one (a near-tie).
    Returns the largest score error and its largest ratio to the bound."""
    import torch
    from repro_torch.kernels.topk_scoring.ops import topk_scores
    from repro_torch.kernels.topk_scoring.ref import topk_scores_ref
    s, i = topk_scores(qs, cs, k=k)
    torch.cuda.synchronize()
    n, d = cs.shape
    k_eff = min(k, n)
    s_ref, i_ref = topk_scores_ref(qs, cs, k=k_eff)
    shape = f"Q={qs.shape[0]} N={n} D={d} k={k}"
    if s.shape != (qs.shape[0], k) or i.shape != (qs.shape[0], k):
        fail(f"topk shape {tuple(s.shape)} for {shape}")
    if k > k_eff and not (bool((i[:, k_eff:] == -1).all())
                          and bool(torch.isneginf(s[:, k_eff:]).all())):
        fail(f"topk misses are not -inf/-1 for {shape}")
    return compare_topk(qs, cs, s[:, :k_eff], i[:, :k_eff], s_ref, i_ref,
                        shape)


def compare_topk(qs, cs, s, i, s_ref, i_ref, shape: str):
    """Hold top-k (scores, ids) to a plain f32 search's: scores within the
    summation bound D * 2**-24 * sum_d |q_d c_d|, ids equal except where
    an id differs at a near-tie (its exact score within twice that bound
    of the plain one's). Returns the largest score error and its largest
    ratio to the bound."""
    import torch
    d = cs.shape[1]
    mag = torch.einsum("qd,qkd->qk", qs.abs().double(),
                       cs[i_ref.long()].abs().double())
    tol = d * 2.0 ** -24 * mag + 1e-30
    err = (s.double() - s_ref.double()).abs()
    if bool((err > tol).any()):
        fail(f"topk scores differ beyond the summation bound for {shape}: "
             f"max err {float(err.max()):.3e}")
    diff = i != i_ref
    if bool(diff.any()):
        exact_k = torch.einsum("qd,qkd->qk", qs.double(),
                               cs[i.long().clamp(min=0)].double())
        exact_p = torch.einsum("qd,qkd->qk", qs.double(),
                               cs[i_ref.long()].double())
        gap = (exact_k - exact_p).abs()
        if bool((gap[diff] > 2 * tol[diff]).any()):
            fail(f"topk ids differ away from a near-tie for {shape}")
        log(f"    {int(diff.sum())} id(s) differ at near-ties ({shape})")
    if not err.numel():
        return 0.0, 0.0
    return float(err.max()), float((err / tol).max())


def merge_plain(part_s, part_i, k: int):
    """The merge's plain version: a stable sort by id, then a stable sort
    by score descending, the first k."""
    import torch
    by_id = torch.sort(part_i, dim=1, stable=True).indices
    s, i = torch.gather(part_s, 1, by_id), torch.gather(part_i, 1, by_id)
    pos = torch.sort(s, dim=1, descending=True, stable=True).indices[:, :k]
    return torch.gather(s, 1, pos), torch.gather(i, 1, pos)


def gathered_inputs(q: int, c: int, d: int, r: int, *, seed: int,
                    device):
    """Candidates drawn from an (r, d) table with repeats (exact ties
    between positions), a fifth of the slots invalid and query 0 with no
    valid slot. Ids are the rows, so a returned id names its vector."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    table = torch.randn(r, d, generator=g)
    qs = torch.randn(q, d, generator=g)
    rows = torch.randint(0, r, (q, c), generator=g, dtype=torch.int32)
    ids = rows.clone()
    ids[torch.rand(q, c, generator=g) < 0.2] = -1
    ids[0] = -1
    return (qs.to(device), table.to(device), rows.to(device),
            ids.to(device))


def piece_inputs(kind: str, d: int, *, seed: int, device):
    """Candidates shaped to exercise the gathered kernel's pieces (runs of
    consecutive rows inside one tile of ``TILE_ROWS``): every piece of
    length 1, a row repeated within a query, runs across tile boundaries,
    and one tile probed by more queries than a block takes. Query 0 has no
    valid slot and query 1 two; ids are the rows."""
    import torch
    from repro_torch.kernels.topk_scoring.ops import TILE_PIECES, TILE_ROWS
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, c, r = 2 * TILE_PIECES + 8, 400, 3000
    if kind == "no_runs":
        rows = 2 * torch.randint(0, r // 2, (q, c), generator=g)
    elif kind == "repeats":
        rows = torch.randint(0, r, (q, c // 4), generator=g) \
            .repeat_interleave(4, dim=1)
    elif kind == "straddle":
        rows = torch.randint(0, r - c, (q, 1), generator=g) + torch.arange(c)
    else:                           # crowded: one tile
        rows = (torch.arange(c) % TILE_ROWS).expand(q, c)
    rows = rows.to(torch.int32).contiguous()
    ids = rows.clone()
    ids[torch.rand(q, c, generator=g) < 0.2] = -1
    ids[0] = -1
    ids[1, 2:] = -1
    table = torch.randn(r, d, generator=g)
    qs = torch.randn(q, d, generator=g)
    return (qs.to(device), table.to(device), rows.to(device),
            ids.to(device))


def check_gathered(qs, table, rows, ids, k: int, id_vecs) -> float:
    """Kernel vs plain gathered top-k. Scores must agree within the f32
    summation bound D * 2**-24 * |q| * max|c| (Cauchy-Schwarz over the
    table's rows; the two sum in different orders); misses must fall in
    the same places; ids must be equal except where the kernel picked a
    different id whose exact score lies within twice that bound of the
    plain one (a near-tie). ``id_vecs[id]`` is an id's vector."""
    import torch
    from repro_torch.kernels.topk_scoring.ops import gathered_topk
    from repro_torch.kernels.topk_scoring.ref import gathered_topk_ref
    s, i = gathered_topk(qs, table, rows, ids, k=k)
    torch.cuda.synchronize()
    qn, d = qs.shape
    c = ids.shape[1]
    k_eff = min(k, c)
    s_ref, i_ref = gathered_topk_ref(qs, table, rows, ids, k=k_eff)
    shape = f"Q={qn} C={c} D={d} k={k}"
    if s.shape != (qn, k) or i.shape != (qn, k):
        fail(f"gathered shape {tuple(s.shape)} for {shape}")
    if k > k_eff and not (bool((i[:, k_eff:] == -1).all())
                          and bool(torch.isneginf(s[:, k_eff:]).all())):
        fail(f"gathered misses past C are not -inf/-1 for {shape}")
    s, i = s[:, :k_eff], i[:, :k_eff]
    miss = torch.isneginf(s_ref)
    if not (torch.equal(torch.isneginf(s), miss)
            and bool((i[miss] == -1).all())):
        fail(f"gathered misses differ from the plain version for {shape}")
    row_norm = float(table.double().norm(dim=1).max())
    tol = d * 2.0 ** -24 * qs.double().norm(dim=1, keepdim=True) * row_norm
    tol = tol.expand(-1, k_eff)
    err = torch.where(miss, 0.0, s.double() - s_ref.double()).abs()
    if bool((err > tol).any()):
        fail(f"gathered scores differ beyond the summation bound for "
             f"{shape}: max err {float(err.max()):.3e}")
    diff = i != i_ref
    if bool(diff.any()):
        exact = lambda ids_: torch.einsum(
            "qd,qkd->qk", qs.double(), id_vecs[ids_.long().clamp(min=0)]
            .double())
        gap = (exact(i) - exact(i_ref)).abs()
        if bool((gap[diff] > 2 * tol[diff]).any()):
            fail(f"gathered ids differ away from a near-tie for {shape}")
        log(f"    {int(diff.sum())} id(s) differ at near-ties ({shape})")
    return float(err.max()) if err.numel() else 0.0


def hamming_inputs(q: int, n: int, w: int, *, seed: int, device):
    """Random packed codes, half the corpus rows duplicating the other half
    (exact ties besides those of small integer distances)."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    qc = torch.randint(-2 ** 31, 2 ** 31 - 1, (q, w), generator=g,
                       dtype=torch.int32)
    cc = torch.randint(-2 ** 31, 2 ** 31 - 1, (n, w), generator=g,
                       dtype=torch.int32)
    cc[n // 2:] = cc[:n - n // 2].clone()
    return qc.to(device), cc.to(device)


def hamming_tie_inputs(q: int, n: int, w: int, *, kind: str, seed: int,
                       device):
    """Codes whose distances pile up on a few values: ``equal``, every
    corpus code the same (one bin holds all N rows); ``few``, drawn from 5
    codes. Queries are corpus codes, every other one with a bit flipped."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    if kind == "equal":
        cc = torch.full((n, w), 12345, dtype=torch.int32)
    else:
        pool = torch.randint(-2 ** 31, 2 ** 31 - 1, (5, w), generator=g,
                             dtype=torch.int32)
        cc = pool[torch.randint(0, 5, (n,), generator=g)].contiguous()
    qc = cc[torch.randint(0, n, (q,), generator=g)].clone()
    qc[::2, 0] ^= 1
    return qc.to(device), cc.to(device)


def check_hamming(qc, cc, k: int) -> None:
    """Kernel vs plain Hamming top-k: exact integer distances on both
    sides, so scores and ids must be equal, ties included."""
    import torch
    from repro_torch.kernels.lsh_hamming.ops import hamming_topk
    from repro_torch.kernels.lsh_hamming.ref import hamming_topk_ref
    s, i = hamming_topk(qc, cc, k=k)
    torch.cuda.synchronize()
    n = cc.shape[0]
    k_eff = min(k, n)
    s_ref, i_ref = hamming_topk_ref(qc, cc, k=k_eff)
    shape = f"Q={qc.shape[0]} N={n} W={cc.shape[1]} k={k}"
    if s.shape != (qc.shape[0], k) or i.shape != (qc.shape[0], k):
        fail(f"hamming shape {tuple(s.shape)} for {shape}")
    if not (torch.equal(s[:, :k_eff], s_ref)
            and torch.equal(i[:, :k_eff], i_ref)):
        fail(f"hamming kernel != plain for {shape}")
    if not (bool((i[:, k_eff:] == -1).all())
            and bool(torch.isneginf(s[:, k_eff:]).all())):
        fail(f"hamming misses are not -inf/-1 for {shape}")


def attn_inputs(b: int, sq: int, skv: int, h: int, hkv: int, d: int, *,
                dtype, seed: int, device):
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn(b, sq, h, d, generator=g)
    k = torch.randn(b, skv, hkv, d, generator=g)
    v = torch.randn(b, skv, hkv, d, generator=g)
    return tuple(t.to(device=device, dtype=dtype) for t in (q, k, v))


def check_flash(q, k, v, causal: bool, window) -> float:
    """Kernel vs plain attention. f32: within rtol 1e-5, atol 2e-5 (the
    reference's own kernel tolerance; softmax sums and products in other
    orders). bf16: within 2e-2, the reference's (the plain version rounds
    scores and probabilities to bf16, the kernel keeps f32)."""
    import torch
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    b, sq, h, d = q.shape
    shape = (f"B={b} Sq={sq} Skv={k.shape[1]} H={h} Hkv={k.shape[2]} "
             f"D={d} {str(q.dtype)[6:]} causal={causal} window={window}")
    if out.shape != want.shape or out.dtype != want.dtype:
        fail(f"flash attention output {tuple(out.shape)} {out.dtype} for "
             f"{shape}")
    rtol, atol = ((ATTN_BF16_TOL, ATTN_BF16_TOL)
                  if q.dtype == torch.bfloat16 else ATTN_F32_TOL)
    err = (out.float() - want.float()).abs()
    if bool((err > atol + rtol * want.float().abs()).any()) or \
            not bool(torch.isfinite(out).all()):
        fail(f"flash attention kernel != plain beyond rtol {rtol} atol "
             f"{atol} for {shape}: max err {float(err.max()):.3e}")
    return float(err.max()) if err.numel() else 0.0


def eval_corpus(num_queries: int, vocab: int, *, embed: bool = True):
    """The evaluation CLI's corpus at its default widths, and its tf-idf
    embedding (entities, queries) as numpy."""
    from repro_torch.data.synthetic import generate_corpus
    from repro_torch.eval import tfidf_embedder
    corpus = generate_corpus(num_queries=num_queries, qrels_per_query=16,
                             num_topics=48, aux_fraction=1.0,
                             vocab_size=vocab, query_len=24, seed=0)
    return (corpus, tfidf_embedder(corpus)) if embed else corpus


# --------------------------------------------------------------------------
# main-path runs
# --------------------------------------------------------------------------

def reset_memory() -> None:
    """Zero the allocator's peak and the build-peak gauge before a run."""
    import torch
    from repro_torch.obs import REGISTRY, memory
    torch.cuda.reset_peak_memory_stats()
    REGISTRY.gauge(memory.PEAK_GAUGE).set(0)


def log_trace(path: str, wall: float) -> None:
    """A run's ``--trace`` file as ``repro_torch.launch.trace`` tables it
    (per span name: count, total, mean, p50, p99 s, the first calls'
    share), the wall time outside every top-level span (corpus
    generation, embedding, fits), and the memory gauge after the run."""
    import torch
    from repro_torch.launch import trace as trace_cli
    from repro_torch.obs import REGISTRY, memory
    spans = trace_cli.load_spans(path)
    table = trace_cli.format_table(trace_cli.aggregate(spans), sort="total")
    for line in table.splitlines():
        log(f"    {line}")
    top = sum(r["dur_s"] for r in spans if r["parent"] is None)
    log(f"    outside spans {wall - top:.3f} s of {wall:.3f} s wall")
    log(f"    {memory.PEAK_GAUGE} "
        f"{REGISTRY.gauge(memory.PEAK_GAUGE).value:.0f} B (0 when the run "
        f"builds no index); allocator peak over the run "
        f"{torch.cuda.max_memory_allocated()} B")


def check_no_build(region: str) -> None:
    """Fail if the recompile sentinel counted an nvcc build in ``region``:
    every kernel was built in phase 2."""
    from repro_torch.obs import recompile
    if recompile.total(region):
        fail(f"{recompile.total(region)} kernel build(s) in {region}; "
             f"phase 2 built every source")
    log(f"    recompile sentinel: 0 builds in {region}")


def check_untuned(region: str, hits0: float) -> None:
    """Fail if a launch in ``region`` took its params from a tuned table
    (the ``tuning.resolve.hit`` counter moved past ``hits0``): outside
    phase 10 no table is active, so every launch uses today's split
    plans."""
    from repro_torch.obs import REGISTRY
    hits = REGISTRY.counter("tuning.resolve.hit").value - hits0
    if hits:
        fail(f"{hits:.0f} launch(es) in {region} resolved through a tuned "
             f"table; only phase 10 activates one")


def profile_top(label: str, fn):
    """Run ``fn()`` under cProfile; log the functions with the largest
    cumulative and the largest own time, and keep the profile in OUT."""
    import cProfile
    import io
    import pstats
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.runcall(fn)
    wall = time.perf_counter() - t0
    prof.dump_stats(os.path.join(OUT, f"{label}.prof"))
    log(f"    {label} under cProfile: {wall:.2f} s wall")
    for order in ("cumulative", "tottime"):
        buf = io.StringIO()
        pstats.Stats(prof, stream=buf).sort_stats(order).print_stats(
            PROFILE_TOP)
        rows = [line for line in buf.getvalue().splitlines()
                if re.match(r"\s*[\d/]+(\s+[\d.]+){4}\s", line)]
        log(f"    top {PROFILE_TOP} by {order} (ncalls tottime percall "
            f"cumtime percall function):")
        for line in rows[:PROFILE_TOP]:
            log(f"      {line.strip().replace(ROOT + os.sep, '')[:160]}")


def device_profile(fn):
    """Run ``fn()`` once under ``torch.profiler`` (CPU and CUDA activity)
    and return (wall s, device-busy s, {kernel name: (launches, device
    s)}). Device-busy is the union of the kernels' intervals on the card;
    with no device event recorded it is None (not measured)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, per_kernel = [], {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = evt.time_range.start, evt.time_range.end
        spans.append((start, end))
        n, us = per_kernel.get(evt.name, (0, 0.0))
        per_kernel[evt.name] = (n + 1, us + (end - start))
    busy, reach = 0.0, None
    for start, end in sorted(spans):
        if reach is None or start > reach:
            busy += end - start
            reach = end
        elif end > reach:
            busy += end - reach
            reach = end
    per_kernel = {k: (n, us * 1e-6) for k, (n, us) in per_kernel.items()}
    return wall, (busy * 1e-6 if spans else None), per_kernel


def call_device_ms(per_kernel: dict, calls: int):
    """Device ms a call from ``device_profile``'s kernels over ``calls``
    identical calls, or None with no device event. The profiler may miss
    a launch now and then (seen on the H100: one to three of 8-10): that
    lowers a kernel's count, not its mean, so each kernel counts its mean
    times its launches a call (its count over ``calls``, rounded up)."""
    if not per_kernel:
        return None
    return sum(sec / n * -(-n // calls)
               for n, sec in per_kernel.values()) * 1e3


def log_profile(what: str, prof) -> None:
    wall, busy, per_kernel = prof
    if busy is None:
        log(f"    profile of {what}: {wall:.3f} s wall; the profiler saw no "
            f"device activity, so the idle share is not measured")
        return
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:6]
    log(f"    profile of {what}: {wall:.3f} s wall, device busy "
        f"{busy:.3f} s, idle share {1 - busy / wall:.3f}; top kernels: "
        + "; ".join(f"{k[:60]} x{n} {sec * 1e3:.3f} ms"
                    for k, (n, sec) in top))


def reset_counts(kernels) -> None:
    """Zero every kernel's launch and shape counts and start timing each
    launch (``Kernel.timed``)."""
    from repro_torch.kernels.build import Kernel
    for kern in kernels:
        kern.launches = 0
        kern.shapes.clear()
    Kernel.timed = []


def read_counts(kernels, what: str, shapes: dict = None) -> dict:
    """Stop timing launches; log each launched kernel's count by shape (the
    entry point's integer arguments) and its device time summed over the
    run (the CUDA events around its every launch); add the counts by shape
    into ``shapes`` ({name: Counter}) when given. Returns {name:
    launches}."""
    import torch
    from repro_torch.kernels.build import Kernel
    torch.cuda.synchronize()
    timed, Kernel.timed = Kernel.timed or [], None
    dev_ms: dict = {}
    for kname, start, end in timed:
        dev_ms[kname] = dev_ms.get(kname, 0.0) + start.elapsed_time(end)
    for kern in kernels:
        if not kern.launches:
            continue
        top = kern.shapes.most_common(4)
        more = len(kern.shapes) - len(top)
        log(f"    {what}: {kern.name} {kern.launches} launches, "
            f"{dev_ms.get(kern.name, 0.0):.3f} ms of device time in all; by "
            f"shape: " + "; ".join(f"{shape} x{n}" for shape, n in top)
            + (f"; and {more} more shapes" if more else ""))
        if shapes is not None:
            shapes.setdefault(kern.name, collections.Counter()).update(
                kern.shapes)
    return {kern.name: kern.launches for kern in kernels}


class Capture:
    """Within ``with``, record the arguments and the result of
    ``module.name``'s calls (the first of each distinct ``key(*args)``)
    and call it unchanged."""

    def __init__(self, module, name: str, key):
        self.module, self.name, self.key = module, name, key
        self.calls: dict = {}
        self.results: dict = {}

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def spy(*args, **kwargs):
            key = self.key(*args, **kwargs)
            self.calls.setdefault(key, (args, kwargs))
            out = self.orig(*args, **kwargs)
            self.results.setdefault(key, out)
            return out

        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


class PlainKernels:
    """Within ``with``, the int8, gathered and Hamming wrappers that the
    retrieval engines call run their plain versions, on the card's tensors
    (what the wrappers run on the CPU's)."""

    def __enter__(self):
        from repro_torch.kernels.lsh_hamming import ops as lsh_ops
        from repro_torch.kernels.lsh_hamming.ref import hamming_topk_ref
        from repro_torch.kernels.topk_scoring import ops as topk_ops
        from repro_torch.kernels.topk_scoring import ref as topk_ref
        pad = topk_ref.pad_topk

        def int8(q, c, *, k, split_blocks=None):
            return pad(*topk_ref.topk_scores_int8_ref(
                q, c, k=min(k, c.shape[0])), k)

        def gathered(q, table, rows, ids, *, k):
            return pad(*topk_ref.gathered_topk_ref(
                q, table, rows, ids, k=min(k, ids.shape[1])), k)

        def hamming(q, c, *, k, split_blocks=None):
            return pad(*hamming_topk_ref(q, c, k=min(k, c.shape[0])), k)

        self.swaps = [(topk_ops, "topk_scores_int8", int8),
                      (topk_ops, "gathered_topk", gathered),
                      (lsh_ops, "hamming_topk", hamming)]
        self.orig = [getattr(m, n) for m, n, _ in self.swaps]
        for m, n, fn in self.swaps:
            setattr(m, n, fn)
        return self

    def __exit__(self, *exc):
        for (m, n, _), fn in zip(self.swaps, self.orig):
            setattr(m, n, fn)


def shapes_key(*args, **kwargs):
    """A call's key for :class:`Capture`: its tensors' shapes and its k."""
    return (tuple(tuple(a.shape) for a in args), kwargs.get("k"))


def run_sample(argv):
    from repro_torch.launch import sample
    t0 = time.perf_counter()
    stats = sample.main(argv)
    import torch
    torch.cuda.synchronize()
    return stats, time.perf_counter() - t0


def run_evaluate(argv):
    from repro_torch.launch import evaluate
    t0 = time.perf_counter()
    out = evaluate.main(argv)
    import torch
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def lm_small_parity(arch: str) -> str:
    """17a: one LM arch's reduced config (f32) on the card against the
    CPU's plain path from the same seed: the init bit for bit; prefill's
    logits and caches, lm_loss at vocab_chunks 1 and 4 within LM_F32_TOL;
    a ServeEngine drain of 4 requests over 3 slots (one reused) the same
    greedy tokens. Returns a log line."""
    import dataclasses

    import torch
    from repro_torch import configs
    from repro_torch.core import prng
    from repro_torch.models import transformer as tf
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.train.optimizer import tree_leaves
    cfg = configs.get_arch(arch).make_reduced()
    params = {d: tf.init_transformer(prng.prng_key(0), cfg, device=d)
              for d in ("cuda", "cpu")}
    for got, want in zip(tree_leaves(params["cuda"]),
                         tree_leaves(params["cpu"])):
        if not torch.equal(got.cpu(), want):
            fail(f"17a {arch}: init on the card != the CPU's draw")
    rng = np.random.default_rng(17)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 24))
                            .astype(np.int32))
    err = 0.0

    def agree(what, got, want):
        nonlocal err
        got, want = got.float().cpu(), want.float()
        if not torch.allclose(got, want, rtol=LM_F32_TOL[0],
                              atol=LM_F32_TOL[1]):
            fail(f"17a {arch}: {what} differs by "
                 f"{(got - want).abs().max().item():.3g}, card vs CPU")
        err = max(err, (got - want).abs().max().item())

    with torch.no_grad():
        out = {d: tf.prefill(params[d], toks.to(d), cfg)
               for d in ("cuda", "cpu")}
        agree("prefill logits", out["cuda"][0], out["cpu"][0])
        for name in ("k", "v"):
            agree(f"prefill cache {name}", out["cuda"][1][name],
                  out["cpu"][1][name])
        for chunks in (1, 4):
            c = dataclasses.replace(cfg, vocab_chunks=chunks)
            agree(f"lm_loss at vocab_chunks {chunks}",
                  tf.lm_loss(params["cuda"], toks.cuda(), c),
                  tf.lm_loss(params["cpu"], toks, c))
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 3, 7, 4)]
    outs = {}
    for d in ("cuda", "cpu"):
        eng = ServeEngine(params[d], cfg, ServeConfig(
            max_batch=3, max_seq=32, max_new_tokens=6))
        reqs = [eng.submit(p) for p in prompts[:3]]
        while None not in reqs and all(s is not None for s in eng.slots):
            eng.step()
        reqs.append(eng.submit(prompts[3]))     # a freed slot, reused
        eng.drain()
        if eng.cache["k"].device.type != d:
            fail(f"17a {arch}: the engine's cache left {d}")
        outs[d] = [r.out for r in reqs]
    if outs["cuda"] != outs["cpu"]:
        fail(f"17a {arch}: greedy tokens differ, card {outs['cuda']} vs "
             f"CPU {outs['cpu']}")
    return (f"{arch}: init bit-equal; prefill logits and caches, lm_loss "
            f"(chunks 1, 4) within {err:.3g}; 4 requests over 3 slots: "
            f"the same {sum(map(len, outs['cuda']))} greedy tokens")


def copy_bandwidth() -> float:
    """The card's memory rate as a device-to-device copy of 2 GiB shows it
    (bytes read + written over the best of 5 CUDA-event times), B/s."""
    import torch
    src = torch.empty(1 << 31, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    dst.copy_(src)
    best = float("inf")
    for _ in range(5):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        dst.copy_(src)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return 2 * src.numel() / best


def gemma_full_width():
    """17b: gemma-2b at its published config, drawn from a seed on the
    card: the tree's size, then prefill of GEMMA_BATCH x GEMMA_SEQ tokens
    against GEMMA_SEQ decode_steps of the same tokens (last-token logits
    and caches within LM_BF16_TOL; argmax equal wherever the prefill's
    top-two gap exceeds it). Returns (cfg, the f32 tree, the bf16 tree,
    the decode step's ms list)."""
    import torch
    from repro_torch import configs
    from repro_torch.core import prng
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import tree_leaves
    cfg = configs.get_arch("gemma-2b").make_config()
    t0 = time.perf_counter()
    params = tf.init_transformer(prng.prng_key(0), cfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = sum(t.numel() for t in tree_leaves(params))
    if n != tf.count_params(cfg) or n != 2_506_172_416:
        fail(f"17b: gemma-2b's tree holds {n} elements, count_params "
             f"{tf.count_params(cfg)}")
    pb = tf.tree_to(params, cfg.dtype)
    toks = torch.from_numpy(np.random.default_rng(172).integers(
        0, cfg.vocab_size, (GEMMA_BATCH, GEMMA_SEQ)).astype(np.int32)).cuda()
    with torch.no_grad():
        prefill_s = []
        for _ in range(2):      # the first call's and a warm one's wall
            t0 = time.perf_counter()
            logits, cache = tf.prefill(pb, toks, cfg)
            torch.cuda.synchronize()
            prefill_s.append(time.perf_counter() - t0)
        dcache = tf.init_kv_cache(cfg, GEMMA_BATCH, GEMMA_SEQ)
        step_ms = []
        for t in range(GEMMA_SEQ):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
            start.record()
            dlogits, dcache = tf.decode_step(pb, dcache, toks[:, t:t + 1],
                                             cfg)
            end.record()
            step_ms.append((start, end))
        torch.cuda.synchronize()
        # 8 more steps under the profiler: the device's busy share and
        # launches a step (the position wraps the cache; timing only)
        last = toks[:, -1:]
        prof = device_profile(lambda: [tf.decode_step(pb, dcache, last, cfg)
                                       for _ in range(8)])
    step_ms = [a.elapsed_time(b) for a, b in step_ms]
    lp, ld = logits.float(), dlogits[:, 0].float()
    errs = {"logits": (ld - lp).abs().max().item()}
    for name in ("k", "v"):
        errs[name] = (dcache[name].float() - cache[name].float()).abs() \
            .max().item()
    if (dcache["pos"] != GEMMA_SEQ).any() or (cache["pos"] != GEMMA_SEQ).any():
        fail("17b: a cache's pos is not the prompt length")
    top2 = lp.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > LM_BF16_TOL
    same = (lp.argmax(-1) == ld.argmax(-1))
    log(f"    17b gemma-2b ({n} parameters, f32 tree drawn on the card in "
        f"{init_s:.2f} s): prefill {GEMMA_BATCH} x {GEMMA_SEQ} "
        f"{prefill_s[0] * 1e3:.1f} ms (first call), {prefill_s[1] * 1e3:.1f} "
        f"ms (warm); {GEMMA_SEQ} decode_steps at batch "
        f"{GEMMA_BATCH}: p50 {np.percentile(step_ms, 50):.3f} ms, p99 "
        f"{np.percentile(step_ms, 99):.3f} ms a step (CUDA events); prefill "
        f"vs decode max |d| logits {errs['logits']:.4f} (|logits| <= "
        f"{lp.abs().max().item():.2f}), k {errs['k']:.4f}, v "
        f"{errs['v']:.4f}, tolerance {LM_BF16_TOL}; argmax equal on "
        f"{int((same & clear).sum())} of the {int(clear.sum())} rows whose "
        f"top-two gap exceeds it ({int(same.sum())} of {GEMMA_BATCH} in all)")
    log_profile("17b: 8 decode steps", prof)
    log(f"    17b: {sum(n for n, _ in prof[2].values()) / 8:.0f} device "
        f"launches a decode step (the profiler's count over 8)")
    if max(errs.values()) > LM_BF16_TOL:
        fail(f"17b: prefill vs decode differ beyond {LM_BF16_TOL}: {errs}")
    if not bool(same[clear].all()):
        fail("17b: prefill and decode pick different tokens where the "
             "top-two gap exceeds the tolerance")
    del logits, cache, dcache, dlogits
    return cfg, params, pb, step_ms


def rag_full_width(cfg, params, pb, kernels, smi: str) -> dict:
    """17c: the RAG stack of examples/serve_rag.py at full width: a
    WindTunnel sample of a synthetic corpus (the LP kernel), tf-idf
    vectors, a RetrievalFrontend on ivfflat (the gathered top-k and merge
    kernels), and a RagEngine over a gemma-2b ServeEngine. Returns the
    kernels' launches in the serving run."""
    import torch
    from repro_torch.core import WindTunnelConfig, prng, run_windtunnel
    from repro_torch.data.synthetic import generate_corpus
    from repro_torch.launch import trace as trace_cli
    from repro_torch.models import transformer as tf
    from repro_torch.obs import trace
    from repro_torch.retrieval.search_core import SearchConfig
    from repro_torch.retrieval.tfidf import tfidf_vectors
    from repro_torch.serve import (RagEngine, RetrievalFrontend, ServeConfig,
                                   ServeEngine)
    t0 = time.perf_counter()
    corpus = generate_corpus(num_queries=RAG_CORPUS_QUERIES,
                             qrels_per_query=16, num_topics=48,
                             aux_fraction=1.0, vocab_size=2048,
                             query_len=24, seed=0)
    gen_s = time.perf_counter() - t0
    reset_counts(kernels)
    reset_memory()
    path = os.path.join(OUT, "rag_trace.jsonl")
    if os.path.exists(path):
        os.remove(path)
    trace.enable(path)
    t0 = time.perf_counter()
    wt_cfg = WindTunnelConfig(tau_quantile=0.5, fanout=16, lp_rounds=4,
                              target_size=0.3 * corpus.num_primary, seed=0)
    res = run_windtunnel(corpus.qrels, num_queries=corpus.num_queries,
                         num_entities=corpus.num_entities, config=wt_cfg,
                         device="cuda")
    kept = torch.nonzero(res.sample.entity_mask)[:, 0].cpu().numpy()
    vecs, df = tfidf_vectors(corpus.passage_tokens[kept], corpus.vocab_size)

    def embed(toks):
        return tfidf_vectors(np.asarray(toks), corpus.vocab_size, df)[0]

    frontend = RetrievalFrontend(
        vecs, embed, config=SearchConfig(engine="ivfflat"),
        key=prng.prng_key(0), ids_map=kept, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    engine = ServeEngine(params, cfg, ServeConfig(
        max_batch=8, max_seq=512, max_new_tokens=RAG_NEW_TOKENS))
    del params
    if engine.cache["k"].device.type != "cuda":
        fail("17c: the engine's KV cache is not on the card")
    rag = RagEngine(frontend, engine,
                    lambda gid: corpus.passage_tokens[gid],
                    ctx_tokens=RAG_CTX_TOKENS)
    reqs, ids = [], []
    t0 = time.perf_counter()
    steps = 0
    for qi in range(RAG_REQUESTS):
        while all(s is not None for s in engine.slots):
            steps += bool(engine.step())
        q = corpus.query_tokens[qi]
        req, got = rag.submit_query(q, q, k=3)
        if req is None:
            fail(f"17c: request {qi} was rejected with a free slot")
        reqs.append(req)
        ids.append(got)
    steps += engine.drain()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    trace.disable()
    launched = read_counts(kernels, "17c RAG")
    for kname in ("lp_round", "gathered_tiles", "topk_merge"):
        if not launched[kname]:
            fail(f"17c launched no {kname} kernel")
    peak = torch.cuda.max_memory_allocated()
    if any(len(r.out) != RAG_NEW_TOKENS or not r.done for r in reqs):
        fail(f"17c: a request did not get {RAG_NEW_TOKENS} tokens")
    direct = [frontend.session.search(embed(corpus.query_tokens[qi:qi + 1]),
                                      k=3)[0]
              for qi in range(RAG_REQUESTS)]
    if not all(np.array_equal(a, b) for a, b in zip(ids, direct)):
        fail("17c: the RAG path's retrieved ids != session.search's")
    # teacher forcing: each of RAG_FORCED requests alone, fed its prompt
    # and the engine's own tokens; each engine token's logit within the
    # tolerance of that step's largest
    gap = 0.0
    with torch.no_grad():
        for req in reqs[:RAG_FORCED]:
            feed = list(req.prompt) + req.out[:-1]
            cache = tf.init_kv_cache(cfg, 1, 512)
            for t, tok in enumerate(feed):
                logits, cache = tf.decode_step(
                    engine.params, cache,
                    torch.tensor([[tok]], dtype=torch.int32, device="cuda"),
                    cfg)
                j = t - (len(req.prompt) - 1)
                if j >= 0:
                    row = logits[0, 0].float()
                    gap = max(gap, (row.max() - row[req.out[j]]).item())
    if gap > LM_BF16_TOL:
        fail(f"17c: an engine token's logit is {gap:.4f} below its step's "
             f"largest when re-run alone (tolerance {LM_BF16_TOL})")
    spans = trace_cli.aggregate(trace_cli.load_spans(path))
    step = spans["serve.step"]
    lat = np.array([r.t_done - r.t_submit for r in reqs]) * 1e3
    tokens = sum(len(r.out) for r in reqs)
    n_layer = tf.count_params(cfg) - cfg.vocab_size * cfg.d_model
    step_bytes = 2 * (n_layer + cfg.vocab_size * cfg.d_model)
    bw = copy_bandwidth()
    hits = sum(bool(i.size and i[0] >= 0) for i in ids)
    log(f"    17c RAG: corpus of {corpus.num_entities} passages "
        f"({RAG_CORPUS_QUERIES} queries) drawn in {gen_s:.2f} s on the host; "
        f"WindTunnel sample of {kept.size}, tf-idf (D {vecs.shape[1]}) and "
        f"the ivfflat frontend in {build_s:.2f} s")
    log(f"    17c RAG: {RAG_REQUESTS} requests ({hits} with a retrieved "
        f"passage), {steps} engine steps, {tokens} tokens in {serve_s:.2f} s "
        f"({tokens / serve_s:.1f} tokens/s); serve.step p50 "
        f"{step['p50_s'] * 1e3:.3f} ms, p99 {step['p99_s'] * 1e3:.3f} ms "
        f"over {step['count']}; request latency p50 "
        f"{np.percentile(lat, 50):.1f} ms, p99 {np.percentile(lat, 99):.1f} "
        f"ms; allocator peak {peak} B; every request got {RAG_NEW_TOKENS} "
        f"tokens, retrieved ids equal to session.search's")
    log(f"    17c RAG: a step's bytes bound {step_bytes / 1e9:.3f} GB "
        f"({n_layer} layer and {cfg.vocab_size * cfg.d_model} head "
        f"parameters in bf16) over {bw / 1e12:.3f} TB/s (a 2 GiB copy on "
        f"this card) = {step_bytes / bw * 1e3:.3f} ms; {RAG_FORCED} requests "
        f"re-run alone, teacher-forced: every engine token within "
        f"{gap:.4f} of its step's largest logit (tolerance {LM_BF16_TOL}); "
        f"{smi}")
    del engine, rag, frontend, pb, res
    return launched


def adam_atol(steps: int) -> float:
    """The parameters' bound after ``steps`` AdamW steps from equal
    states: 2 lr(step) a step (where |g| is near its own error, m/sqrt(v)
    may take either sign, a full update either way)."""
    import torch
    from repro_torch.train.optimizer import AdamWConfig, _schedule
    return sum(2 * _schedule(torch.tensor(s), AdamWConfig()).item()
               for s in range(1, steps + 1))


def tree_ptrs(*trees) -> list:
    from repro_torch.train.optimizer import tree_leaves
    return [t.data_ptr() for tree in trees for t in tree_leaves(tree)]


def bytes_written() -> int:
    """Bytes this process has passed to write calls so far (``wchar`` of
    ``/proc/self/io``): the card's machine caps what a run writes to its
    disk at 45 GiB."""
    with open("/proc/self/io") as f:
        return int(dict(line.split(": ") for line in f.read().splitlines())
                   ["wchar"])


def leaf_sums(trees) -> "torch.Tensor":
    """Two 64-bit checksums of each leaf's 32-bit words, in exact integer
    arithmetic (wrapping) on the leaf's device: their sum and their sum
    weighted by position (1-based). (n leaves, 2) int64 on the host."""
    import torch
    from repro_torch.train.optimizer import tree_leaves
    chunk = 1 << 24
    out = []
    for t in (t for tree in trees for t in tree_leaves(tree)):
        words = t.reshape(-1).view(torch.int32)
        sums = torch.zeros(2, dtype=torch.int64, device=t.device)
        for a in range(0, words.numel(), chunk):
            c = words[a:a + chunk].to(torch.int64)
            sums[0] += c.sum()
            sums[1] += (c * torch.arange(a + 1, a + 1 + c.numel(),
                                         device=t.device)).sum()
        out.append(sums)
    return torch.stack(out).cpu()


def same_leaves(trees, host_trees) -> bool:
    """The leaves of ``trees`` (on the card) equal to those of
    ``host_trees`` (on the host) bit for bit, in the same order."""
    import torch
    from repro_torch.train.optimizer import tree_leaves
    got = [t for tree in trees for t in tree_leaves(tree)]
    want = [h for tree in host_trees for h in tree_leaves(tree)]
    return len(got) == len(want) and all(
        t.dtype == h.dtype and torch.equal(t, h.to(t.device))
        for t, h in zip(got, want))


def train_small_parity(arch: str, mesh, ckdir: str) -> str:
    """18a: one LM arch's reduced train cell (f32) on the card against the
    CPU's plain path from launch/train's initial draw: 3 steps' losses
    within LM_F32_TOL, parameters and moments within adam_atol; the
    donated update bit-equal to the functional adamw_update on the card;
    launch/train for 12 steps, then resumed to 20, equal to 20 steps
    uninterrupted: losses and final checkpoints bit for bit. Returns a
    log line."""
    import torch
    from repro_torch import configs
    from repro_torch.launch import cells
    from repro_torch.launch import train as train_cli
    from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                             adamw_update, adamw_update_,
                                             tree_leaves, tree_map)
    cell = cells.build_lm_cell(arch, "train_4k", mesh, reduced=True)
    runs = {}
    for d in ("cuda", "cpu"):
        params = train_cli.initial_params(cell, 0, d)
        opt = adamw_init(params)
        losses = []
        for step in range(3):
            params, opt, loss = cell.fn(params, opt,
                                        train_cli.step_batch(cell, step, d))
            losses.append(loss.item())
        runs[d] = (params, opt, losses)
    if not np.allclose(runs["cuda"][2], runs["cpu"][2], rtol=LM_F32_TOL[0],
                       atol=LM_F32_TOL[1]):
        fail(f"18a {arch}: losses card {runs['cuda'][2]} vs CPU "
             f"{runs['cpu'][2]}")
    atol = adam_atol(3)
    err = max((a.cpu() - b).abs().max().item() for a, b in zip(
        tree_leaves(runs["cuda"][0]) + tree_leaves(runs["cuda"][1]["m"]),
        tree_leaves(runs["cpu"][0]) + tree_leaves(runs["cpu"][1]["m"])))
    if err > atol:
        fail(f"18a {arch}: parameters or moments after 3 steps differ by "
             f"{err:.3g}, card vs CPU (bound {atol:.3g})")
    # the donated update against the functional one on the card
    params, opt, _ = runs["cuda"]
    cfg = configs.get_arch(arch).make_reduced()
    _, grads = cells.lm_grads(params, train_cli.step_batch(cell, 3, "cuda"),
                              cfg)
    want = adamw_update(grads, opt, params, AdamWConfig())
    got = tree_map(torch.clone, params), tree_map(torch.clone, opt)
    ptrs = tree_ptrs(*got)
    adamw_update_(grads, got[1], got[0], AdamWConfig())
    if tree_ptrs(*got) != ptrs:
        fail(f"18a {arch}: the donated update moved a leaf")
    if not all(torch.equal(a, b) for a, b in zip(
            tree_leaves(got[0]) + tree_leaves(got[1]),
            tree_leaves(want[0]) + tree_leaves(want[1]))):
        fail(f"18a {arch}: the donated update != adamw_update on the card")
    # launch/train: 12 steps, resumed to 20, against 20 uninterrupted
    n_leaves = check_cli_resume(arch, ckdir, "18a")
    return (f"{arch}: 3 train steps, losses {runs['cuda'][2][0]:.6f}.."
            f"{runs['cuda'][2][-1]:.6f} within {LM_F32_TOL} of the CPU's, "
            f"parameters and moments within {err:.3g} (bound {atol:.3g}); "
            f"donated update bit-equal to adamw_update, no leaf moved; "
            f"launch/train 12 + 8 resumed steps bit-equal to 20 (losses and "
            f"the step-20 checkpoint, {n_leaves} leaves)")


def check_cli_resume(arch: str, ckdir: str, tag: str) -> int:
    """launch/train for 12 steps, then resumed to 20, against 20 steps
    uninterrupted: losses and the step-20 checkpoints bit for bit. Returns
    the checkpoint's leaf count."""
    import io
    from repro_torch.launch import train as train_cli
    dirs = [os.path.join(ckdir, arch, name) for name in ("resumed", "whole")]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        first = train_cli.main(["--arch", arch, "--steps", "12",
                                "--checkpoint-dir", dirs[0]])
        second = train_cli.main(["--arch", arch, "--steps", "20",
                                 "--checkpoint-dir", dirs[0]])
        whole = train_cli.main(["--arch", arch, "--steps", "20",
                                "--checkpoint-dir", dirs[1]])
    if "resumed from step 12" not in out.getvalue() or len(second) != 8:
        fail(f"{tag} {arch}: launch/train did not resume at step 12")
    if first + second != whole:
        fail(f"{tag} {arch}: resumed losses {second} != uninterrupted "
             f"{whole[12:]}")
    saved = [np.load(os.path.join(d, "step_0000000020", "leaves.npz"))
             for d in dirs]
    if saved[0].files != saved[1].files or not all(
            np.array_equal(saved[0][f], saved[1][f]) for f in saved[0].files):
        fail(f"{tag} {arch}: the resumed run's step-20 checkpoint != the "
             f"uninterrupted run's")
    return len(saved[0].files)


def train_cell_parity(arch: str, shape: str, mesh) -> str:
    """19a: 3 steps of a reduced train cell from launch/train's initial
    draw and batches, on the card and on the CPU: losses within
    SMALL_TOL, parameters and moments within adam_atol(3)."""
    from repro_torch.launch import cells
    from repro_torch.launch import train as train_cli
    from repro_torch.train.optimizer import adamw_init, tree_leaves
    cell = cells.build_cell(arch, shape, mesh, reduced=True)
    runs = {}
    for d in ("cuda", "cpu"):
        params = train_cli.initial_params(cell, 0, d)
        opt = adamw_init(params)
        losses = []
        for step in range(3):
            params, opt, loss = cell.fn(params, opt,
                                        train_cli.step_batch(cell, step, d))
            losses.append(loss.item())
        runs[d] = (params, opt, losses)
    if not np.allclose(runs["cuda"][2], runs["cpu"][2], rtol=SMALL_TOL[0],
                       atol=SMALL_TOL[1]):
        fail(f"19a {arch} {shape}: losses card {runs['cuda'][2]} vs CPU "
             f"{runs['cpu'][2]}")
    atol = adam_atol(3)
    err = max((a.cpu() - b).abs().max().item() for a, b in zip(
        tree_leaves(runs["cuda"][0]) + tree_leaves(runs["cuda"][1]["m"]),
        tree_leaves(runs["cpu"][0]) + tree_leaves(runs["cpu"][1]["m"])))
    if err > atol:
        fail(f"19a {arch} {shape}: parameters or moments after 3 steps "
             f"differ by {err:.3g}, card vs CPU (bound {atol:.3g})")
    return (f"{arch} {shape}: 3 train steps, losses "
            f"{runs['cuda'][2][0]:.6f}..{runs['cuda'][2][-1]:.6f} within "
            f"{SMALL_TOL} of the CPU's, parameters and moments within "
            f"{err:.3g} (bound {atol:.3g})")


def recsys_small_parity(arch: str, mesh) -> str:
    """19a: a reduced recsys arch's serve and retrieval cells on the card
    against the CPU's plain path on the same draws: serve outputs within
    SMALL_TOL; retrieval over candidates covering the item rows in a
    shuffled order (rows drawn twice tie exactly), ids equal and scores
    within phase 3's bound (compare_topk)."""
    import torch
    from repro_torch import configs
    from repro_torch.launch import cells
    from repro_torch.launch import train as train_cli
    from repro_torch.models import recsys as rs
    from repro_torch.train.optimizer import tree_map
    cfg = configs.get_arch(arch).make_reduced()
    to_cuda = lambda tree: tree_map(lambda t: t.cuda(), tree)
    cell = cells.build_cell(arch, "serve_p99", mesh, reduced=True)
    params = train_cli.initial_params(cell, 0, "cpu")
    batch = train_cli._batch_like(cell.args[1], np.random.default_rng(1),
                                  "cpu")
    want = cell.fn(params, batch)
    got = cell.fn(to_cuda(params), to_cuda(batch)).cpu()
    if not torch.allclose(got, want, rtol=SMALL_TOL[0], atol=SMALL_TOL[1]):
        fail(f"19a {arch}: serve outputs differ by "
             f"{(got - want).abs().max().item():.3g}, card vs CPU")
    serve_err = (got - want).abs().max().item()
    cell = cells.build_cell(arch, "retrieval_cand", mesh, reduced=True)
    batch = train_cli._batch_like(cell.args[1], np.random.default_rng(2),
                                  "cpu")
    rows = rs.item_matrix(params, cfg).shape[0]
    nc = cell.args[2].shape[0]
    cand = torch.from_numpy(np.random.default_rng(3).permutation(
        np.arange(nc) % rows).astype(np.int32))
    s_ref, i_ref = cell.fn(params, batch, cand)
    pc, bc, cc = to_cuda(params), to_cuda(batch), cand.cuda()
    s, i = cell.fn(pc, bc, cc)
    torch.cuda.synchronize()
    err, ratio = compare_topk(rs.user_vector(pc, bc, cfg),
                              rs.candidate_rows(pc, cfg, cc), s, i,
                              s_ref.cuda(), i_ref.cuda(),
                              f"19a {arch} retrieval Q=1 N={nc}")
    if not torch.equal(i.cpu(), i_ref):
        fail(f"19a {arch}: retrieval ids differ, card vs CPU")
    return (f"{arch}: serve_p99 outputs within {serve_err:.3g} of the "
            f"CPU's; retrieval over {nc} "
            f"candidates of {rows} item rows, k {i.shape[1]}: ids equal, "
            f"scores within {err:.3g} ({ratio:.3f} of phase 3's bound)")


def recsys_batch(cfg, b: int, seed: int, device, label=True) -> dict:
    """A recsys batch of ``b`` rows drawn from ``seed``: every id within
    its table (uniform), dense features normal, labels 0/1; DIEN's
    histories 80 % present."""
    import torch
    from repro_torch.models import recsys as rs
    rng = np.random.default_rng(seed)
    if cfg.arch == "dien":
        t = cfg.seq_len
        out = {"target_item": rng.integers(0, cfg.item_vocab, b),
               "target_cat": rng.integers(0, cfg.cat_vocab, b),
               "hist_items": rng.integers(0, cfg.item_vocab, (b, t)),
               "hist_cats": rng.integers(0, cfg.cat_vocab, (b, t)),
               "hist_mask": (rng.random((b, t)) < 0.8).astype(np.float32)}
    else:
        cards = (rs._autoint_cards(cfg) if cfg.arch == "autoint"
                 else cfg.vocab_sizes)
        out = {"sparse": np.stack([rng.integers(0, v, b) for v in cards],
                                  1)}
        if cfg.n_dense:
            out["dense"] = rng.standard_normal((b, cfg.n_dense)).astype(
                np.float32)
    if label:
        out["label"] = rng.integers(0, 2, b).astype(np.float32)
    return {k: torch.from_numpy(v.astype(np.int32) if v.dtype.kind == "i"
                                else v).to(device) for k, v in out.items()}


def timed_steps(step, n: int, warmup: int = 1) -> list:
    """Device ms of each of ``n`` calls of ``step()`` after ``warmup``
    (CUDA events around each call)."""
    import torch
    for _ in range(warmup):
        step()
    times = []
    for _ in range(n):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        step()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in times]


def free_card() -> None:
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def recsys_full_width(kernels, smi: str) -> dict:
    """19b: DCN-v2 at its published config, its tables drawn on the card:
    train_batch step times (CUDA events), allocator peak and a profiled
    step; serve_p99 and serve_bulk forward times; retrieval_cand through
    the dense top-k kernel against the plain path on the card (ids equal
    away from near-ties), with its time against matmul + stable sort;
    then one train_batch step each of AutoInt and DIEN. Returns the
    retrieval run's launches."""
    import torch
    from repro_torch import configs
    from repro_torch.core import prng
    from repro_torch.kernels.topk_scoring.ops import topk_scores
    from repro_torch.kernels.topk_scoring.ref import topk_scores_ref
    from repro_torch.kernels.tuning import H100_F32_FLOPS, H100_TF32_FLOPS
    from repro_torch.launch import cells
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import recsys as rs
    from repro_torch.obs.timing import cuda_ms
    from repro_torch.train.optimizer import adamw_init, tree_leaves
    mesh = make_host_mesh()
    cfg = configs.get_arch("dcn-v2").make_config()
    reset_memory()
    t0 = time.perf_counter()
    params = rs.init_recsys(prng.prng_key(0), cfg, device="cuda")
    torch.cuda.synchronize()
    n = sum(t.numel() for t in tree_leaves(params))
    n_table = sum(t.numel() for t in params["tables"].values())
    log(f"    19b: dcn-v2 ({n} parameters, {n_table} of them in 26 tables "
        f"of {sum(rs._pad_rows(v) for v in cfg.vocab_sizes)} padded rows "
        f"x {cfg.embed_dim}) drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s; {smi}")
    # train_batch: launch counts zeroed, none of the port's kernels lies
    # on the train and serve steps
    reset_counts(kernels)
    cell = cells.build_cell("dcn-v2", "train_batch", mesh)
    b = cell.args[2]["label"].shape[0]
    opt = adamw_init(params)
    batches = [recsys_batch(cfg, b, 190 + i, "cuda") for i in range(2)]
    ptrs = tree_ptrs(params, opt)
    losses = []

    def train_step():
        nonlocal params, opt
        params, opt, loss = cell.fn(params, opt, batches[len(losses) % 2])
        losses.append(loss)

    step_ms = timed_steps(train_step, RECSYS_STEPS)
    peak = torch.cuda.max_memory_allocated()
    losses = [x.item() for x in losses]
    if not np.all(np.isfinite(losses)) or tree_ptrs(params, opt) != ptrs:
        fail(f"19b dcn-v2: losses {losses}, or a leaf moved in a step")
    p50 = float(np.median(step_ms))
    flops = cell.model_flops_per_step
    adam_bytes = 8 * 4 * n       # read p, g, m, v; write p, m, v, g
    f_ms, b_ms = flops / H100_F32_FLOPS * 1e3, adam_bytes / 3.35e12 * 1e3
    log(f"    19b: dcn-v2 train_batch ({b} rows): step times "
        f"{', '.join(f'{x:.2f}' for x in step_ms)} ms (CUDA events, after "
        f"one warm-up), p50 {p50:.3f} ms; {flops:.4g} flop (3 x "
        f"_recsys_flops) at {H100_F32_FLOPS / 1e12:.0f} TFLOP/s f32 = "
        f"{f_ms:.3f} ms, plus AdamW's {adam_bytes:.4g} B (8 f32 passes over "
        f"the parameters) at 3.35 TB/s = {b_ms:.3f} ms: {f_ms + b_ms:.3f} ms "
        f"summed, {p50 / (f_ms + b_ms):.2f} x that; {flops / p50 / 1e9:.1f} "
        f"TFLOP/s; losses {losses[0]:.6f}..{losses[-1]:.6f}; allocator peak "
        f"{peak} B; every leaf kept its pointer; {smi}")
    prof = device_profile(train_step)
    log_profile("19b: one dcn-v2 train step", prof)
    log(f"    19b: {sum(k for k, _ in prof[2].values())} device launches in "
        f"a step (the profiler's count); {smi}")
    del opt, batches, prof
    free_card()
    for shape in ("serve_p99", "serve_bulk"):
        cell = cells.build_cell("dcn-v2", shape, mesh)
        b = cell.args[1]["sparse"].shape[0]
        batch = recsys_batch(cfg, b, 191, "cuda", label=False)
        reset_memory()
        out = []
        fwd_ms = timed_steps(lambda: out.append(cell.fn(params, batch)), 10)
        if out[-1].shape != (b,) or not bool(torch.isfinite(out[-1]).all()):
            fail(f"19b dcn-v2 {shape}: output {tuple(out[-1].shape)} or not "
                 f"finite")
        log(f"    19b: dcn-v2 {shape} ({b} rows): forward p50 "
            f"{float(np.median(fwd_ms)):.4f} ms over 10 calls (CUDA events; "
            f"min {min(fwd_ms):.4f}, max {max(fwd_ms):.4f}), "
            f"{cell.model_flops_per_step / np.median(fwd_ms) / 1e9:.2f} "
            f"TFLOP/s; allocator peak {torch.cuda.max_memory_allocated()} B; "
            f"{smi}")
        del out, batch
    serve_launches = read_counts(kernels, "phase 19b train and serve")
    if any(serve_launches.values()):
        fail(f"19b: the train and serve steps launched kernels: "
             f"{serve_launches}")
    # retrieval_cand: the main path of this slice's kernels
    cell = cells.build_cell("dcn-v2", "retrieval_cand", mesh)
    nc = cell.args[2].shape[0]
    batch = recsys_batch(cfg, 1, 192, "cuda", label=False)
    rows_n = rs.item_matrix(params, cfg).shape[0]
    big = max(cfg.vocab_sizes)
    cand = torch.from_numpy(np.random.default_rng(193).permutation(big)[
        :nc].astype(np.int32)).cuda()
    reset_counts(kernels)
    s, i = cell.fn(params, batch, cand)
    launched = read_counts(kernels, "phase 19b retrieval")
    for kname in ("topk_partial", "topk_merge"):
        if not launched[kname]:
            fail(f"19b: the retrieval step launched no {kname}")
    u = rs.user_vector(params, batch, cfg)
    rows = rs.candidate_rows(params, cfg, cand)
    k = i.shape[1]
    s_ref, i_ref = topk_scores_ref(u, rows, k=k)
    err, ratio = compare_topk(u, rows, s, i, s_ref, i_ref,
                              f"19b retrieval Q=1 N={nc} D={cfg.embed_dim}")
    kern_ms = cuda_ms(lambda: topk_scores(u, rows, k=k), 20)
    plain_ms = cuda_ms(lambda: topk_scores_ref(u, rows, k=k), 5)
    lib_ms = cuda_ms(lambda: torch.sort(u @ rows.T, dim=1, descending=True,
                                        stable=True), 5)
    step_ms = cuda_ms(lambda: cell.fn(params, batch, cand), 10)
    d = cfg.embed_dim
    r_bound, r_by = bound((1 + nc) * d * 4 + k * 8, 3 * 2.0 * nc * d,
                          H100_TF32_FLOPS)
    log(f"    19b: dcn-v2 retrieval_cand (1 x {nc} candidates of table 2's "
        f"{rows_n} rows, D {d}, k {k}): kernel ids equal to the plain path's "
        f"on the card (a stable sort of the product) away from near-ties, "
        f"scores within {err:.3g} ({ratio:.3f} of phase 3's bound); "
        f"topk_scores {kern_ms:.4f} ms, plain {plain_ms:.4f} ms, matmul + "
        f"stable sort {lib_ms:.4f} ms, bound {r_bound:.4f} ms ({r_by}); the "
        f"whole step (user vector, candidate gather, kernel) {step_ms:.4f} "
        f"ms; launches {launched}; {smi}")
    del params, cell, u, rows, s, i, s_ref, i_ref
    free_card()
    for arch in ("autoint", "dien"):
        acfg = configs.get_arch(arch).make_config()
        reset_memory()
        t0 = time.perf_counter()
        params = rs.init_recsys(prng.prng_key(1), acfg, device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        cell = cells.build_cell(arch, "train_batch", mesh)
        b = cell.args[2]["label"].shape[0]
        opt = adamw_init(params)
        batch = recsys_batch(acfg, b, 194, "cuda")
        losses = []

        def one():
            nonlocal params, opt
            params, opt, loss = cell.fn(params, opt, batch)
            losses.append(loss.item())

        ms = timed_steps(one, 2, warmup=0)
        if not np.all(np.isfinite(losses)):
            fail(f"19b {arch}: losses {losses}")
        log(f"    19b: {arch} train_batch ({b} rows, "
            f"{sum(t.numel() for t in tree_leaves(params))} parameters drawn "
            f"on the card in {init_s:.2f} s): first step {ms[0]:.2f} ms, "
            f"second {ms[1]:.2f} ms (CUDA events), "
            f"{cell.model_flops_per_step / ms[1] / 1e9:.1f} TFLOP/s at "
            f"{cell.model_flops_per_step:.4g} flop; losses "
            f"{losses[0]:.6f}, {losses[1]:.6f}; allocator peak "
            f"{torch.cuda.max_memory_allocated()} B; {smi}")
        del params, opt, batch, cell
        free_card()
    return launched


def sampled_block_batch(blocks, cell_batch: dict, seed: int, device) -> dict:
    """The two ``SubgraphBlock``s of a 2-hop sample laid into the
    train_sampled cell's padded arrays: the outer block's ``src_nodes``
    are the nodes (the batch's own first, then the first hop's), whose
    local ids both blocks' edges already use (the inner block's src nodes
    are the outer block's dst nodes, in order); padding is node 0
    self-loops, masked. Positions, features and targets of a node are
    drawn from ``seed`` by its global id; the batch's nodes are the
    labelled ones."""
    import torch
    inner, outer = blocks[1], blocks[0]
    n_nodes = cell_batch["positions"].shape[0]
    n_edges = cell_batch["edge_src"].shape[0]
    nodes = outer.src_nodes
    if not np.array_equal(outer.src_nodes[:outer.n_dst], inner.src_nodes):
        fail("19c: the outer block's dst nodes are not the inner block's "
             "src nodes")
    src = np.concatenate([inner.edge_src, outer.edge_src])
    dst = np.concatenate([inner.edge_dst, outer.edge_dst])
    mask = np.concatenate([inner.edge_mask, outer.edge_mask])
    if nodes.shape[0] > n_nodes or src.shape[0] > n_edges:
        fail(f"19c: the sample ({nodes.shape[0]} nodes, {src.shape[0]} "
             f"edges) exceeds the cell's padded block ({n_nodes}, {n_edges})")
    pad_e = n_edges - src.shape[0]
    rng = np.random.default_rng(seed)
    n_feat = cell_batch["node_feats"].shape[1]
    total = int(nodes.max()) + 1
    pos = rng.standard_normal((total, 3)).astype(np.float32)[nodes]
    feats = rng.standard_normal((total, n_feat)).astype(np.float32)[nodes]
    target = rng.standard_normal(total).astype(np.float32)[nodes]
    pad_n = n_nodes - nodes.shape[0]
    node_mask = np.zeros(n_nodes, np.float32)
    node_mask[:inner.n_dst] = 1.0
    out = {
        "positions": np.concatenate([pos, np.zeros((pad_n, 3), np.float32)]),
        "node_feats": np.concatenate(
            [feats, np.zeros((pad_n, n_feat), np.float32)]),
        "edge_src": np.concatenate([src, np.zeros(pad_e, np.int32)]),
        "edge_dst": np.concatenate([dst, np.zeros(pad_e, np.int32)]),
        "edge_mask": np.concatenate([mask, np.zeros(pad_e, bool)]),
        "graph_ids": np.zeros(n_nodes, np.int32),
        "node_target": np.concatenate([target, np.zeros(pad_n, np.float32)]),
        "node_mask": node_mask,
    }
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def mace_full_width(smi: str) -> None:
    """19c: MACE at its published config (2 layers, 128 channels, l_max 2,
    correlation 3). molecule: energies and forces on the card against the
    CPU on the same batch, then the second-order train step's times and
    peak. minibatch_lg: a NeighborSampler over a Reddit-sized graph drawn
    from a seed (host times), 1024 nodes at fanouts (15, 10) laid into the
    cell's padded arrays, and its train step's time, peak and achieved
    rate against mace_flops."""
    import torch
    from repro_torch import configs
    from repro_torch.core import prng
    from repro_torch.data import NeighborSampler
    from repro_torch.kernels.tuning import H100_F32_FLOPS
    from repro_torch.launch import cells
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import mace as mc
    from repro_torch.train.optimizer import adamw_init, tree_map
    mesh = make_host_mesh()
    cfg = configs.get_arch("mace").make_config()
    cell = cells.build_cell("mace", "molecule", mesh)
    spec = cell.args[2]
    n_nodes, n_edges = spec["positions"].shape[0], spec["edge_src"].shape[0]
    n_graphs = spec["energy_target"].shape[0]
    reset_memory()
    params = mc.init_mace(prng.prng_key(0), cfg, device="cuda")
    batch = mc.random_graph_batch(prng.prng_key(1), n_nodes=n_nodes,
                                  n_edges=n_edges, d_feat=cfg.d_feat,
                                  n_graphs=n_graphs, device="cuda")
    with torch.no_grad():
        e, f = mc.mace_energy_forces(params, batch, cfg)
        host = lambda tree: tree_map(lambda t: t.cpu() if isinstance(
            t, torch.Tensor) else t, tree)
        e_ref, f_ref = mc.mace_energy_forces(host(params), host(batch), cfg)
    e_err = (e.cpu() - e_ref).abs().max().item()
    f_err = (f.cpu() - f_ref).abs().max().item()
    scale = max(e_ref.abs().max().item(), f_ref.abs().max().item(), 1.0)
    if not (bool(torch.isfinite(e).all()) and bool(torch.isfinite(f).all())
            and max(e_err, f_err) <= MACE_TOL * scale):
        fail(f"19c molecule: energies differ by {e_err:.3g}, forces by "
             f"{f_err:.3g}, card vs CPU (bound {MACE_TOL} x {scale:.3g})")
    with torch.no_grad():
        ef_ms = timed_steps(lambda: mc.mace_energy_forces(params, batch, cfg),
                            5)
    batch.pop("n_graphs")
    opt = adamw_init(params)
    losses = []

    def step():
        nonlocal params, opt
        params, opt, loss = cell.fn(params, opt, batch)
        losses.append(loss)

    step_ms = timed_steps(step, 5)
    losses = [x.item() for x in losses]
    if not np.all(np.isfinite(losses)):
        fail(f"19c molecule: losses {losses}")
    p50 = float(np.median(step_ms))
    log(f"    19c: mace molecule ({n_graphs} graphs, {n_nodes} nodes, "
        f"{n_edges} edges, {cfg.channels} channels): energies and forces on the card "
        f"within {e_err:.3g} and {f_err:.3g} of the CPU's (bound "
        f"{MACE_TOL} x {scale:.3g}); energy+forces p50 "
        f"{float(np.median(ef_ms)):.3f} ms; second-order train step times "
        f"{', '.join(f'{x:.2f}' for x in step_ms)} ms, p50 {p50:.3f} ms "
        f"(CUDA events, after one warm-up), "
        f"{cell.model_flops_per_step / p50 / 1e9:.2f} TFLOP/s at "
        f"{cell.model_flops_per_step:.4g} flop (7 x mace_flops); losses "
        f"{losses[0]:.6f}..{losses[-1]:.6f}; allocator peak "
        f"{torch.cuda.max_memory_allocated()} B; {smi}")
    prof = device_profile(step)
    log_profile("19c: one molecule train step", prof)
    log(f"    19c: {sum(k for k, _ in prof[2].values())} device launches in "
        f"a molecule step (the profiler's count); {smi}")
    del params, opt, batch, e, f, prof
    free_card()
    # minibatch_lg: the sampler on the host, then one step on the card
    shape = configs.get_arch("mace").shapes["minibatch_lg"]
    total, n_e = shape["n_nodes"], shape["n_edges"]
    rng = np.random.default_rng(195)
    t0 = time.perf_counter()
    src = rng.integers(0, total, n_e, dtype=np.int32)
    dst = rng.integers(0, total, n_e, dtype=np.int32)
    draw_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sampler = NeighborSampler(src, dst, total, seed=0)
    build_s = time.perf_counter() - t0
    del src, dst
    nodes = rng.choice(total, shape["batch_nodes"], replace=False)
    t0 = time.perf_counter()
    blocks = sampler.sample(nodes, shape["fanouts"])
    sample_s = time.perf_counter() - t0
    del sampler
    cell = cells.build_cell("mace", "minibatch_lg", mesh)
    t0 = time.perf_counter()
    batch = sampled_block_batch(blocks, cell.args[2], 196, "cuda")
    torch.cuda.synchronize()
    lay_s = time.perf_counter() - t0
    log(f"    19c: Reddit-sized graph ({total} nodes, {n_e} edges) drawn "
        f"on the host in {draw_s:.2f} s; NeighborSampler built (argsort, "
        f"CSR) in {build_s:.2f} s; {shape['batch_nodes']} nodes sampled at "
        f"fanouts {shape['fanouts']} in {sample_s:.3f} s: blocks of "
        f"{blocks[1].n_dst} -> {blocks[1].src_nodes.shape[0]} -> "
        f"{blocks[0].src_nodes.shape[0]} nodes, "
        f"{int(blocks[1].edge_mask.sum()) + int(blocks[0].edge_mask.sum())} "
        f"live edges, laid into the cell's {cell.args[2]['positions'].shape[0]}"
        f" x {cell.args[2]['edge_src'].shape[0]} padded block and moved to "
        f"the card in {lay_s:.2f} s (host times)")
    reset_memory()
    params = mc.init_mace(prng.prng_key(2), cfg, device="cuda")
    opt = adamw_init(params)
    losses = []

    def sampled_step():
        nonlocal params, opt
        params, opt, loss = cell.fn(params, opt, batch)
        losses.append(loss)

    step_ms = timed_steps(sampled_step, 3)
    losses = [x.item() for x in losses]
    if not np.all(np.isfinite(losses)):
        fail(f"19c minibatch_lg: losses {losses}")
    p50 = float(np.median(step_ms))
    log(f"    19c: mace minibatch_lg train step times "
        f"{', '.join(f'{x:.2f}' for x in step_ms)} ms, p50 {p50:.3f} ms "
        f"(CUDA events, after one warm-up); {cell.model_flops_per_step:.4g} "
        f"flop (3 x mace_flops) = {cell.model_flops_per_step / p50 / 1e9:.2f}"
        f" TFLOP/s, {cell.model_flops_per_step / H100_F32_FLOPS / p50 * 1e3:.4f} "
        f"of the f32 peak; losses {losses[0]:.6f}..{losses[-1]:.6f}; "
        f"allocator peak {torch.cuda.max_memory_allocated()} B; {smi}")
    prof = device_profile(sampled_step)
    log_profile("19c: one minibatch_lg train step", prof)
    log(f"    19c: {sum(k for k, _ in prof[2].values())} device launches in "
        f"a minibatch_lg step (the profiler's count); {smi}")
    del params, opt, batch, prof
    free_card()


def gemma_train_full_width(smi: str) -> None:
    """18b: gemma-2b's train step at its published config (bf16 compute,
    f32 parameters, remat full) on TRAIN_BATCH x 4097 tokens: train_loop
    for 2 steps, an AsyncCheckpointer save of the state at step 2 written
    while step 3 runs, then the step-2 checkpoint restored into a fresh
    tree (equal to the saved state by leaf_sums) and step 3 from it equal
    to the run's loss and final state bit for bit; donation (no leaf
    moves), the allocator peak under the reckoning plus 10 %. One save of
    the 30.1 GB tree, not train_loop's two: the card's machine caps what a
    run writes to its disk at 45 GiB."""
    import shutil

    import torch
    from repro_torch import configs
    from repro_torch.core import prng
    from repro_torch.kernels.tuning import H100_BF16_FLOPS
    from repro_torch.launch import cells
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.train import checkpoint as ck
    from repro_torch.train.loop import LoopConfig, train_loop
    from repro_torch.train.optimizer import adamw_init, tree_leaves, tree_map
    cell = cells.build_lm_cell("gemma-2b", "train_4k", make_host_mesh(),
                               reduced=False)
    cfg = configs.get_arch("gemma-2b").make_config()
    pub_batch, s1 = cell.args[2].shape
    ckdir = os.path.join(OUT, "train_ckpt")
    shutil.rmtree(ckdir, ignore_errors=True)
    reset_memory()
    t0 = time.perf_counter()
    params = tf.init_transformer(prng.prng_key(0), cfg, device="cuda")
    opt = adamw_init(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = sum(t.numel() for t in tree_leaves(params))
    if n != tf.count_params(cfg):
        fail(f"18b: gemma-2b's tree holds {n} elements, count_params "
             f"{tf.count_params(cfg)}")
    state_gb = 16 * n / 1e9             # f32 parameters, m, v, gradients
    tokens = TRAIN_BATCH * (s1 - 1)
    logits_gb = 14 * tokens * cfg.vocab_size / 1e9
    reckoning = (state_gb + logits_gb) * 1e9
    log(f"    18b: gemma-2b ({n} parameters, f32 tree and AdamW state on the "
        f"card in {init_s:.2f} s); global batch cut from {pub_batch} to "
        f"{TRAIN_BATCH} sequences of {s1 - 1} tokens for memory: the "
        f"reckoning is {state_gb:.1f} GB of f32 parameters, m, v and "
        f"gradients plus {logits_gb:.1f} GB of logits (bf16, f32, their "
        f"gradient and logsumexp temporaries: 14 B a token a vocab entry) = "
        f"{reckoning / 1e9:.1f} GB; 4 sequences would need "
        f"{state_gb + 2 * logits_gb:.1f}")

    def batch_fn(step):
        return torch.from_numpy(np.random.default_rng(180 + step).integers(
            0, cfg.vocab_size, (TRAIN_BATCH, s1)).astype(np.int32)).cuda()

    events, starts = [], []

    def step_fn(p, o, t):
        ptrs = tree_ptrs(p, o)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        starts.append(time.perf_counter())
        start.record()
        out = cell.fn(p, o, t)
        end.record()
        events.append((start, end))
        if tree_ptrs(out[0], out[1]) != ptrs:
            fail("18b: a parameter or AdamW leaf moved in a step (donation)")
        return out

    t0 = time.perf_counter()
    params, opt, losses = train_loop(step_fn, params, opt, batch_fn,
                                     LoopConfig(total_steps=2, log_every=1))
    loop_s = time.perf_counter() - t0
    # the save of step 2, written on the worker while step 3 runs
    saves = []
    orig_save = ck.save_checkpoint

    def timed_save(directory, step, tree):
        free = shutil.disk_usage(OUT).free
        t0 = time.perf_counter()
        path = orig_save(directory, step, tree)
        saves.append((t0, time.perf_counter(), os.path.getsize(
            os.path.join(path, "leaves.npz")), free))
        return path

    ck.save_checkpoint = timed_save
    try:
        writer = ck.AsyncCheckpointer(ckdir, keep=1)
        sums2 = leaf_sums((params, opt))
        t0 = time.perf_counter()
        writer.save(2, (params, opt))
        copy_s = time.perf_counter() - t0
        params, opt, loss = step_fn(params, opt, batch_fn(2))
        losses.append(loss.item())
        step3_end = time.perf_counter()
        final = tuple(tree_map(lambda t: t.to("cpu", copy=True), x)
                      for x in (params, opt))
        writer.close()
    finally:
        ck.save_checkpoint = orig_save
    peak = torch.cuda.max_memory_allocated()
    step_ms = [a.elapsed_time(b) for a, b in events]
    if not all(np.isfinite(losses)):
        fail(f"18b: a loss is not finite: {losses}")
    if peak > 1.1 * reckoning:
        fail(f"18b: allocator peak {peak} B over the reckoning "
             f"{reckoning:.4g} B plus 10 %")
    flops = (8 * n * tokens + 4 * 4 * TRAIN_BATCH * cfg.n_layers
             * cfg.n_heads * (s1 - 1) ** 2 * cfg.head_dim)
    bound_ms = flops / H100_BF16_FLOPS * 1e3
    p50 = float(np.median(step_ms[1:]))
    log(f"    18b: train_loop 2 steps in {loop_s:.2f} s, then step 3 beside "
        f"the save; losses {', '.join(f'{x:.6f}' for x in losses)}; step "
        f"times {', '.join(f'{x:.1f}' for x in step_ms)} ms (CUDA events), "
        f"p50 after the first {p50:.1f} ms against the bound "
        f"{bound_ms:.1f} ms ({flops:.4g} flop: 8 N T with remat's second "
        f"forward, plus the blocked attention's, at "
        f"{H100_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16); "
        f"{flops / p50 / 1e9:.1f} TFLOP/s; allocator peak {peak} B "
        f"({peak / reckoning:.3f} of the reckoning); every leaf kept its "
        f"pointer through each step")
    (a, b, nbytes, free), = saves
    log(f"    18b: save of step 2: {nbytes} B; host copy in the caller "
        f"{copy_s:.2f} s, written on the worker in {b - a:.2f} s "
        f"({nbytes / (b - a) / 1e9:.2f} GB/s, from {a - starts[2]:+.2f} to "
        f"{b - starts[2]:+.2f} s of step 3's start, which ended at "
        f"{step3_end - starts[2]:+.2f}); disk free before {free} B")
    prof = device_profile(lambda: cell.fn(params, opt, batch_fn(3)))
    log_profile("18b: one train step", prof)
    log(f"    18b: {sum(k for k, _ in prof[2].values())} device launches in "
        f"a step (the profiler's count)")
    del params, opt, prof
    torch.cuda.empty_cache()
    # the step-2 checkpoint into a fresh tree: equal to what was saved
    like = tuple(tree_map(lambda s: torch.empty(0, dtype=s.dtype,
                                                 device="cuda"), spec)
                 for spec in cell.args[:2])
    t0 = time.perf_counter()
    (rp, ro), step = ck.restore_checkpoint(ckdir, like)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if step != 2 or not torch.equal(leaf_sums((rp, ro)), sums2):
        fail("18b: the step-2 checkpoint restored != the state saved")
    p3, o3, loss3 = cell.fn(rp, ro, batch_fn(2))
    if loss3.item() != losses[2]:
        fail(f"18b: step 3 from the restored state: loss {loss3.item()!r} "
             f"!= the run's {losses[2]!r}")
    if not same_leaves((p3, o3), final):
        fail("18b: step 3 from the restored state != the run's final state")
    log(f"    18b: the step-2 checkpoint restored into a fresh tree in "
        f"{restore_s:.2f} s, equal to the state saved by two 64-bit "
        f"checksums a leaf; step 3 from it gave the run's loss "
        f"{loss3.item():.6f} and final state bit for bit (every element "
        f"against a host copy); {smi}")
    del rp, ro, p3, o3, final
    shutil.rmtree(ckdir, ignore_errors=True)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run from a checkout")
    sys.path[:0] = [SRC, os.path.join(ROOT, "tools")]
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.ops import (FLASH_ATTENTION,
                                                         flash_attention)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.label_prop.ops import LP_ROUND, lp_round_cuda
    from repro_torch.kernels.lsh_hamming.ops import (HAMMING_TOPK,
                                                     hamming_topk)
    from repro_torch.kernels.lsh_hamming.ref import hamming_topk_ref
    from repro_torch.kernels.topk_scoring.ops import (GATHERED_TILES,
                                                      TILE_PIECES, TILE_ROWS,
                                                      TOPK_INT8_PARTIAL,
                                                      TOPK_MERGE,
                                                      TOPK_PARTIAL,
                                                      gathered_topk,
                                                      launch_merge,
                                                      topk_partials_cuda,
                                                      topk_scores,
                                                      topk_scores_int8)
    from repro_torch.kernels.topk_scoring.ref import (gathered_topk_ref,
                                                      topk_scores_int8_ref,
                                                      topk_scores_ref)
    from repro_torch.core import prng
    from repro_torch.core.label_prop import ell_round
    from repro_torch.kernels import tuning
    from repro_torch.kernels.tuning import (H100_BF16_FLOPS, H100_INT8_OPS,
                                            H100_TF32_FLOPS)
    from repro_torch.obs import REGISTRY, recompile, trace
    from repro_torch.obs.timing import cuda_ms
    from repro_torch.retrieval.engines import IVFFlatEngine, LSHEngine
    from repro_torch.retrieval.ivfflat import probe_candidates
    from repro_torch.retrieval.lsh import encode
    kernels = (LP_ROUND, TOPK_PARTIAL, TOPK_INT8_PARTIAL, GATHERED_TILES,
               HAMMING_TOPK, TOPK_MERGE, FLASH_ATTENTION)
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # 1. device ------------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[1/19] device: {name}; nvidia-smi: {smi}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build -------------------------------------------------------------
    # the recompile sentinel counts each nvcc run from here on: one a
    # source whose library is not built yet, then none
    recompile.enable()
    recompile.reset()
    t0 = time.perf_counter()
    sources = sorted({kern.source for kern in kernels})
    uncached = [src for src in sources if not build._paths(src)[1].exists()]

    def load_counted(src):
        with recompile.region("phase 2"):
            return build.load(src)

    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(load_counted, sources))
    log(f"[2/19] built {', '.join(sources)} in "
        f"{time.perf_counter() - t0:.1f} s")
    if recompile.counts() != ({"phase 2": len(uncached)} if uncached
                              else {}):
        fail(f"recompile sentinel counted {recompile.counts()}, expected "
             f"one build for each of {uncached}")
    log(f"    recompile sentinel: {len(uncached)} builds in phase 2, one "
        f"for each source not built before ({', '.join(uncached)})")
    for src in sources:
        for line in build.ptxas_report(src).splitlines():
            if "ptxas" in line:
                log(f"    {src}: {line.strip()}")

    # 3. kernel vs plain ---------------------------------------------------
    # no tuned table from here to phase 10, whatever the environment names:
    # every launch uses today's split plans, which check_untuned holds
    tuning.set_table(None)
    untuned_hits = REGISTRY.counter("tuning.resolve.hit").value
    main_shapes: dict = {}      # phases 5-7's launches by shape, for phase 10
    log("[3/19] kernel vs plain")
    for n, k, quarter in [(1, 1, True), (37, 5, True), (513, 33, True),
                          (300, 70, False), (4096, 0, True),
                          (100_003, 32, True), (100_003, 32, False)]:
        labels, nbr, wgt, _ = lp_inputs(n, k, seed=n + k, quarter=quarter,
                                        device=dev)
        check_lp(labels, nbr, wgt)
        if k > 1:                   # the same rows, padding anywhere
            check_lp(labels, *scatter_slots(nbr, wgt, seed=n))
    lp_main = lp_inputs(3_100_000, 32, seed=7, quarter=False, device=dev)
    check_lp(*lp_main[:3])
    check_lp(lp_main[0], *scatter_slots(*lp_main[1:3], seed=7))
    # the sharded pipeline's rounds: a block of rows from half of N, the
    # whole graph's labels (row0 on the block's own label)
    half = lp_main[1].shape[0] // 2
    for blk in (slice(half, None), slice(half, half + 1001)):
        check_lp(lp_main[0], *(x[blk].contiguous() for x in lp_main[1:3]),
                 row0=half)
    log(f"    lp_round: labels equal at 8 shapes incl. N=3.1M K=32, K=0 and "
        f"K=70, at 6 of them again with padding scattered in any slot, and "
        f"on blocks of the N=3.1M rows from row0={half}")
    # the dense kernels' edges: Q across the 128-query tile, N off the
    # 128-row tile, D off the MMA depth (8 floats, 32 codes) and the exact
    # split's limit (D <= 8), k across the lists of one, two and three
    # registers a lane (32, 64, 96) and those in shared memory (80)
    topk_err = topk_ratio = 0.0
    topk_cases = [(1, 1, 4, 1, False), (7, 513, 16, 5, True),
                  (33, 1000, 37, 8, False), (3, 5, 8, 9, True),
                  (1, 129, 2048, 3, True), (5, 40, 8, 60, False),
                  (3, 33, 16, 32, False), (9, 1000, 24, 100, True),
                  (128, 4096, 128, 32, False), (1, 300, 64, 1, False),
                  (127, 1000, 64, 32, True), (129, 777, 64, 33, False),
                  (257, 300, 16, 80, True), (130, 1000, 64, 100, False),
                  (129, 777, 37, 1, False), (33, 300, 2050, 10, True),
                  (129, 1000, 64, 90, False), (64, 129, 2048, 3, True)]
    for q, n, d, k, neg in topk_cases:
        qs, cs = topk_inputs(q, n, d, seed=q * n + d, negative=neg,
                             device=dev)
        err, ratio = check_topk(qs, cs, k)
        topk_err, topk_ratio = max(topk_err, err), max(topk_ratio, ratio)
    for d in (64, 2048):            # rows of magnitudes 2**-20..2**20:
        qs, cs = topk_inputs(130, 1000, d, seed=d, negative=False,
                             device=dev, wide=True)
        topk_ratio = max(topk_ratio, check_topk(qs, cs, 10)[1])  # ratio only
        for tiny in ("queries", "corpus"):      # rows near 2**-120
            qs, cs = topk_inputs(130, 1000, d, seed=d + len(tiny),
                                 negative=False, device=dev, tiny=tiny)
            topk_ratio = max(topk_ratio, check_topk(qs, cs, 10)[1])
    tq, tc = topk_inputs(128, 524_288, 2048, seed=11, negative=False,
                         device=dev)
    for k in (3, 10):
        err, ratio = check_topk(tq, tc, k)
        topk_err, topk_ratio = max(topk_err, err), max(topk_ratio, ratio)
    # the serving tick's shape (phase 15): a full bucket over a tenant
    sq, sc = topk_inputs(SERVE_BATCH, SERVE_DOCS, SERVE_DIM, seed=17,
                         negative=False, device=dev)
    err, ratio = check_topk(sq, sc, SERVE_KMAX)
    topk_err, topk_ratio = max(topk_err, err), max(topk_ratio, ratio)
    log(f"    topk_scores: within the summation bound at "
        f"{len(topk_cases) + 9} shapes incl. two of magnitudes 2**-20..2**20, "
        f"four with one operand's rows near 2**-120 (D=64, 2048), "
        f"Q=128 N=524288 D=2048 k=3,10 and the serving tick's Q={SERVE_BATCH} "
        f"N={SERVE_DOCS} D={SERVE_DIM} k={SERVE_KMAX}; max |err| "
        f"{topk_err:.3e} (unit magnitudes), at most {topk_ratio:.3f} of the "
        f"bound")
    int8_cases = [(1, 1, 4, 1, False), (7, 513, 16, 5, True),
                  (33, 1000, 37, 8, False), (3, 5, 20, 9, True),
                  (5, 40, 8, 60, False), (9, 1000, 64, 100, True),
                  (128, 4096, 128, 40, False), (1, 777, 2047, 80, False),
                  (127, 1000, 20, 32, True), (129, 300, 64, 33, False),
                  (257, 2000, 128, 80, True), (130, 777, 48, 1, False),
                  (3, 1000, 2047, 100, False), (129, 1000, 64, 90, True)]
    for q, n, d, k, neg in int8_cases:
        check_topk_int8(*int8_inputs(q, n, d, seed=q * n + d, negative=neg,
                                     device=dev), k)
    iq, ic = int8_inputs(128, 524_288, 2048, seed=13, negative=False,
                         device=dev)
    for k in (10, 20, 40, 80):
        check_topk_int8(iq, ic, k)
    log(f"    topk_scores_int8: scores and ids equal at "
        f"{len(int8_cases) + 4} shapes incl. Q=128 N=524288 D=2048 "
        f"k=10,20,40,80")
    gath_err = 0.0
    for q, c, d, r, k in [(1, 1, 4, 1, 1), (3, 5, 8, 4, 9),
                          (7, 300, 37, 50, 5), (16, 1000, 64, 200, 32),
                          (5, 2000, 16, 100, 64), (4, 700, 128, 90, 100),
                          (2, 40, 2048, 40, 3), (33, 5000, 24, 3000, 10)]:
        gq, gt, gr, gi = gathered_inputs(q, c, d, r, seed=q * c + d,
                                         device=dev)
        gath_err = max(gath_err, check_gathered(gq, gt, gr, gi, k, gt))
    for kind in ("no_runs", "repeats", "straddle", "crowded"):
        for d, k in ((5, 3), (64, 10), (128, 40)):
            gq, gt, gr, gi = piece_inputs(kind, d, seed=d + k, device=dev)
            gath_err = max(gath_err, check_gathered(gq, gt, gr, gi, k, gt))
    t0 = time.perf_counter()
    corpus, (ev_np, qv_np) = eval_corpus(EVAL_QUERIES, 2048)
    ev = torch.from_numpy(ev_np).to(dev)
    pq = torch.from_numpy(qv_np[:PROBE_QUERIES]).to(dev)
    # a grid search's inputs, timed in 4.: the evaluation grid draws its
    # uniform sample from this corpus with these settings
    from repro_torch.core import SamplerSession, SamplerSpec
    from repro_torch.eval.plans import GridSpec
    spec = GridSpec()
    draw = SamplerSession(
        corpus.qrels, num_queries=corpus.num_queries,
        num_entities=corpus.num_entities, device=dev,
        spec=SamplerSpec(target_size=spec.sample_frac * corpus.num_primary,
                         seed=spec.seed)).draw(strategy="uniform")
    grid_search = (torch.from_numpy(qv_np[:256]).to(dev),
                   ev[draw.entity_mask].contiguous())
    del corpus, qv_np, draw
    ivf_engine, lsh_engine = IVFFlatEngine(), LSHEngine()
    ivf = ivf_engine.build(prng.prng_key(0), ev)
    torch.cuda.synchronize()
    log(f"    ivfflat index of the {tuple(ev.shape)} corpus built in "
        f"{time.perf_counter() - t0:.1f} s (corpus and embedding "
        f"included): {tuple(ivf.vecs.shape)}")
    again = ivf_engine.build(prng.prng_key(0), ev)
    if not (torch.equal(again.centroids, ivf.centroids)
            and torch.equal(again.ids, ivf.ids)):
        fail("ivfflat: two builds of the same index differ on the card")
    del again
    p_rows, p_ids = probe_candidates(ivf, pq, nprobe=ivf_engine.nprobe)
    p_table = ivf.vecs.reshape(-1, ivf.vecs.shape[2])
    for k in (3, 10):
        gath_err = max(gath_err, check_gathered(pq, p_table, p_rows, p_ids,
                                                k, ev))
    # the Table I probe: the encoder's unit-norm 128-wide embeddings of
    # the same corpus (here a random projection of its tf-idf vectors, which
    # keeps their topic clusters), indexed as IVFFlatEngine does, searched
    # a query chunk (256) at a time at k = 3; on the full corpus and on an
    # index of a sample's size
    g = torch.Generator(device="cpu").manual_seed(19)
    proj = torch.randn(ev.shape[1], ENCODER_DIM, generator=g).to(dev)
    e128 = torch.nn.functional.normalize(ev @ proj, dim=1)
    q128 = torch.nn.functional.normalize(pq[:ENCODER_BATCH] @ proj, dim=1)
    kept = torch.randperm(e128.shape[0], generator=g)[:SAMPLE_ROWS]
    t1_probes = []
    for i, tab in enumerate((e128, e128[kept.sort().values.to(dev)])):
        idx = ivf_engine.build(prng.prng_key(0), tab)
        rows_, ids_ = probe_candidates(idx, q128, nprobe=ivf_engine.nprobe)
        table_ = idx.vecs.reshape(-1, ENCODER_DIM)
        gath_err = max(gath_err, check_gathered(q128, table_, rows_, ids_,
                                                3, tab))
        t1_probes.append(f"N={tab.shape[0]} C={ids_.shape[1]}")
        if i == 0:                  # the full corpus's probe, timed in 4.
            t1_probe = (q128, table_, rows_, ids_)
    del proj, e128, q128, kept, idx, table_, rows_, ids_
    log(f"    gathered_topk: within the summation bound at 24 shapes incl. "
        f"pieces of length 1, repeated rows, runs across {TILE_ROWS}-row "
        f"tiles and a tile probed by more than {TILE_PIECES} queries, "
        f"the ivfflat probe Q={PROBE_QUERIES} C={p_ids.shape[1]} "
        f"D={ev.shape[1]} k=3,10 and Table I's Q={ENCODER_BATCH} "
        f"D={ENCODER_DIM} k=3 at {', '.join(t1_probes)}; max |err| "
        f"{gath_err:.3e}")
    ham_cases = [(1, 1, 4, 1), (3, 5, 4, 9), (7, 513, 4, 5),
                 (33, 1000, 4, 32), (40, 4096, 4, 64), (9, 1000, 3, 100),
                 (5, 300, 1, 300), (64, 20000, 4, 10), (2, 129, 8, 33),
                 (1, 300, 4, 300), (33, 300, 1, 301), (31, 1000, 12, 40),
                 (4099, 3000, 4, 64)]
    for q, n, w, k in ham_cases:
        check_hamming(*hamming_inputs(q, n, w, seed=q * n + w, device=dev),
                      k)
    ham_ties = [(1, 300, 4, 300), (33, 300, 1, 64), (5, 300, 3, 301),
                (65, 5000, 8, 64), (31, 1000, 12, 40)]
    for q, n, w, k in ham_ties:
        for kind in ("equal", "few"):
            check_hamming(*hamming_tie_inputs(q, n, w, kind=kind,
                                              seed=q + n + w, device=dev), k)
    hq, hc = hamming_inputs(PROBE_QUERIES, 524_288, 4, seed=17, device=dev)
    for k in (3, 10, 64):
        check_hamming(hq, hc, k)
    lsh = lsh_engine.build(prng.prng_key(0), ev)
    lq = encode(lsh.proj, pq)
    check_hamming(lq, lsh.codes, lsh_engine.rerank)
    log(f"    hamming_topk: scores and ids equal at "
        f"{len(ham_cases) + 2 * len(ham_ties) + 4} shapes incl. W=1,3,8,12, "
        f"k=N and k>N, {2 * len(ham_ties)} where the threshold distance is "
        f"a tie of many rows, Q={PROBE_QUERIES} N=524288 W=4 k=3,10,64 and "
        f"the lsh codes of the corpus, N={lsh.codes.shape[0]} "
        f"k={lsh_engine.rerank}")

    f32, bf16 = torch.float32, torch.bfloat16
    attn_err = 0.0
    attn_bf16_err = 0.0
    modes = [(True, None), (True, 40), (False, None)]
    attn_cases = (
        [((256, 64, 64, 4, 4, 32), f32, False, None),     # passages
         ((256, 24, 24, 4, 4, 32), f32, False, None)]     # queries
        + [(shp, f32, c, w) for shp in [(2, 64, 64, 4, 2, 32),
                                        (1, 128, 128, 8, 8, 64),
                                        (2, 96, 96, 4, 1, 32),
                                        (1, 200, 200, 4, 2, 16)]
           for c, w in modes]                             # reference grid
        + [((3, 1, 1, 2, 1, 16), f32, True, None),        # S = 1
           ((2, 37, 100, 4, 2, 128), f32, False, 30),     # ragged
           ((2, 40, 40, 4, 2, 32), f32, True, 0),         # no allowed key
           ((2, 64, 64, 4, 2, 32), bf16, True, None),
           ((256, 64, 64, 4, 4, 32), bf16, False, None),
           ((1, 2048, 2048, 32, 4, 128), bf16, True, None),   # yi-9b heads
           ((1, 2048, 2048, 32, 4, 128), bf16, True, 512)]
        # both sides of the short-row kernel's limit (Skv <= 128), GQA
        # groups of 1, 2 and 8
        + [((2, skv, skv, 8, 8 // grp, 32), dt, c, w)
           for skv in (1, 63, 64, 65, 127, 128, 129) for grp in (1, 2, 8)
           for c, w in modes for dt in (f32, bf16)]
        # every instance of the short-row kernel: up to 32, 64 and 128
        # keys, 32 and 64 query rows a block (GQA group x Sq <= 32 takes
        # 32), each head width and type
        + [((2, sq, skv, 8, 8 // grp, d), dt, *modes[i % 3])
           for i, (skv, sq, grp) in enumerate(
               [(20, 4, 8), (32, 32, 2), (50, 4, 8), (64, 64, 1),
                (100, 4, 8), (128, 128, 8)])
           for d in (16, 32, 64, 128) for dt in (f32, bf16)])
    with torch.no_grad():
        for i, (shp, dt, causal, window) in enumerate(attn_cases):
            err = check_flash(*attn_inputs(*shp, dtype=dt, seed=100 + i,
                                           device=dev), causal, window)
            if dt == f32:
                attn_err = max(attn_err, err)
            else:
                attn_bf16_err = max(attn_bf16_err, err)
    log(f"    flash_attention: within the stated tolerance at "
        f"{len(attn_cases)} shapes incl. the encoder's B=256 S=64,24 H=4 "
        f"D=32, Skv 1..129 over GQA groups 1, 2, 8, every short-row "
        f"instance (D 16..128, 32 and 64 rows a block) and S=2048 H=32/4 "
        f"D=128 bf16; max |err| f32 {attn_err:.3e}, "
        f"bf16 {attn_bf16_err:.3e}")

    # 4. times -------------------------------------------------------------
    log("[4/19] times (CUDA events, after warm-up)")
    labels, nbr, wgt, deg_sq = lp_main
    n_lp, k_lp = nbr.shape
    lp_ms = cuda_ms(lambda: lp_round_cuda(labels, nbr, wgt), 20)
    lp_plain_ms = cuda_ms(lambda: ell_round(labels, nbr, wgt), 3)
    lp_bound, lp_by = bound(lp_bytes(nbr), 2 * deg_sq)
    qn, d = tq.shape
    n_c = tc.shape[0]
    k_t = 3
    tk_ms = cuda_ms(lambda: topk_scores(tq, tc, k=k_t), 10)
    tk_plain_ms = cuda_ms(lambda: topk_scores_ref(tq, tc, k=k_t), 3)
    tk_lib_ms = cuda_ms(lambda: torch.sort(tq @ tc.T, dim=1, descending=True,
                                           stable=True), 3)
    tk_bound, tk_by = bound((qn + n_c) * d * 4 + qn * k_t * 8,
                            3 * 2.0 * qn * n_c * d, H100_TF32_FLOPS)
    # the merge kernel alone on that corpus's partial lists at the
    # curve's k (4 of the f32 kernel's main-path launches): its lists
    # equal the plain merge's and the whole search's
    k_m = 10
    part_s, part_i = topk_partials_cuda(tq, tc, k_m)
    m_out = launch_merge(part_s, part_i, k_m)
    torch.cuda.synchronize()
    for got, want in zip(m_out, merge_plain(part_s, part_i, k_m)):
        if not torch.equal(got, want):
            fail("topk_merge != its plain version on the dense partials")
    for got, want in zip(m_out, topk_scores(tq, tc, k=k_m)):
        if not torch.equal(got, want):
            fail("topk_merge of the dense partials != topk_scores")
    m_ms = cuda_ms(lambda: launch_merge(part_s, part_i, k_m), 50)
    m_plain_ms = cuda_ms(lambda: merge_plain(part_s, part_i, k_m), 10)
    m_bound, m_by = bound(part_s.numel() * 8 + qn * k_m * 8, part_s.numel())
    m_width = part_s.shape[1]
    del part_s, part_i, m_out
    k_i = 40
    i8_ms = cuda_ms(lambda: topk_scores_int8(iq, ic, k=k_i), 10)
    i8_plain_ms = cuda_ms(lambda: topk_scores_int8_ref(iq, ic, k=k_i), 3)
    i8_lib_ms = cuda_ms(lambda: torch.sort(
        torch._int_mm(iq, ic.T).to(torch.float32), dim=1, descending=True,
        stable=True), 3)
    i8_bound, i8_by = bound((qn + n_c) * d + qn * k_i * 8,
                            2.0 * qn * n_c * d, H100_INT8_OPS)
    log(f"    lp_round N={n_lp} K={k_lp}: kernel {lp_ms:.4f} ms, plain "
        f"{lp_plain_ms:.4f} ms, bound {lp_bound:.4f} ms ({lp_by})")
    log(f"    topk_scores Q={qn} N={n_c} D={d} k={k_t}: kernel {tk_ms:.4f} "
        f"ms, plain {tk_plain_ms:.4f} ms, matmul+stable sort "
        f"{tk_lib_ms:.4f} ms, bound {tk_bound:.4f} ms ({tk_by})")
    log(f"    topk_merge of that corpus's partial lists at k={k_m} (Q={qn}, "
        f"{m_width} entries a row): kernel {m_ms:.4f} ms, plain (two "
        f"stable sorts) {m_plain_ms:.4f} ms, no library call, bound "
        f"{m_bound:.4f} ms ({m_by}); lists equal to the plain merge's and "
        f"to topk_scores'")
    # and at a grid search's shape (24 of its main-path launches): a query
    # chunk of 256 over the rows of the evaluation grid's uniform sample
    gq, gr = grid_search
    k_s = 10
    gs_ms = cuda_ms(lambda: topk_scores(gq, gr, k=k_s), 20)
    gs_plain_ms = cuda_ms(lambda: topk_scores_ref(gq, gr, k=k_s), 5)
    gs_lib_ms = cuda_ms(lambda: torch.sort(gq @ gr.T, dim=1, descending=True,
                                           stable=True), 5)
    gs_bound, gs_by = bound((gq.shape[0] + gr.shape[0]) * d * 4
                            + gq.shape[0] * k_s * 8,
                            3 * 2.0 * gq.shape[0] * gr.shape[0] * d,
                            H100_TF32_FLOPS)
    log(f"    topk_scores at a grid search Q={gq.shape[0]} N={gr.shape[0]} "
        f"D={d} k={k_s}: kernel {gs_ms:.4f} ms, plain {gs_plain_ms:.4f} ms, "
        f"matmul+stable sort {gs_lib_ms:.4f} ms, bound {gs_bound:.4f} ms "
        f"({gs_by})")
    del grid_search, gq, gr
    # and at the serving tick's shape (phase 15's exact ticks): a full
    # bucket of 32 queries over a tenant's corpus at k_max; the kernel's
    # 128-query block pads it, so this is where that waste shows
    sv_n = SERVE_BATCH, SERVE_DOCS, SERVE_DIM
    sv_ms = cuda_ms(lambda: topk_scores(sq, sc, k=SERVE_KMAX), 20)
    sv_plain_ms = cuda_ms(lambda: topk_scores_ref(sq, sc, k=SERVE_KMAX), 5)
    sv_lib_ms = cuda_ms(lambda: torch.sort(sq @ sc.T, dim=1, descending=True,
                                           stable=True), 5)
    sv_bytes = (sv_n[0] + sv_n[1]) * sv_n[2] * 4 + sv_n[0] * SERVE_KMAX * 8
    sv_ops = 3 * 2.0 * sv_n[0] * sv_n[1] * sv_n[2]
    sv_bound, sv_by = bound(sv_bytes, sv_ops, H100_TF32_FLOPS)
    sv_terms = tuning.roofline(sv_bytes, sv_ops, H100_TF32_FLOPS)
    log(f"    topk_scores at the serving tick Q={sv_n[0]} N={sv_n[1]} "
        f"D={sv_n[2]} k={SERVE_KMAX}: kernel {sv_ms:.4f} ms, plain "
        f"{sv_plain_ms:.4f} ms, matmul+stable sort {sv_lib_ms:.4f} ms, "
        f"bound {sv_bound:.4f} ms ({sv_by}; bytes term "
        f"{sv_terms['memory_ms']:.4f}, operations term "
        f"{sv_terms['compute_ms']:.4f} ms)")
    del sq, sc
    log(f"    topk_scores_int8 Q={qn} N={n_c} D={d} k={k_i}: kernel "
        f"{i8_ms:.4f} ms, plain {i8_plain_ms:.4f} ms, _int_mm+stable sort "
        f"{i8_lib_ms:.4f} ms, bound {i8_bound:.4f} ms ({i8_by})")
    # gathered, at the ivfflat probe of the main path (k = 10): the bound
    # counts the valid slots only, each distinct probed list read once
    k_g = 10
    g_ms = cuda_ms(lambda: gathered_topk(pq, p_table, p_rows, p_ids, k=k_g),
                   5)
    g_plain_ms = cuda_ms(lambda: gathered_topk_ref(pq, p_table, p_rows,
                                                   p_ids, k=k_g), 1, 1)
    lib_chunk = 2          # queries per bmm: 2 x C x D f32 = 2.1 GB

    def gathered_library():
        for q0 in range(0, pq.shape[0], lib_chunk):
            cand = p_table[p_rows[q0:q0 + lib_chunk].long()]
            sc = torch.bmm(cand, pq[q0:q0 + lib_chunk, :, None])[..., 0]
            sc = torch.where(p_ids[q0:q0 + lib_chunk] >= 0, sc, -torch.inf)
            torch.sort(sc, dim=1, descending=True, stable=True)

    g_lib_ms = cuda_ms(gathered_library, 1, 1)

    def gathered_bound(qs, rows, ids, k):
        valid = ids >= 0
        c_valid = int(valid.sum())
        probed = int(torch.unique(rows[valid]).numel())
        width = qs.shape[1]
        return (c_valid, probed) + bound(
            probed * width * 4 + qs.numel() * 4 + c_valid * 8
            + qs.shape[0] * k * 8, 3 * 2.0 * c_valid * width,
            H100_TF32_FLOPS)

    c_valid, probed_rows, g_bound, g_by = gathered_bound(pq, p_rows, p_ids,
                                                         k_g)
    log(f"    gathered_topk Q={pq.shape[0]} C={p_ids.shape[1]} "
        f"(valid {c_valid}, distinct probed rows {probed_rows}) D={d} "
        f"k={k_g}: kernel {g_ms:.4f} ms, plain {g_plain_ms:.4f} ms, "
        f"gather+bmm+stable sort by {lib_chunk} queries {g_lib_ms:.4f} ms, "
        f"bound {g_bound:.4f} ms ({g_by})")
    # and at Table I's own probe (24 of the kernel's main-path launches):
    # 256 queries, D 128, k 3, over the 524,700-row index
    tq1, tt1, tr1, ti1 = t1_probe
    t1_ms = cuda_ms(lambda: gathered_topk(tq1, tt1, tr1, ti1, k=3), 10)
    t1_plain_ms = cuda_ms(lambda: gathered_topk_ref(tq1, tt1, tr1, ti1,
                                                    k=3), 2, 1)

    def gathered_library_t1():
        for q0 in range(0, tq1.shape[0], 16):   # 16 x C x 128 f32: 1.1 GB
            cand = tt1[tr1[q0:q0 + 16].long()]
            sc = torch.bmm(cand, tq1[q0:q0 + 16, :, None])[..., 0]
            sc = torch.where(ti1[q0:q0 + 16] >= 0, sc, -torch.inf)
            torch.sort(sc, dim=1, descending=True, stable=True)

    t1_lib_ms = cuda_ms(gathered_library_t1, 2, 1)
    t1_valid, t1_probed, t1_bound, t1_by = gathered_bound(tq1, tr1, ti1, 3)
    log(f"    gathered_topk at Table I's probe Q={tq1.shape[0]} "
        f"C={ti1.shape[1]} (valid {t1_valid}, distinct probed rows "
        f"{t1_probed}) D={tq1.shape[1]} k=3: kernel {t1_ms:.4f} ms, plain "
        f"{t1_plain_ms:.4f} ms, gather+bmm+stable sort by 16 queries "
        f"{t1_lib_ms:.4f} ms, bound {t1_bound:.4f} ms ({t1_by})")
    del t1_probe, tq1, tt1, tr1, ti1
    # Hamming at the lsh rerank pool of the main path (k = 64): W 32-bit
    # popcounts a (query, row) pair, at the rate the card issues them
    # (measured here: tools/mma_rate.popc_rate), or the codes' bytes; no
    # single PyTorch call computes a popcount
    import mma_rate
    popc_per_s, popc_ms = mma_rate.popc_rate()
    log(f"    popc rate (tools/mma_rate.py, 64 warps an SM): "
        f"{popc_per_s / 1e9:.1f} Gpopc/s ({popc_ms:.4f} ms)")
    k_h = lsh_engine.rerank
    hn, hw = hc.shape

    def hamming_bound(nq, n, w, k):
        return bound((nq + n) * w * 4 + nq * k * 8, float(nq) * n * w,
                     popc_per_s)

    h_ms = cuda_ms(lambda: hamming_topk(hq, hc, k=k_h), 10)
    h_plain_ms = cuda_ms(lambda: hamming_topk_ref(hq, hc, k=k_h), 2)
    h_bound, h_by = hamming_bound(hq.shape[0], hn, hw, k_h)
    log(f"    hamming_topk Q={hq.shape[0]} N={hn} W={hw} k={k_h}: kernel "
        f"{h_ms:.4f} ms, plain {h_plain_ms:.4f} ms, no library call, "
        f"bound {h_bound:.4f} ms ({h_by})")
    h10_ms = cuda_ms(lambda: hamming_topk(hq, hc, k=10), 10)
    log(f"    hamming_topk at k=10, the same codes: kernel {h10_ms:.4f} ms, "
        f"bound {hamming_bound(hq.shape[0], hn, hw, 10)[0]:.4f} ms")
    # its three kernels' device time a call (the profiler's mean a launch)
    ham_prof = device_profile(lambda: [hamming_topk(hq, hc, k=k_h)
                                       for _ in range(10)])[2]
    kname = re.compile(r"hamming_\w+(<\w+>)?")
    log("    hamming_topk's kernels at k=64, profiler device time a launch: "
        + ("; ".join(f"{kname.search(name)[0]} {sec / n * 1e3:.4f} ms"
                     for name, (n, sec) in sorted(ham_prof.items())
                     if kname.search(name)) or "not measured"))
    # flash attention at the encoder's passage batch (the main path's
    # shape): bytes of q, k, v and o once each; 4 * B * H * Sq * Skv * D
    # operations (two products), every pair allowed (bidirectional), f32
    # products counted as three TF32 products at the tensor cores' rate
    aq, ak, av = attn_inputs(ENCODER_BATCH, 64, 64, 4, 4, 32, dtype=f32,
                             seed=7, device=dev)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    with torch.no_grad():
        a_ms = cuda_ms(lambda: flash_attention(aq, ak, av, causal=False),
                       50, 5)
        a_plain_ms = cuda_ms(lambda: flash_attention_ref(aq, ak, av,
                                                         causal=False), 20)
        a_lib_ms = cuda_ms(lambda: sdpa(aq.transpose(1, 2),
                                        ak.transpose(1, 2),
                                        av.transpose(1, 2)), 50, 5)
    ab, asq, ah, ad = aq.shape
    a_bound, a_by = bound(4 * aq.numel() * 4,
                          3 * 4.0 * ab * ah * asq * asq * ad, H100_TF32_FLOPS)
    log(f"    flash_attention B={ab} S={asq} H={ah} D={ad} f32 "
        f"bidirectional: kernel {a_ms:.4f} ms, plain {a_plain_ms:.4f} ms, "
        f"scaled_dot_product_attention {a_lib_ms:.4f} ms, bound "
        f"{a_bound:.4f} ms ({a_by})")
    # the same 50 calls each under the profiler: device time a launch,
    # which the event times above include only where the card, not the
    # host's work around each call, sets the pace

    def device_ms(fn, n=50):
        fn()
        return call_device_ms(device_profile(
            lambda: [fn() for _ in range(n)])[2], n)

    with torch.no_grad():
        a_dev = device_ms(lambda: flash_attention(aq, ak, av, causal=False))
        a_lib_dev = device_ms(lambda: sdpa(aq.transpose(1, 2),
                                           ak.transpose(1, 2),
                                           av.transpose(1, 2)))
    fmt = lambda x: "not measured" if x is None else f"{x:.4f} ms"
    log(f"    flash_attention at the same shape, profiler device time a "
        f"call: kernel {fmt(a_dev)}, scaled_dot_product_attention "
        f"{fmt(a_lib_dev)}")
    yq, yk, yv = attn_inputs(1, 2048, 2048, 32, 4, 128, dtype=bf16, seed=8,
                             device=dev)
    with torch.no_grad():
        l_ms = cuda_ms(lambda: flash_attention(yq, yk, yv, causal=True), 10)
        l_plain_ms = cuda_ms(lambda: flash_attention_ref(yq, yk, yv,
                                                         causal=True), 3)
        l_lib_ms = cuda_ms(lambda: sdpa(
            yq.transpose(1, 2), yk.transpose(1, 2), yv.transpose(1, 2),
            is_causal=True, enable_gqa=True), 10)
    pairs = 2048 * 2049 // 2
    l_bound, l_by = bound(2 * (2 * yq.numel() + 2 * yk.numel()),
                          4.0 * 32 * pairs * 128, H100_BF16_FLOPS)
    log(f"    flash_attention S=2048 H=32/4 D=128 bf16 causal (not on the "
        f"main path): kernel {l_ms:.4f} ms, plain {l_plain_ms:.4f} ms, "
        f"scaled_dot_product_attention {l_lib_ms:.4f} ms, bound "
        f"{l_bound:.4f} ms ({l_by})")
    del aq, ak, av, yq, yk, yv
    del lp_main, labels, nbr, wgt, tq, tc, iq, ic, ev, pq, ivf, p_rows
    del p_ids, p_table, lsh, lq, hq, hc
    torch.cuda.empty_cache()
    check_untuned("phases 3-4", untuned_hits)

    # 5. sampling main path ------------------------------------------------
    os.makedirs(OUT, exist_ok=True)
    reset_counts(kernels)
    sample_trace = os.path.join(OUT, "sample_trace.jsonl")
    eval_trace = os.path.join(OUT, "eval_trace.jsonl")
    for path in (sample_trace, eval_trace):
        if os.path.exists(path):
            os.remove(path)
    from repro_torch.kernels.label_prop import ops as lp_ops
    from repro_torch.launch import sample as sample_cli
    sample_argv = ["--queries", str(SAMPLE_QUERIES), "--qrels-per-query",
                   "32", "--topics", "96", "--aux-fraction", "2.0",
                   "--engine", "cuda", "--device", "cuda"]
    reset_memory()
    with Capture(lp_ops, "lp_round_cuda",
                 lambda labels, nbr, wgt, row0=0: tuple(nbr.shape)) \
            as lp_seen, \
            Capture(sample_cli, "generate_corpus",
                    lambda **kw: "corpus") as corpus_seen, \
            recompile.region("phase 5"):
        stats, wall = run_sample(sample_argv + [
            "--out", os.path.join(OUT, "sample"), "--trace", sample_trace])
    sample_corpus = corpus_seen.results["corpus"]
    sample_stats, sample_wall = stats, wall
    del corpus_seen
    log(f"[5/19] sampling: {wall:.2f} s wall, {stats['edges']} edges, "
        f"{stats['communities']} communities, changes/round "
        f"{stats['changes_per_round']}, {stats['entities']} entities "
        f"sampled")
    sample_launches = read_counts(kernels, "sampling", main_shapes)
    log_trace(sample_trace, wall)
    check_no_build("phase 5")
    check_untuned("phase 5", untuned_hits)
    # the ELL table the LP rounds ran on: its degree law, and lp_round on it
    (s_labels, s_nbr, s_wgt, _), _ = next(iter(lp_seen.calls.values()))
    s_deg = (s_nbr >= 0).sum(dim=1)
    hist = torch.bincount(s_deg, minlength=s_nbr.shape[1] + 1).tolist()
    log(f"    sampling ELL N={s_nbr.shape[0]} K={s_nbr.shape[1]}: nodes by "
        f"degree {hist}; mean degree {float(s_deg.float().mean()):.3f}, "
        f"degree <= 8: {float((s_deg <= 8).float().mean()):.3f} of nodes, "
        f"<= 16: {float((s_deg <= 16).float().mean()):.3f}")
    s_lp_ms = cuda_ms(lambda: lp_round_cuda(s_labels, s_nbr, s_wgt), 20)
    s_lp_bound, s_lp_by = bound(lp_bytes(s_nbr),
                                2.0 * float((s_deg.double() ** 2).sum()))
    log(f"    lp_round on the sampling run's ELL: kernel {s_lp_ms:.4f} ms, "
        f"bound {s_lp_bound:.4f} ms ({s_lp_by})")
    del lp_seen, s_labels, s_nbr, s_wgt, s_deg
    if sample_launches["lp_round"] == 0:
        fail("the sampling run launched no lp_round kernel")
    if sample_launches["lp_round"] != len(stats["changes_per_round"]):
        fail("lp_round launches != LP rounds on the sampling path")
    saved = np.load(os.path.join(OUT, "sample", "sample.npz"))
    if saved["labels"].min() < 0 or not saved["entity_mask"].any():
        fail("sample.npz has negative labels or an empty sample")

    # 6. evaluation main path ----------------------------------------------
    reset_counts(kernels)
    from repro_torch.kernels.lsh_hamming import ops as ham_ops
    eval_argv = ["--grid", "default", "--backend", "cuda", "--device",
                 "cuda", "--queries", str(EVAL_QUERIES)]
    reset_memory()
    with Capture(ham_ops, "hamming_topk_cuda",
                 lambda q, c, k, *blocks: (tuple(q.shape), tuple(c.shape),
                                           k)) as ham_seen, \
            recompile.region("phase 6"):
        out, wall = run_evaluate(eval_argv + [
            "--json", os.path.join(OUT, "eval.json"), "--trace", eval_trace])
    cells = out["grid"]["cells"]
    eval_out, eval_wall = out, wall
    log(f"[6/19] evaluation: {wall:.2f} s wall, {len(cells)} cells")
    eval_launches = read_counts(kernels, "evaluation", main_shapes)
    trace.disable()
    # the Hamming kernel at each shape the grid launched it at
    for (qshape, cshape, k), (args, _) in sorted(ham_seen.calls.items()):
        ms = cuda_ms(lambda: ham_ops.hamming_topk_cuda(*args), 20)
        log(f"    hamming_topk at the grid's Q={qshape[0]} N={cshape[0]} "
            f"W={cshape[1]} k={k}: kernel {ms:.4f} ms, bound "
            f"{hamming_bound(qshape[0], cshape[0], cshape[1], k)[0]:.4f} ms")
    del ham_seen
    log_trace(eval_trace, wall)
    check_no_build("phase 6")
    check_untuned("phase 6", untuned_hits)
    log(f"    fidelity: {json.dumps(out['fidelity']['mean_abs_delta'])}")
    log(f"    winners: {json.dumps(out['fidelity']['winners'])}")
    log(f"    backend curve: {json.dumps(out['backend_curve'])}")
    for kname in ("gathered_tiles", "hamming_topk", "topk_partial",
                  "topk_int8_partial", "topk_merge", "lp_round"):
        if eval_launches[kname] == 0:
            fail(f"the evaluation run launched no {kname} kernel")
    curve = [(r["backend"], r["rerank_factor"]) for r in out["backend_curve"]]
    if curve != [("cuda", None), ("int8", 1), ("int8", 2), ("int8", 4),
                 ("int8", 8), ("torch", None)]:
        fail(f"backend curve rows {curve}")
    if not all(0.0 <= r["recall_at_k"] <= 1.0 for r in out["backend_curve"]):
        fail("backend curve recall outside [0, 1]")
    if not all(np.isfinite(c["value"]) for c in cells) or len(cells) != 96:
        fail("evaluation cells are not 96 finite values")
    if {c["engine"] for c in cells} != {"exact", "ivfflat", "lsh", "tfidf"}:
        fail("the evaluation grid does not cover the four engines")

    # 7. Table I main path ------------------------------------------------
    from repro_torch.retrieval.experiment import run_table1_experiment
    t0 = time.perf_counter()
    t1_corpus = eval_corpus(EVAL_QUERIES, 2048, embed=False)
    log(f"[7/19] Table I corpus: {t1_corpus.num_entities} entities, "
        f"{t1_corpus.num_queries} queries, passages "
        f"{t1_corpus.passage_tokens.shape[1]} tokens, queries "
        f"{t1_corpus.query_tokens.shape[1]}, vocab {t1_corpus.vocab_size} "
        f"({time.perf_counter() - t0:.1f} s)")
    table1_trace = os.path.join(OUT, "table1_trace.jsonl")
    if os.path.exists(table1_trace):
        os.remove(table1_trace)
    trace.enable(table1_trace)
    reset_counts(kernels)
    reset_memory()
    t0 = time.perf_counter()
    with recompile.region("phase 7"):
        rows = run_table1_experiment(t1_corpus, encoder_steps=300, seed=0,
                                     device="cuda")
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    trace.disable()
    log(f"    Table I: {wall:.2f} s wall")
    t1_launches = read_counts(kernels, "Table I", main_shapes)
    log_trace(table1_trace, wall)
    check_no_build("phase 7")
    check_untuned("phase 7", untuned_hits)
    for r in rows.values():
        log(f"    {r.name:10s} p@3 {r.p_at_3:.4f} rho_q {r.rho_q:.4f} "
            f"entities {r.n_entities} queries {r.n_queries}")
    n_batches = (-(-t1_corpus.num_entities // ENCODER_BATCH)
                 - (-t1_corpus.num_queries // ENCODER_BATCH))
    want_flash = ENCODER_LAYERS * n_batches
    if t1_launches["flash_attention"] != want_flash:
        fail(f"Table I launched flash_attention "
             f"{t1_launches['flash_attention']} times, expected "
             f"{ENCODER_LAYERS} layers x {n_batches} batches = {want_flash}")
    for kname in ("lp_round", "gathered_tiles"):
        if t1_launches[kname] == 0:
            fail(f"the Table I run launched no {kname} kernel")
    if list(rows) != ["full", "uniform", "windtunnel"]:
        fail(f"Table I rows {list(rows)}")
    for r in rows.values():
        if not (0.0 <= r.p_at_3 <= 1.0 and 0.0 <= r.rho_q <= 1.0
                and r.n_queries > 0 and r.n_entities > 0):
            fail(f"Table I row {r}")
    if rows["full"].n_entities != t1_corpus.num_entities or \
            rows["full"].rho_q != 1.0:
        fail(f"Table I full row {rows['full']}: the full corpus keeps "
             f"every entity, so rho_q is 1")
    if rows["windtunnel"].n_entities >= t1_corpus.num_primary:
        fail("Table I: the WindTunnel sample is not a sample")
    # where the time of the two encoder stages goes on the device: 20
    # steps of training, and 20 batches of passages embedded (the flash
    # kernel's per-launch device time at the main path's passage shape)
    from repro_torch.core import prng as tprng
    from repro_torch.retrieval.encoder import (EncoderConfig, embed_corpus,
                                               init_encoder)
    from repro_torch.retrieval.experiment import train_encoder
    enc_cfg = EncoderConfig(vocab_size=t1_corpus.vocab_size)
    enc_params = init_encoder(tprng.prng_key(0), enc_cfg)
    toks = t1_corpus.passage_tokens[:20 * ENCODER_BATCH]
    embed_corpus(enc_params, toks, enc_cfg)             # warm-up
    log_profile("train_encoder, 20 steps", device_profile(
        lambda: train_encoder(t1_corpus, enc_cfg, steps=20, log_every=0)))
    prof = device_profile(lambda: embed_corpus(enc_params, toks, enc_cfg))
    log_profile(f"embed_corpus, 20 batches of {ENCODER_BATCH}", prof)
    flash_dev = [(n, sec) for k, (n, sec) in prof[2].items()
                 if "flash_short" in k]
    if flash_dev:
        n, sec = flash_dev[0]
        log(f"    flash_attention at the main path's passage shape "
            f"(this window): {n} launches, {sec / n * 1e3:.4f} ms of device "
            f"time each")
    del t1_corpus, enc_params, toks

    # 8. small inputs: card vs the CPU's plain path --------------------------
    with tempfile.TemporaryDirectory(dir=OUT) as tmp:
        small = ["--queries", "512", "--qrels-per-query", "8",
                 "--topics", "16", "--quiet"]
        run_sample(small + ["--device", "cuda", "--engine", "cuda",
                            "--out", os.path.join(tmp, "gpu")])
        run_sample(small + ["--device", "cpu", "--engine", "ell",
                            "--out", os.path.join(tmp, "cpu")])
        a = np.load(os.path.join(tmp, "gpu", "sample.npz"))
        b = np.load(os.path.join(tmp, "cpu", "sample.npz"))
        for key in ("entity_mask", "labels"):
            if not np.array_equal(a[key], b[key]):
                fail(f"small sample: {key} differs between cuda and cpu")
    # the grid on both devices with one LP engine family (ell's degree cap
    # is the kernel's), so the two sides compute the same function
    from repro_torch.data.synthetic import generate_corpus
    from repro_torch.eval import (build_fidelity_report, run_grid,
                                  tfidf_embedder)
    from repro_torch.launch.evaluate import GRIDS
    corpus = generate_corpus(num_queries=512, qrels_per_query=16,
                             num_topics=48, aux_fraction=1.0, vocab_size=256,
                             query_len=24, seed=0)
    # prng.normal, the lsh projection's draw, reproduces XLA's f32 log1p
    # and erf_inv op by op: equal bit for bit on both devices
    for seed, shape in ((0, (2048, 128)), (3, (1_000_003,))):
        got = prng.normal(prng.prng_key(seed), shape, "cuda").cpu()
        want = prng.normal(prng.prng_key(seed), shape, "cpu")
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            fail(f"prng.normal{shape}: cuda and cpu differ in "
                 f"{int((got != want).sum())} values")
    log("    prng.normal: 2048 x 128 and 1,000,003 draws equal bit for bit "
        "on cuda and cpu")
    # the default grid's ANN indexes: the ivfflat centroids start from
    # cuBLAS vs CPU products, so they agree within a stated rtol; the lsh
    # projection is prng.normal, equal; then the cells
    ev_small = torch.from_numpy(tfidf_embedder(corpus)[0])
    built = {}
    for where in ("cuda", "cpu"):
        vecs = ev_small.to(where)
        built[where] = (IVFFlatEngine().build(prng.prng_key(0), vecs),
                        LSHEngine().build(prng.prng_key(0), vecs))
    (ivf_g, lsh_g), (ivf_c, lsh_c) = built["cuda"], built["cpu"]
    cent_diff = (ivf_g.centroids.cpu() - ivf_c.centroids).abs()
    if not torch.allclose(ivf_g.centroids.cpu(), ivf_c.centroids,
                          rtol=INDEX_RTOL, atol=0.0):
        fail(f"small index: ivfflat centroids differ beyond rtol "
             f"{INDEX_RTOL} between cuda and cpu (max |diff| "
             f"{float(cent_diff.max()):.3e})")
    if not torch.equal(lsh_g.proj.cpu(), lsh_c.proj):
        fail("small index: the lsh projection differs between cuda and cpu")
    same_lists = torch.equal(ivf_g.ids.cpu(), ivf_c.ids)
    same_codes = torch.equal(lsh_g.codes.cpu(), lsh_c.codes)
    log(f"    small index ({tuple(ev_small.shape)}): centroids within "
        f"rtol {INDEX_RTOL}, projection equal; ivfflat lists "
        f"{'equal' if same_lists else 'DIFFER'}, lsh codes "
        f"{'equal' if same_codes else 'DIFFER'} on cuda and cpu")
    for grid in ("smoke", "default"):
        spec = GRIDS[grid]
        grids = {}
        for where, engine in (("cuda", "cuda"), ("cpu", "ell")):
            res = run_grid(corpus, spec, device=where,
                           sampler=SamplerSpec(engine=engine))
            grids[where] = (res.cells, build_fidelity_report(
                res.cells, spec).to_json())
        if grids["cuda"][0] != grids["cpu"][0]:
            for cell, v in sorted(grids["cuda"][0].items()):
                if grids["cpu"][0][cell] != v:
                    log(f"    {grid} cell {cell}: cuda {v!r} cpu "
                        f"{grids['cpu'][0][cell]!r}")
            fail(f"small evaluation: {grid} grid cells differ between cuda "
                 f"and cpu")
        if grids["cuda"][1] != grids["cpu"][1]:
            fail(f"small evaluation: {grid} fidelity report differs between "
                 f"cuda and cpu")
        log(f"    {grid} grid: {len(grids['cuda'][0])} cells and the "
            f"fidelity report equal on cuda and cpu")
    # the encoder: 5 training steps, embeddings of the same parameters and
    # evaluate_sample on the same embeddings, card vs CPU
    import dataclasses
    from repro_torch.core import SamplerSession
    from repro_torch.retrieval.encoder import EncoderConfig, embed_corpus
    from repro_torch.retrieval.experiment import (evaluate_sample,
                                                  train_encoder)
    small = generate_corpus(num_queries=256, qrels_per_query=8,
                            num_topics=16, aux_fraction=1.0, vocab_size=256,
                            query_len=24, seed=0)
    enc = EncoderConfig(vocab_size=small.vocab_size)
    trained = {where: train_encoder(small, enc, steps=5, seed=0,
                                    log_every=0, device=where)
               for where in ("cuda", "cpu")}
    loss_g = np.array(trained["cuda"][1])
    loss_c = np.array(trained["cpu"][1])
    if not np.allclose(loss_g, loss_c, rtol=LOSS_RTOL, atol=0.0):
        fail(f"small encoder: 5 training steps' losses differ beyond rtol "
             f"{LOSS_RTOL} between cuda {loss_g} and cpu {loss_c}")
    params = trained["cpu"][0]
    vecs = {where: (embed_corpus(params, small.passage_tokens, enc,
                                 device=where),
                    embed_corpus(params, small.query_tokens, enc,
                                 device=where))
            for where in ("cuda", "cpu")}
    rtol, atol = EMBED_TOL
    emb_err = 0.0
    for a, b in zip(vecs["cuda"], vecs["cpu"]):
        if not np.allclose(a, b, rtol=rtol, atol=atol):
            fail(f"small encoder: embeddings of the same parameters differ "
                 f"beyond rtol {rtol} atol {atol} between cuda and cpu "
                 f"(max |diff| {np.abs(a - b).max():.3e})")
        emb_err = max(emb_err, float(np.abs(a - b).max()))
    ev_c, qv_c = vecs["cpu"]
    wt = SamplerSession(small.qrels, num_queries=small.num_queries,
                        num_entities=small.num_entities, device="cpu",
                        spec=SamplerSpec(engine="ell", target_size=150))
    uni = np.random.default_rng(1).random(small.num_entities) < 0.2
    for which, mask in (("full", None), ("uniform", uni),
                        ("windtunnel", wt.draw().entity_mask.numpy())):
        got = {where: dataclasses.asdict(evaluate_sample(
            which, small, ev_c, qv_c, mask, device=where))
            for where in ("cuda", "cpu")}
        if got["cuda"] != got["cpu"]:
            fail(f"small encoder: evaluate_sample({which}) differs: cuda "
                 f"{got['cuda']} cpu {got['cpu']}")
    log(f"    encoder ({small.num_entities} passages, full width): 5 steps' "
        f"losses within rtol {LOSS_RTOL} (max rel diff "
        f"{float(np.abs(loss_g / loss_c - 1).max()):.2e}), embeddings "
        f"within rtol {rtol} atol {atol} (max |diff| {emb_err:.3e}), "
        f"evaluate_sample equal on 3 samples, on cuda and cpu")
    # the serve CLI at the reference's defaults (4096 x 64 a tenant): one
    # query, then a load of 256 requests, on the card and on the CPU
    from repro_torch.launch import serve as serve_cli
    small_serve = {}
    with tempfile.TemporaryDirectory(dir=OUT) as tmp:
        for where in ("cuda", "cpu"):
            outs = [os.path.join(tmp, f"{where}_{run}.json")
                    for run in ("single", "load")]
            for argv, out in ((["--single"], outs[0]), ([], outs[1])):
                if serve_cli.main(argv + ["--device", where, "--quiet",
                                          "--out", out]) != 0:
                    fail(f"small serve CLI {argv} on {where} exited nonzero")
            small_serve[where] = [json.load(open(out)) for out in outs]
    (g_single, g_load), (c_single, c_load) = (small_serve["cuda"],
                                              small_serve["cpu"])
    if g_single["ids"] != c_single["ids"]:
        fail(f"small serve --single: ids {g_single['ids']} on cuda, "
             f"{c_single['ids']} on cpu")
    for key in ("completed", "rejected", "ticks", "mean_batch"):
        if g_load[key] != c_load[key]:
            fail(f"small serve load: {key} {g_load[key]} on cuda, "
                 f"{c_load[key]} on cpu")
    log(f"    serve CLI at its defaults: --single ids {g_single['ids']} on "
        f"both; load of 256: completed {g_load['completed']}, rejected "
        f"{g_load['rejected']}, ticks {g_load['ticks']}, mean batch "
        f"{g_load['mean_batch']} on both")
    log("[8/19] small inputs: sample.npz, grid cells, the encoder's and the "
        "serve CLI's results equal (or within the stated tolerance) on cuda "
        "and cpu")

    # 9. the legacy pipeline at full width -----------------------------------
    # run_windtunnel with a default WindTunnelConfig (engine None: the
    # card's LP kernel) on phase 5's corpus, against a session draw of the
    # same spec; then the uniform baseline once
    from repro_torch.core import (SamplerSession, SamplerSpec,
                                  WindTunnelConfig, run_uniform_baseline,
                                  run_windtunnel, uniform_sample)
    wt_cfg = WindTunnelConfig()
    corpus_kw = dict(num_queries=sample_corpus.num_queries,
                     num_entities=sample_corpus.num_entities)
    reset_counts(kernels)
    t0 = time.perf_counter()
    with recompile.region("phase 9"):
        wt = run_windtunnel(sample_corpus.qrels, config=wt_cfg,
                            device="cuda", **corpus_kw)
        torch.cuda.synchronize()
    wt_wall = time.perf_counter() - t0
    pipe_launches = read_counts(kernels, "run_windtunnel")
    if pipe_launches["lp_round"] != wt_cfg.lp_rounds:
        fail(f"run_windtunnel launched lp_round {pipe_launches['lp_round']} "
             f"times, expected {wt_cfg.lp_rounds} rounds")
    session = SamplerSession(sample_corpus.qrels, device="cuda",
                             spec=SamplerSpec.from_config(wt_cfg),
                             **corpus_kw)
    for what, got, want in (("labels", wt.labels, session.labels()[0]),
                            ("entity_mask", wt.sample.entity_mask,
                             session.draw().entity_mask)):
        if not torch.equal(got, want):
            fail(f"run_windtunnel's {what} differ from the session's in "
                 f"{int((got != want).sum())} entries")
    t0 = time.perf_counter()
    with recompile.region("phase 9"):
        uni = run_uniform_baseline(sample_corpus.qrels, rate=0.15, seed=0,
                                   device="cuda", **corpus_kw)
        torch.cuda.synchronize()
    uni_wall = time.perf_counter() - t0
    if not torch.equal(uni.entity_mask, uniform_sample(
            sample_corpus.num_entities, prng.prng_key(0), rate=0.15,
            device="cuda")):
        fail("run_uniform_baseline's mask != uniform_sample's")
    log(f"[9/19] run_windtunnel (engine {session.spec.engine}, "
        f"{sample_corpus.num_entities} entities): {wt_wall:.2f} s wall, "
        f"{int(wt.sample.entity_mask.sum())} entities sampled; labels and "
        f"entity_mask equal to the session's bit for bit; "
        f"run_uniform_baseline at rate 0.15: {uni_wall:.2f} s wall, "
        f"{int(uni.entity_mask.sum())} entities, "
        f"{int(uni.query_mask.sum())} queries")
    check_no_build("phase 9")
    check_untuned("phase 9", untuned_hits)
    del wt, session, uni

    # 10. autotuner ----------------------------------------------------------
    # tuned for the traffic phases 5-7 launched (each bucket at the calls
    # the main path made in it), the table written under build/chip_smoke
    traffic = tuning.launched_traffic(main_shapes)
    t0 = time.perf_counter()
    tuned_path = os.path.join(OUT, "tuned_kernels_torch.json")
    with recompile.region("phase 10"):
        table = tuning.autotune(["topk", "hamming_topk"], traffic=traffic,
                                buckets=("le65536", "gt65536"), max_evals=4,
                                iters=5, out_path=tuned_path, verbose=False)
    untuned = sorted(f"{kernel} {dt} {bucket}"
                     for kernel, dt in traffic
                     for bucket in ("le65536", "gt65536")
                     if (kernel, bucket, dt) not in table.entries)
    log(f"[10/19] autotune (topk float32/int8, hamming_topk; le65536, "
        f"gt65536) over phases 5-7's launches in "
        f"{time.perf_counter() - t0:.1f} s; {smi}; cells the main path "
        f"never launched, so left untuned: {', '.join(untuned) or 'none'}; "
        f"table {tuned_path}:")
    log(json.dumps(table.to_json()))
    # every split-target candidate against the default at the main path's
    # shapes (inputs made on the card, half the corpus rows repeating the
    # other half: exact ties): equal ids and scores, and each one's time
    g = torch.Generator(device="cuda").manual_seed(23)

    def card_rows(rows, width, dtype):
        if dtype == torch.float32:
            x = torch.randn(rows, width, generator=g, device=dev)
        else:
            lo, hi = ((-127, 128) if dtype == torch.int8
                      else (-2 ** 31, 2 ** 31 - 1))
            x = torch.randint(lo, hi, (rows, width), generator=g, device=dev,
                              dtype=dtype)
        x[rows // 2:] = x[:rows - rows // 2].clone()
        return x

    cand_inputs = [(kernel, dtype, fn, k, card_rows(q, w, dtype),
                    card_rows(524_288, w, dtype))
                   for kernel, dtype, fn, k, q, w in (
                       ("topk", torch.float32, topk_scores, 3, 128, 2048),
                       ("topk", torch.int8, topk_scores_int8, 40, 128, 2048),
                       ("hamming_topk", torch.int32, hamming_topk, 64,
                        PROBE_QUERIES, 4))]
    for kernel, dtype, fn, k, qx, cx in cand_inputs:
        default = tuning.DEFAULTS[kernel]["split_blocks"]
        want = fn(qx, cx, k=k, split_blocks=default)
        times = []
        for cand in tuning.SPACES[kernel].axes["split_blocks"]:
            got = fn(qx, cx, k=k, split_blocks=cand)
            torch.cuda.synchronize()
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                fail(f"{kernel} {dtype}: split target {cand} gives other "
                     f"ids or scores than the default {default}")
            ms = cuda_ms(lambda: fn(qx, cx, k=k, split_blocks=cand), 10)
            times.append(f"{cand}{'*' if cand == default else ''} "
                         f"{ms:.4f} ms")
        log(f"    {kernel} {str(dtype)[6:]} Q={qx.shape[0]} N={cx.shape[0]} "
            f"{'W' if kernel == 'hamming_topk' else 'D'}={qx.shape[1]} k={k}: "
            f"ids and scores equal for every split target; CUDA events "
            f"(* the default): {'; '.join(times)}")
    del cand_inputs, qx, cx, want, got
    # the grid at a size whose full-corpus searches fall in a tuned bucket,
    # with the table active and under --no-tuned-kernels
    grid_argv = ["--grid", "default", "--backend", "cuda", "--device",
                 "cuda", "--queries", str(TUNED_GRID_QUERIES), "--quiet"]
    hits0 = REGISTRY.counter("tuning.resolve.hit").value
    with recompile.region("phase 10"):
        tuned_out, tuned_wall = run_evaluate(grid_argv)
        hits = REGISTRY.counter("tuning.resolve.hit").value - hits0
        plain_out, plain_wall = run_evaluate(grid_argv
                                             + ["--no-tuned-kernels"])
    tuning.set_table(None)
    untuned_hits = REGISTRY.counter("tuning.resolve.hit").value
    if hits == 0:
        fail("the grid with the tuned table active resolved no tuned entry")
    if tuned_out["grid"]["cells"] != plain_out["grid"]["cells"] or \
            tuned_out["fidelity"] != plain_out["fidelity"]:
        fail("the grid's cells differ between the tuned table and "
             "--no-tuned-kernels")
    recall = lambda out: [r["recall_at_k"] for r in out["backend_curve"]]
    if recall(tuned_out) != recall(plain_out):
        fail("the backend curve's recall differs between the tuned table "
             "and --no-tuned-kernels")
    log(f"    grid at {TUNED_GRID_QUERIES} queries: "
        f"{len(tuned_out['grid']['cells'])} cells, the fidelity report and "
        f"the backend curve's recall equal with the tuned table ({hits:.0f} "
        f"tuned resolutions, {tuned_wall:.2f} s wall) and under "
        f"--no-tuned-kernels ({plain_wall:.2f} s wall)")
    check_no_build("phase 10")

    # 11. where the host time goes ----------------------------------------
    # the two CLIs once more at the timed runs' sizes, under cProfile (the
    # timed runs above stay unprofiled)
    log("[11/19] host time: the sampling and evaluation CLIs under cProfile")
    with tempfile.TemporaryDirectory(dir=OUT) as tmp, \
            recompile.region("phase 11"):
        profile_top("sampling", lambda: run_sample(
            sample_argv + ["--quiet", "--out", tmp]))
        profile_top("evaluation", lambda: run_evaluate(
            eval_argv + ["--quiet"]))
    check_no_build("phase 11")
    check_untuned("phase 11", untuned_hits)

    # 12. sharded sampling at full width -------------------------------------
    # the sampling CLI streamed on a 1-rank NCCL mesh, on phase 5's
    # arguments; then the legacy sharded session on phase 5's corpus
    import gc
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.obs import memory
    streamed_trace = os.path.join(OUT, "sample_streamed_trace.jsonl")
    if os.path.exists(streamed_trace):
        os.remove(streamed_trace)
    gc.collect()
    torch.cuda.empty_cache()
    reset_counts(kernels)
    reset_memory()
    with recompile.region("phase 12"):
        sh_stats, sh_wall = run_sample(sample_argv + [
            "--streamed", "--mesh", "host", "--out",
            os.path.join(OUT, "sample_streamed"), "--trace", streamed_trace])
    trace.disable()
    log(f"[12/19] streamed sampling (1-rank NCCL mesh, "
        f"{dist.get_backend()}): {sh_wall:.2f} s wall (phase 5: "
        f"{sample_wall:.2f} s), changes/round "
        f"{sh_stats['changes_per_round']}")
    sh_launches = read_counts(kernels, "streamed sampling")
    log_trace(streamed_trace, sh_wall)
    check_no_build("phase 12")
    check_untuned("phase 12", untuned_hits)
    if REGISTRY.gauge(memory.PEAK_GAUGE).value <= 0:
        fail("phase 12: the sharded stage recorded no "
             f"{memory.PEAK_GAUGE} reading")
    if sh_launches["lp_round"] != len(sh_stats["changes_per_round"]):
        fail("streamed sampling: lp_round launches != LP rounds")
    single_npz = np.load(os.path.join(OUT, "sample", "sample.npz"))
    sharded_npz = np.load(os.path.join(OUT, "sample_streamed", "sample.npz"))
    for key in ("entity_mask", "labels", "qrel_valid"):
        if not np.array_equal(single_npz[key], sharded_npz[key]):
            fail(f"streamed sampling: sample.npz {key} != phase 5's")
    if sh_stats != sample_stats:
        fail(f"streamed sampling: stats {sh_stats} != phase 5's "
             f"{sample_stats}")
    log("    sample.npz (entity_mask, labels, qrel_valid) and stats equal "
        "to phase 5's bit for bit")
    mesh = make_host_mesh(device="cuda")
    reset_counts(kernels)
    reset_memory()
    t0 = time.perf_counter()
    with recompile.region("phase 12"):
        legacy = SamplerSession(
            sample_corpus.qrels, device="cuda",
            spec=SamplerSpec(engine="cuda", sharded=True, mesh=mesh),
            num_queries=sample_corpus.num_queries,
            num_entities=sample_corpus.num_entities)
        leg_labels, leg_changes = legacy.labels()
        torch.cuda.synchronize()
    leg_wall = time.perf_counter() - t0
    leg_launches = read_counts(kernels, "legacy sharded session")
    check_no_build("phase 12")
    check_untuned("phase 12", untuned_hits)
    if leg_launches["lp_round"] != len(sample_stats["changes_per_round"]):
        fail("legacy sharded session: lp_round launches != LP rounds")
    if leg_changes.tolist() != sample_stats["changes_per_round"] or \
            not np.array_equal(leg_labels.cpu().numpy(),
                               single_npz["labels"]):
        fail("legacy sharded session: labels or changes != phase 5's")
    log(f"    legacy sharded SamplerSession (graph + LP, the full table on "
        f"the card) on phase 5's corpus: {leg_wall:.2f} s; labels and "
        f"changes equal to phase 5's; {memory.PEAK_GAUGE} "
        f"{REGISTRY.gauge(memory.PEAK_GAUGE).value:.0f} B, allocator peak "
        f"{torch.cuda.max_memory_allocated()} B")
    del legacy, leg_labels, leg_changes, sample_corpus

    # 13. sharded evaluation at full width -----------------------------------
    streamed_eval_trace = os.path.join(OUT, "eval_streamed_trace.jsonl")
    if os.path.exists(streamed_eval_trace):
        os.remove(streamed_eval_trace)
    gc.collect()
    torch.cuda.empty_cache()
    reset_counts(kernels)
    reset_memory()
    with recompile.region("phase 13"):
        sh_out, sh_eval_wall = run_evaluate(eval_argv + [
            "--streamed", "--mesh", "host", "--json",
            os.path.join(OUT, "eval_streamed.json"), "--trace",
            streamed_eval_trace])
    trace.disable()
    log(f"[13/19] streamed evaluation (1-rank NCCL mesh): "
        f"{sh_eval_wall:.2f} s wall (phase 6: {eval_wall:.2f} s), "
        f"{len(sh_out['grid']['cells'])} cells")
    sh_eval_launches = read_counts(kernels, "streamed evaluation")
    log_trace(streamed_eval_trace, sh_eval_wall)
    check_no_build("phase 13")
    check_untuned("phase 13", untuned_hits)
    if sh_out["grid"]["cells"] != eval_out["grid"]["cells"]:
        fail("streamed evaluation: grid cells != phase 6's")
    if sh_out["fidelity"] != eval_out["fidelity"]:
        fail("streamed evaluation: fidelity report != phase 6's")
    for kname in ("gathered_tiles", "hamming_topk", "topk_partial",
                  "topk_merge", "lp_round"):
        if sh_eval_launches[kname] == 0:
            fail(f"the streamed evaluation launched no {kname} kernel")
    log("    grid cells and fidelity report equal to phase 6's")
    del sh_out
    dist.destroy_process_group()

    # 14. two ranks on the card ------------------------------------------------
    # two processes, one gloo group, one card: a stand-in for two cards
    # (NCCL refuses two ranks on one device, and this machine has one)
    gc.collect()
    torch.cuda.empty_cache()
    store = os.path.join(OUT, "phase14_store")
    if os.path.exists(store):
        os.remove(store)
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", TWO_RANK_CHILD, str(r), store,
         str(TWO_RANK_QUERIES), str(SHARDED_RECALL_TOL)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            left = TWO_RANK_TIMEOUT - (time.perf_counter() - t0)
            outs.append(p.communicate(timeout=max(left, 1.0))[0])
    except subprocess.TimeoutExpired:
        fail(f"phase 14: the two ranks did not finish in "
             f"{TWO_RANK_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    two_wall = time.perf_counter() - t0
    log(f"[14/19] two ranks on the card (gloo, {TWO_RANK_QUERIES} queries): "
        f"{two_wall:.2f} s wall, both processes")
    reports = []
    for r, (p, text) in enumerate(zip(procs, outs)):
        with open(os.path.join(OUT, f"phase14_rank{r}.log"), "w") as f:
            f.write(text)
        lines = text.strip().splitlines()
        for line in lines[:-1]:
            if f"rank {r}: " in line:
                log("    " + line[line.index(f"rank {r}: "):])
        if p.returncode != 0 or not lines:
            log("\n".join(lines[-30:]))
            fail(f"phase 14: rank {r} exited {p.returncode}")
        reports.append(json.loads(lines[-1]))
    for r, rep in enumerate(reports):
        if rep["builds"]:
            fail(f"phase 14: rank {r} built {rep['builds']} kernel(s)")
        if rep["sampling"]["lp_round"]["launches"] != \
                len(rep["changes"]):
            fail(f"phase 14: rank {r}'s lp_round launches != LP rounds")
        for kname in ("topk_partial", "topk_int8_partial",
                      "gathered_tiles", "hamming_topk"):
            if rep["search"][kname]["launches"] == 0:
                fail(f"phase 14: rank {r} launched no {kname} kernel")
    if not all(shape[2] > 0 for shape in
               reports[1]["sampling"]["lp_round"]["shapes"]):
        fail("phase 14: rank 1's lp_round launches ran at row0 0")

    # 15. the retrieval serving tier at full width ---------------------------
    # every run through the serve CLI's main(argv) in-process, tenants of
    # 1,048,576 x 768 f32 (3.2 GB a tenant on the card); each tenant's
    # corpus is drawn once on the host and shared by the runs (about 8 s of
    # numpy a tenant), the draw the CLI's provider makes
    from repro_torch.launch import serve as serve_cli
    gc.collect()
    torch.cuda.empty_cache()
    drawn: dict = {}
    draw_corpus = serve_cli._tenant_corpus

    def shared_corpus(tenant, **kw):
        key = (tenant, tuple(sorted(kw.items())))
        if key not in drawn:
            drawn[key] = draw_corpus(tenant, **kw)
        return drawn[key]

    serve_cli._tenant_corpus = shared_corpus
    serve_base = ["--docs", str(SERVE_DOCS), "--dim", str(SERVE_DIM),
                  "--k", str(SERVE_K), "--k-max", str(SERVE_KMAX), "--max-batch",
                  str(SERVE_BATCH), "--rate", "inf", "--device", "cuda"]
    ingest_args = ["--append-every", "512", "--append-rows", "256",
                   "--append-cap", "256", "--compact-threshold", "1024"]
    load_15a = serve_base + ["--engine", "exact", "--backend", "cuda",
                             "--tenants", "2", "--max-tenants", "2"] \
        + ingest_args
    serve_launches = collections.Counter()
    serve_rows: dict = {}

    def run_serve(label: str, argv: list):
        """One serve CLI run: its --out row, launches by shape and device ms,
        trace table and allocator peak; returns (row, launches, server)."""
        out = os.path.join(OUT, f"serve_{label}.json")
        path = os.path.join(OUT, f"serve_{label}_trace.jsonl")
        for f in (out, path):
            if os.path.exists(f):
                os.remove(f)
        compactions0 = REGISTRY.counter("serve.ingest.compactions").value
        reset_counts(kernels)
        reset_memory()
        t0 = time.perf_counter()
        with Capture(serve_cli, "build_server", lambda args: "server") \
                as built, recompile.region("phase 15"):
            rc = serve_cli.main(argv + ["--out", out, "--trace", path])
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        trace.disable()
        if rc != 0:
            fail(f"phase 15{label}: the serve CLI exited {rc}")
        row = json.load(open(out))
        row["compactions"] = int(
            REGISTRY.counter("serve.ingest.compactions").value - compactions0)
        serve_rows[label] = row
        log(f"    15{label}: {wall:.2f} s wall; row {json.dumps(row)}")
        launched = read_counts(kernels, f"15{label}")
        serve_launches.update(launched)
        log_trace(path, wall)
        check_no_build("phase 15")
        check_untuned("phase 15", untuned_hits)
        return row, launched, built.results["server"]

    def need(label: str, launched: dict, names) -> None:
        for kname in names:
            if launched[kname] == 0:
                fail(f"phase 15{label} launched no {kname} kernel")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:     # numpy draws without the GIL
        list(pool.map(lambda t: shared_corpus(t, docs=SERVE_DOCS,
                                              dim=SERVE_DIM, seed=0),
                      ("tenant-0", "tenant-1")))
    log(f"[15/19] serving tier: tenants of {SERVE_DOCS} x {SERVE_DIM} f32 "
        f"(two drawn on the host in {time.perf_counter() - t0:.2f} s, "
        f"two threads, before the runs), buckets up to {SERVE_BATCH}, "
        f"k_max {SERVE_KMAX}; {smi}")
    # 15a: the load with live ingest and background compactions
    row, launched, server = run_serve(
        "a", load_15a + ["--requests", str(SERVE_REQUESTS)])
    if row["completed"] + row["rejected"] != SERVE_REQUESTS:
        fail(f"15a: completed + rejected = "
             f"{row['completed'] + row['rejected']} of {SERVE_REQUESTS}")
    if row["compactions"] < 1:
        fail("15a: no compaction landed (serve.ingest.compactions 0)")
    need("a", launched, ("topk_partial", "topk_merge"))
    # the worker lands its own compaction: joined with no further call of
    # the index, frozen_n, pending_rows, the pending gauge and the
    # compactions counter read the state after it
    live = server.tenants.get("tenant-0")
    server.flush()
    if live.pending_rows + 256 >= live.ingest.compact_threshold:
        live.compact(background=False)
    live.append(np.random.default_rng(2022).normal(
        size=(256, SERVE_DIM)).astype(np.float32))
    f0, p0 = live.frozen_n, live.pending_rows
    c0 = REGISTRY.counter("serve.ingest.compactions").value
    t0 = time.perf_counter()
    if not live.compact(background=True):
        fail("15a: no background compaction started")
    worker = live._compactor
    worker.join()
    f5_wall = time.perf_counter() - t0
    got = (live.frozen_n, live.pending_rows,
           REGISTRY.counter("serve.ingest.compactions").value - c0,
           REGISTRY.gauge("serve.ingest.pending").value)
    if got != (f0 + p0, 0, 1, 0):
        fail(f"15a: after the joined worker (no call of the index) "
             f"(frozen_n, pending_rows, compactions, pending gauge) = {got}, "
             f"expected {(f0 + p0, 0, 1, 0)}")
    log(f"    15a F5: a background compaction of {p0} pending rows over "
        f"{f0} frozen, joined without a call of the index after "
        f"{f5_wall:.3f} s on thread {worker.name}: frozen_n {got[0]}, "
        f"pending_rows {got[1]}, compactions +{got[2]}, pending gauge "
        f"{got[3]}; {smi}")
    # 64 fixed queries on tenant-0 after its appends (and 256 rows more,
    # so the append buffer takes part, with no compaction in flight): the
    # scheduler's results equal a direct LiveIndex search of the same batch
    # of 32, and an exact search in plain f32 over its frozen + pending rows
    qs = np.random.default_rng(2024).normal(
        size=(SERVE_QUERIES, SERVE_DIM)).astype(np.float32)

    def with_buffer(srv):
        """tenant-0 after its appends, with 256 rows more pending in its
        append buffer and no compaction in flight, so that one state is
        searched by every side of a comparison: an in-flight compaction is
        landed first, and pending rows that 256 more would carry past the
        threshold are folded in the foreground."""
        live = srv.tenants.get("tenant-0")
        srv.flush()
        if live.pending_rows + 256 >= live.ingest.compact_threshold:
            live.compact(background=False)
        srv.append("tenant-0", np.random.default_rng(2023).normal(
            size=(256, SERVE_DIM)).astype(np.float32))
        if live._compactor is not None or live.pending_rows < 256:
            fail("tenant-0: a compaction is in flight or its 256 appended "
                 "rows are not pending")
        return live

    def direct(live, plain: bool = False):
        """LiveIndex.search_scored of the fixed queries in batches of a full
        bucket at k_max, cut to k; with the plain int8, gathered and
        Hamming versions in place of their kernels when ``plain``."""
        got = []
        with PlainKernels() if plain else contextlib.nullcontext():
            for b0 in range(0, SERVE_QUERIES, SERVE_BATCH):
                s_, i_ = live.search_scored(qs[b0:b0 + SERVE_BATCH],
                                            k=SERVE_KMAX)
                got.append((s_[:, :SERVE_K], i_[:, :SERVE_K]))
        return (np.concatenate([s_ for s_, _ in got]),
                np.concatenate([i_ for _, i_ in got]))

    def served(srv):
        srv.flush()
        got = []
        for b0 in range(0, SERVE_QUERIES, SERVE_BATCH):
            reqs = [srv.submit(q, k=SERVE_K, tenant="tenant-0")
                    for q in qs[b0:b0 + SERVE_BATCH]]
            srv.drain()
            got += [r.result(timeout=0) for r in reqs]
        return (np.stack([s for s, _ in got]), np.stack([i for _, i in got]))

    live = with_buffer(server)
    s_srv, i_srv = served(server)
    ds, di = direct(live)
    if not (np.array_equal(ds, s_srv) and np.array_equal(di, i_srv)):
        fail("15a: the scheduler's results != LiveIndex.search_scored")
    rows_t = torch.from_numpy(np.concatenate([live._host, live._pending]))
    rows_t = rows_t.to(dev)
    qs_t = torch.from_numpy(qs).to(dev)
    plain_s = qs_t @ rows_t.T
    plain_i = torch.sort(plain_s, dim=1, descending=True,
                         stable=True).indices[:, :SERVE_K]
    plain_s = torch.gather(plain_s, 1, plain_i)
    err, ratio = compare_topk(qs_t, rows_t, torch.from_numpy(s_srv).to(dev),
                              torch.from_numpy(i_srv).to(dev), plain_s,
                              plain_i.to(torch.int32), "15a served")
    log(f"    15a: {SERVE_QUERIES} queries on tenant-0 ({live.frozen_n} "
        f"frozen + {live.pending_rows} pending rows): equal to "
        f"LiveIndex.search_scored; ids equal to a plain f32 search away "
        f"from near-ties, scores within the bound (max |err| {err:.3e}, "
        f"{ratio:.3f} of it)")
    del server, live, rows_t, qs_t, plain_s, plain_i
    gc.collect()
    torch.cuda.empty_cache()

    # 15b: one query against a warm single-tenant server
    row, launched, server = run_serve(
        "b", serve_base + ["--engine", "exact", "--backend", "cuda",
                           "--single", "--k", "5"])
    need("b", launched, ("topk_partial", "topk_merge"))
    q1 = np.random.default_rng(1).normal(size=(SERVE_DIM,)).astype(
        np.float32)
    c0 = torch.from_numpy(shared_corpus("tenant-0", docs=SERVE_DOCS,
                                        dim=SERVE_DIM, seed=0)).to(dev)
    q1_t = torch.from_numpy(q1)[None].to(dev)
    p1 = q1_t @ c0.T
    p1_i = torch.sort(p1, dim=1, descending=True, stable=True).indices[:, :5]
    compare_topk(q1_t, c0, torch.tensor([row["scores"]], device=dev),
                 torch.tensor([row["ids"]], dtype=torch.int32, device=dev),
                 torch.gather(p1, 1, p1_i), p1_i.to(torch.int32),
                 "15b --single")
    log(f"    15b --single --k 5: ids {row['ids']}, scores "
        f"{[round(x, 4) for x in row['scores']]}; held to a plain f32 "
        f"search")
    del server, c0, q1_t, p1, p1_i
    gc.collect()

    # 15c: steady state launches no new shape and builds no kernel
    row, launched, server = run_serve(
        "c", serve_base + ["--engine", "exact", "--backend", "cuda",
                           "--requests", "256", "--recompile-check", "64"])
    buckets = server.scheduler.config.bucket_set()
    if row["steady_recompiles"] or row["steady_new_shapes"]:
        fail(f"15c: {row['steady_recompiles']} builds and "
             f"{row['steady_new_shapes']} launches at a new shape in "
             f"steady state")
    if row["warmup_shapes"].get("topk_partial") != len(buckets):
        fail(f"15c: the warm-up launched topk_partial at "
             f"{row['warmup_shapes'].get('topk_partial')} shapes, one a "
             f"bucket is {len(buckets)}")
    log(f"    15c: {row['steady_ticks']} steady ticks, 0 builds, 0 launches "
        f"at a new shape; warm-up shapes {row['warmup_shapes']} over "
        f"buckets {buckets}")
    del server
    gc.collect()
    torch.cuda.empty_cache()

    # 15d: one tenant with live ingest through each other kernel. Each
    # kernel is held to its plain version on the run's own inputs, at every
    # shape the run called its wrapper at; then the fixed queries, with 256
    # rows more in the append buffer: the scheduler's results equal
    # LiveIndex.search_scored, and equal (int8, Hamming: exact integer
    # scans) or agree within the summation bound away from near-ties
    # (gathered) with the same search run through the plain versions
    from repro_torch.kernels.lsh_hamming import ops as lsh_ops
    from repro_torch.kernels.topk_scoring import ops as topk_ops
    side = serve_base + ["--requests", str(SERVE_SIDE_REQUESTS),
                         "--tenants", "1"] + ingest_args

    def hold_to_plain(kname: str, calls, id_vecs) -> None:
        """Each captured wrapper call (args, kwargs) against its plain
        version (a function, so no reference to its inputs outlives it)."""
        for args, kw in calls:
            if kname == "topk_int8_partial":
                check_topk_int8(*args, **kw)
            elif kname == "gathered_tiles":
                check_gathered(*args, kw["k"], id_vecs)
            else:
                check_hamming(*args, **kw)

    for label, extra, kname, wrapper in (
            ("d-int8", ["--engine", "exact", "--backend", "int8"],
             "topk_int8_partial", (topk_ops, "topk_scores_int8")),
            ("d-ivfflat", ["--engine", "ivfflat"], "gathered_tiles",
             (topk_ops, "gathered_topk")),
            ("d-lsh", ["--engine", "lsh", "--engine-opts",
                       '{"rerank": 64}'], "hamming_topk",
             (lsh_ops, "hamming_topk"))):
        with Capture(*wrapper, shapes_key) as seen:
            row, launched, server = run_serve(label, side + extra)
        if row["completed"] + row["rejected"] != SERVE_SIDE_REQUESTS:
            fail(f"15{label}: completed + rejected != "
                 f"{SERVE_SIDE_REQUESTS}")
        need(label, launched, (kname,))
        live = with_buffer(server)
        id_vecs = torch.from_numpy(
            np.concatenate([live._host, live._pending])).to(dev)
        hold_to_plain(kname, seen.calls.values(), id_vecs[:live.frozen_n])
        shapes = sorted(key[0] for key in seen.calls)
        del seen
        s_srv, i_srv = served(server)
        ds, di = direct(live)
        if not (np.array_equal(ds, s_srv) and np.array_equal(di, i_srv)):
            fail(f"15{label}: the scheduler's results != "
                 f"LiveIndex.search_scored")
        ps, pi = direct(live, plain=True)
        if kname == "gathered_tiles":
            if (pi < 0).any():
                fail(f"15{label}: the plain search missed a row")
            on_card = lambda x: torch.from_numpy(x).to(dev)
            compare_topk(on_card(qs), id_vecs, on_card(s_srv),
                         on_card(i_srv), on_card(ps), on_card(pi),
                         f"15{label} served")
            held = "within the summation bound of"
        elif not (np.array_equal(ps, s_srv) and np.array_equal(pi, i_srv)):
            fail(f"15{label}: the served results != the same search through "
                 f"the plain versions")
        else:
            held = "equal to"
        log(f"    15{label}: {kname}'s wrapper held to its plain version on "
            f"the run's inputs at {len(shapes)} shape(s) {shapes}; "
            f"{SERVE_QUERIES} queries on tenant-0 ({live.frozen_n} frozen + "
            f"{live.pending_rows} pending rows): equal to "
            f"LiveIndex.search_scored and {held} the search through the "
            f"plain versions")
        del server, live, id_vecs
        gc.collect()
        torch.cuda.empty_cache()

    # 15e: 15a's arguments at 1024 requests, compactions at 256 pending rows
    # (each of the run's two appends reaches it), unsharded and then
    # streamed on a 1-rank NCCL mesh. Every landing of either run must have
    # come from the compaction worker (the serve.ingest.land spans' thread).
    # Then leftover pending rows are folded in the foreground and 128 rows
    # appended on both, so both hold one state (a background compaction's
    # timing against the second append varies): 15a's 64 queries give equal
    # results bit for bit. The streamed run's process groups are counted
    # before and after it, and after every tenant's eviction and tenant-0's
    # rebuild, which takes a set its eviction gave back
    load_15e = load_15a + ["--requests", str(SERVE_SIDE_REQUESTS),
                           "--compact-threshold", str(SERVE_E_THRESHOLD)]

    def check_landings(label: str, row: dict) -> None:
        """Every compaction the run's trace holds landed on the worker;
        logs the builds' and the landings' seconds."""
        threads, build_s, land_s = [], [], []
        with open(os.path.join(OUT, f"serve_{label}_trace.jsonl")) as f:
            for line in f:
                rec = json.loads(line)
                if rec.get("name") == "serve.ingest.land":
                    threads.append(rec["attrs"]["thread"])
                    land_s.append(rec["dur_s"])
                elif rec.get("name") == "serve.compact":
                    build_s.append(rec["dur_s"])
        if row["compactions"] < 1 or len(threads) != row["compactions"]:
            fail(f"15{label}: {row['compactions']} compaction(s), "
                 f"{len(threads)} landing span(s)")
        if set(threads) != {"live-index-compact"}:
            fail(f"15{label}: a compaction landed on {sorted(set(threads))}, "
                 f"not only on the live-index-compact worker")
        log(f"    15{label}: {len(threads)} compaction(s), each landed by "
            f"the live-index-compact worker; build {sum(build_s):.3f} s in "
            f"all (max {max(build_s):.3f} s), landing {sum(land_s):.4f} s "
            f"in all (max {max(land_s):.4f} s); {smi}")

    def one_state(srv):
        """tenant-0 with every earlier row frozen and 128 new rows
        pending."""
        live = srv.tenants.get("tenant-0")
        srv.flush()
        if live.pending_rows:
            live.compact(background=False)
        live.append(np.random.default_rng(2025).normal(
            size=(128, SERVE_DIM)).astype(np.float32))
        return live

    def n_groups() -> int:
        return len(dist.distributed_c10d._world.pg_map) \
            if dist.is_initialized() else 0

    row, launched, unsharded = run_serve("e-single", load_15e)
    need("e-single", launched, ("topk_partial", "topk_merge"))
    check_landings("e-single", row)
    g_before = n_groups()
    row, launched, streamed = run_serve(
        "e-streamed", load_15e + ["--streamed", "--mesh", "host"])
    need("e-streamed", launched, ("topk_partial", "topk_merge"))
    check_landings("e-streamed", row)
    g_after = n_groups()
    live_s = streamed.tenants.get("tenant-0")
    if not (live_s.config.streamed and live_s._groups is not None):
        fail("15e: tenant-0 is not a streamed LiveIndex")
    live_u = one_state(unsharded)
    live_s = one_state(streamed)
    if (live_u.frozen_n, live_u.pending_rows) != \
            (live_s.frozen_n, live_s.pending_rows):
        fail(f"15e: the two runs hold other rows: "
             f"{(live_u.frozen_n, live_u.pending_rows)} vs "
             f"{(live_s.frozen_n, live_s.pending_rows)}")
    a, b = served(unsharded), served(streamed)
    if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])):
        fail("15e: the streamed server's results != the unsharded one's")
    log(f"    15e: {SERVE_QUERIES} queries on tenant-0 ({live_s.frozen_n} "
        f"frozen + {live_s.pending_rows} pending rows): streamed equal to "
        f"unsharded bit for bit ({dist.get_backend()} group)")
    # process groups: each resident streamed index holds one set of
    # compaction groups (one group, over the corpus axes); an evicted
    # index gives its set to the mesh's free list, and the next index
    # built on the mesh takes it there
    mesh = live_s.config.mesh
    resident = streamed.tenants.resident
    held = sum(streamed.tenants.get(t)._groups is not None
               for t in resident)
    g_search = g_after - held - sum(
        len(sets) for sets in mesh.__dict__.get("_compactor_groups",
                                                {}).values())
    for t in resident:
        streamed.tenants.evict(t)
    g_evicted = n_groups()
    del live_s
    live_s = streamed.tenants.get("tenant-0")
    g_rebuilt = n_groups()
    if not (g_evicted == g_rebuilt == g_after
            and g_after <= g_search + len(resident)):
        fail(f"15e: process groups {g_before} before the streamed run, "
             f"{g_after} after it, {g_evicted} after evicting "
             f"{len(resident)} tenant(s), {g_rebuilt} after tenant-0's "
             f"rebuild; the searches' own {g_search}")
    log(f"    15e: process groups {g_before} before the streamed run, "
        f"{g_after} after it (the searches' own {g_search} + one "
        f"compaction set for each of {len(resident)} resident tenants), "
        f"{g_evicted} after evicting them, {g_rebuilt} after tenant-0's "
        f"rebuild (it took a set an eviction gave back)")
    del unsharded, streamed, live_s, live_u, a, b
    dist.destroy_process_group()
    serve_cli._tenant_corpus = draw_corpus
    drawn.clear()
    gc.collect()
    torch.cuda.empty_cache()
    for label, r in serve_rows.items():
        if "throughput_rps" in r:
            log(f"    15{label}: throughput {r['throughput_rps']} req/s, p50 "
                f"{r['p50_s'] * 1e3:.3f} ms, p99 {r['p99_s'] * 1e3:.3f} ms, "
                f"mean batch {r['mean_batch']}, {r['compactions']} "
                f"compaction(s); {smi}")

    # 16. the contract analyzer on this machine's Python -------------------
    # its CLI over the port against the committed baseline: any finding the
    # baseline does not hold fails the run
    t0 = time.perf_counter()
    lint = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.lint", "--json",
         os.path.join(SRC, "repro_torch"), "--baseline",
         os.path.join(ROOT, "lint_baseline_torch.json")],
        env=dict(os.environ, PYTHONPATH=SRC + os.pathsep
                 + os.environ.get("PYTHONPATH", "")),
        capture_output=True, text=True, timeout=600)
    lint_s = time.perf_counter() - t0
    if lint.returncode not in (0, 1) or not lint.stdout.strip():
        fail(f"phase 16: the analyzer exited {lint.returncode}: "
             f"{lint.stderr[-2000:]}")
    report = json.loads(lint.stdout)
    fresh = [f for f in report["findings"] if f["new"]]
    for f in fresh:
        log(f"    NEW {f['path']}:{f['line']}: {f['severity']}: "
            f"{f['rule']}: {f['message']}")
    if fresh or lint.returncode != 0:
        fail(f"phase 16: {len(fresh)} finding(s) not in "
             f"lint_baseline_torch.json (exit {lint.returncode})")
    log(f"[16/19] analyzer: python -m repro_torch.launch.lint over "
        f"src/repro_torch on Python {sys.version.split()[0]}: "
        f"{len(report['findings'])} findings ({report['counts']}), all in "
        f"the baseline, {len(report['rules'])} rules, {lint_s:.2f} s; {smi}")

    # 17. the LM decoder and RAG serving -----------------------------------
    # a: the five LM archs' reduced configs, card vs the CPU's plain path;
    # b: gemma-2b at its published config; c: RAG over it at full width
    t17 = time.perf_counter()
    with recompile.region("phase 17"):
        for arch in ("llama4-scout-17b-a16e", "mixtral-8x22b",
                     "starcoder2-7b", "gemma-2b", "yi-9b"):
            log(f"    17a {lm_small_parity(arch)}")
        reset_memory()
        lm_cfg, lm_params, lm_pb, _ = gemma_full_width()
        log(f"    17b allocator peak {torch.cuda.max_memory_allocated()} B")
        rag_launches = rag_full_width(lm_cfg, lm_params, lm_pb, kernels, smi)
        del lm_params, lm_pb
    gc.collect()
    torch.cuda.empty_cache()
    check_no_build("phase 17")
    check_untuned("phase 17", untuned_hits)
    log(f"[17/19] LM decoder and RAG serving: 5 reduced archs card vs CPU, "
        f"gemma-2b prefill vs decode, RAG at full width in "
        f"{time.perf_counter() - t17:.1f} s; {smi}")

    # 18. LM training ------------------------------------------------------
    # a: the five LM archs' reduced train cells, card vs the CPU's plain
    # path, and launch/train's resume; b: gemma-2b at its published config.
    # No kernel lies on this path (the reference trains with plain
    # attention): every launch count must stay 0
    import shutil
    from repro_torch.launch.mesh import make_host_mesh
    t18 = time.perf_counter()
    reset_counts(kernels)
    with recompile.region("phase 18"):
        mesh = make_host_mesh()
        ckdir = os.path.join(OUT, "train_small")
        shutil.rmtree(ckdir, ignore_errors=True)
        for arch in ("llama4-scout-17b-a16e", "mixtral-8x22b",
                     "starcoder2-7b", "gemma-2b", "yi-9b"):
            log(f"    18a {train_small_parity(arch, mesh, ckdir)}")
        shutil.rmtree(ckdir, ignore_errors=True)
        gemma_train_full_width(smi)
    train_launches = read_counts(kernels, "phase 18")
    if any(train_launches.values()):
        fail(f"phase 18 launched kernels: {train_launches}")
    dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    check_no_build("phase 18")
    check_untuned("phase 18", untuned_hits)
    log(f"[18/19] LM training: 5 reduced archs card vs CPU and resumed, "
        f"gemma-2b trained at full width with an async save and a restore, "
        f"no kernel launched, in {time.perf_counter() - t18:.1f} s; {smi}")

    # 19. the recsys rankers and MACE --------------------------------------
    # a: the four recsys archs' and MACE's reduced cells, card vs the CPU's
    # plain path, and launch/train's resume; b: DCN-v2 at its published
    # config (its retrieval step is this slice's path through the dense
    # top-k kernel), one AutoInt and one DIEN step; c: MACE at its
    # published config, molecule and a sampled Reddit-sized graph
    t19 = time.perf_counter()
    with recompile.region("phase 19"):
        mesh = make_host_mesh()
        for arch in ("dcn-v2", "autoint", "dien", "dlrm-mlperf"):
            log(f"    19a {train_cell_parity(arch, 'train_batch', mesh)}")
            log(f"    19a {recsys_small_parity(arch, mesh)}")
        for shape in ("molecule", "full_graph_sm", "minibatch_lg"):
            log(f"    19a {train_cell_parity('mace', shape, mesh)}")
        ckdir = os.path.join(OUT, "train_small")
        shutil.rmtree(ckdir, ignore_errors=True)
        for arch in ("dcn-v2", "mace"):
            n_leaves = check_cli_resume(arch, ckdir, "19a")
            log(f"    19a {arch}: launch/train 12 + 8 resumed steps "
                f"bit-equal to 20 (losses and the step-20 checkpoint, "
                f"{n_leaves} leaves)")
        shutil.rmtree(ckdir, ignore_errors=True)
        log(f"    19a in {time.perf_counter() - t19:.1f} s; {smi}")
        recsys_launches = recsys_full_width(kernels, smi)
        mace_full_width(smi)
    dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    check_no_build("phase 19")
    check_untuned("phase 19", untuned_hits)
    log(f"[19/19] recsys and MACE: 4 recsys archs and 3 MACE cells card vs "
        f"CPU and resumed, DCN-v2 trained, served and retrieved at full "
        f"width, AutoInt and DIEN stepped, MACE trained on molecules and a "
        f"sampled Reddit-sized graph, in {time.perf_counter() - t19:.1f} s; "
        f"{smi}")

    def launches(kname: str) -> int:
        """A kernel's launches over the main-path runs (phases 5-7, 12,
        13, 15, 17, 19)."""
        return (sample_launches[kname] + eval_launches[kname]
                + t1_launches[kname] + sh_launches[kname]
                + leg_launches[kname] + sh_eval_launches[kname]
                + serve_launches[kname] + rag_launches[kname]
                + recsys_launches[kname])

    table = {"kernels": [
        {"name": "lp_round", "route": "cuda",
         "source": "src/repro_torch/csrc/lp_round.cu",
         "replaces": "src/repro/kernels/label_prop/label_prop.py:29",
         "launches": launches("lp_round"),
         "max_abs_err": 0, "ms": lp_ms, "plain_ms": lp_plain_ms,
         "bound_ms": lp_bound, "bound_by": lp_by, "library_ms": None},
        {"name": "topk_scores", "route": "cuda",
         "source": "src/repro_torch/csrc/topk_scores.cu",
         "replaces": "src/repro/kernels/topk_scoring/topk_scoring.py:23",
         "launches": launches("topk_partial"),
         "max_abs_err": topk_err, "ms": tk_ms, "plain_ms": tk_plain_ms,
         "bound_ms": tk_bound, "bound_by": tk_by, "library_ms": tk_lib_ms},
        {"name": "topk_scores_int8", "route": "cuda",
         "source": "src/repro_torch/csrc/topk_scores.cu",
         "replaces": "src/repro/kernels/topk_scoring/topk_scoring.py:49",
         "launches": launches("topk_int8_partial"),
         "max_abs_err": 0, "ms": i8_ms, "plain_ms": i8_plain_ms,
         "bound_ms": i8_bound, "bound_by": i8_by, "library_ms": i8_lib_ms},
        {"name": "gathered_topk", "route": "cuda",
         "source": "src/repro_torch/csrc/topk_scores.cu",
         "replaces": "src/repro/kernels/topk_scoring/topk_scoring.py:84",
         "launches": launches("gathered_tiles"),
         "max_abs_err": gath_err, "ms": g_ms, "plain_ms": g_plain_ms,
         "bound_ms": g_bound, "bound_by": g_by, "library_ms": g_lib_ms},
        {"name": "topk_merge", "route": "cuda",
         "source": "src/repro_torch/csrc/topk_scores.cu",
         "replaces": "src/repro/kernels/topk_scoring/topk_scoring.py:23",
         "launches": launches("topk_merge"),
         "max_abs_err": 0, "ms": m_ms, "plain_ms": m_plain_ms,
         "bound_ms": m_bound, "bound_by": m_by, "library_ms": None},
        {"name": "hamming_topk", "route": "cuda",
         "source": "src/repro_torch/csrc/hamming_topk.cu",
         "replaces": "src/repro/kernels/lsh_hamming/lsh_hamming.py:27",
         "launches": launches("hamming_topk"),
         "max_abs_err": 0, "ms": h_ms, "plain_ms": h_plain_ms,
         "bound_ms": h_bound, "bound_by": h_by, "library_ms": None},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:28",
         "launches": launches("flash_attention"),
         "max_abs_err": attn_err, "ms": a_ms, "plain_ms": a_plain_ms,
         "bound_ms": a_bound, "bound_by": a_by, "library_ms": a_lib_ms},
    ]}
    log(f"total {time.perf_counter() - t_start:.1f} s; this process passed "
        f"{bytes_written()} B to write calls")
    print(json.dumps(table))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
