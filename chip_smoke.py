#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

From the root of a checkout, with one card. In order:

1. Device: the card's name and power limit; no card is a failure.
2. Build: every CUDA source under src/repro_torch/csrc, one nvcc each,
   started together; prints each build's ``-Xptxas -v`` report.
3. Kernel vs plain: each kernel's wrapper (lp_round, the f32 top-k, the
   int8 top-k, the gathered top-k, the Hamming top-k) against its plain
   PyTorch version on the card, at the main path's shapes and at odd ones.
   The gathered kernel's main shape is the ivfflat probe of the evaluation
   path's full corpus (its tf-idf embedding, 5.2e5 x 2048, indexed as the
   ivfflat engine does: 64 lists, nprobe 8) for 512 queries.
4. Times: each kernel, its plain version and, where one PyTorch call
   computes the same function, that call, with CUDA events after a
   warm-up, beside the least time the card could take.
5. Sampling: ``repro_torch.launch.sample`` at 65536 queries with the LP
   kernel engine (about 2.1M qrel rows and 3.1M entities).
6. Evaluation: ``repro_torch.launch.evaluate --grid default --backend
   cuda`` at 32768 queries (about 5e5 entities x 2048 f32 of corpus): the
   paper's grid, 3 samplers x 4 engines (exact, ivfflat, lsh, tfidf) x 2
   ks x 4 metrics = 96 cells, with its default backend recall curve, whose
   int8 rows run the int8 kernel.
7. Small-input check: the same two entry points on the card and on the
   CPU's plain path must give equal outputs; for the default grid, the
   ivfflat centroids and the lsh projection first agree within a stated
   rtol (cuBLAS and the CPU sum in other orders).

Launch counts are set to 0 just before each main-path run (5, 6) and read
just after; a kernel the run did not launch is a failure. No phase catches
its own failure: any error exits nonzero. The last three lines of stdout
are the kernel table (JSON), the nvidia-smi line and the result (JSON).
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
OUT = os.path.join(ROOT, "build", "chip_smoke")

H100_BYTES_PER_S = 3.35e12      # HBM3, SXM data sheet
H100_F32_FLOPS = 67e12          # f32 outside the tensor cores
H100_INT8_OPS = 1979e12         # int8, tensor cores, dense
SAMPLE_QUERIES = 65536
EVAL_QUERIES = 32768
PROBE_QUERIES = 512             # the grid's per-sample query cap
INDEX_RTOL = 1e-5               # centroids / projection, card vs CPU


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, n_ops: float, peak_ops: float = H100_F32_FLOPS):
    """The least time (ms) the card could take, and what sets it."""
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
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
                device):
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    qs = torch.randn(q, d, generator=g)
    cs = torch.randn(n, d, generator=g)
    if negative:                    # every score negative
        qs, cs = qs.abs(), -cs.abs()
    return qs.to(device), cs.to(device)


# --------------------------------------------------------------------------
# phase 3: kernel vs plain
# --------------------------------------------------------------------------

def check_lp(labels, nbr, wgt) -> None:
    import torch
    from repro_torch.core.label_prop import ell_round
    from repro_torch.kernels.label_prop.ops import lp_round_cuda
    got = lp_round_cuda(labels, nbr, wgt)
    torch.cuda.synchronize()
    want = ell_round(labels, nbr, wgt)
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        fail(f"lp_round kernel != plain ell_round on {bad} of "
             f"{labels.shape[0]} nodes (N={nbr.shape[0]}, K={nbr.shape[1]})")


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


def check_topk(qs, cs, k: int) -> float:
    """Kernel vs plain top-k. Scores must agree within the f32 summation
    bound D * 2**-24 * sum_d |q_d c_d| (the two sum in different orders);
    ids must be equal except where the kernel picked a different id whose
    exact score lies within that tolerance of the plain one (a near-tie)."""
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
    s, i = s[:, :k_eff], i[:, :k_eff]
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
    return float(err.max()) if err.numel() else 0.0


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


def eval_corpus(num_queries: int, vocab: int):
    """The evaluation CLI's corpus at its default widths, and its tf-idf
    embedding (entities, queries) as numpy."""
    from repro_torch.data.synthetic import generate_corpus
    from repro_torch.eval import tfidf_embedder
    corpus = generate_corpus(num_queries=num_queries, qrels_per_query=16,
                             num_topics=48, aux_fraction=1.0,
                             vocab_size=vocab, query_len=24, seed=0)
    return corpus, tfidf_embedder(corpus)


# --------------------------------------------------------------------------
# main-path runs
# --------------------------------------------------------------------------

def span_breakdown(path: str, wall: float) -> str:
    """Seconds per top-level span of a CLI's ``--trace`` file, plus the
    wall time outside every span (corpus generation, embedding, fits)."""
    totals: dict = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if rec["parent"] is None:
                totals[rec["name"]] = totals.get(rec["name"], 0.0) + \
                    rec["dur_s"]
    parts = [f"{name} {sec:.3f} s" for name, sec in sorted(
        totals.items(), key=lambda kv: -kv[1])]
    parts.append(f"outside spans {wall - sum(totals.values()):.3f} s")
    return ", ".join(parts)


def reset_counts(kernels) -> None:
    for kern in kernels:
        kern.launches = 0


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


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run from a checkout")
    sys.path.insert(0, SRC)
    from repro_torch.kernels import build
    from repro_torch.kernels.label_prop.ops import LP_ROUND, lp_round_cuda
    from repro_torch.kernels.lsh_hamming.ops import (HAMMING_PARTIAL,
                                                     hamming_topk)
    from repro_torch.kernels.lsh_hamming.ref import hamming_topk_ref
    from repro_torch.kernels.topk_scoring.ops import (GATHERED_PARTIAL,
                                                      TOPK_INT8_PARTIAL,
                                                      TOPK_MERGE,
                                                      TOPK_PARTIAL,
                                                      gathered_topk,
                                                      topk_scores,
                                                      topk_scores_int8)
    from repro_torch.kernels.topk_scoring.ref import (gathered_topk_ref,
                                                      topk_scores_int8_ref,
                                                      topk_scores_ref)
    from repro_torch.core import prng
    from repro_torch.core.label_prop import ell_round
    from repro_torch.obs import trace
    from repro_torch.retrieval.engines import IVFFlatEngine, LSHEngine
    from repro_torch.retrieval.ivfflat import probe_candidates
    from repro_torch.retrieval.lsh import encode
    kernels = (LP_ROUND, TOPK_PARTIAL, TOPK_INT8_PARTIAL, GATHERED_PARTIAL,
               HAMMING_PARTIAL, TOPK_MERGE)
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
    log(f"[1/7] device: {name}; nvidia-smi: {smi}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    sources = sorted({kern.source for kern in kernels})
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(build.load, sources))
    log(f"[2/7] built {', '.join(sources)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for src in sources:
        for line in build.ptxas_report(src).splitlines():
            if "ptxas" in line:
                log(f"    {src}: {line.strip()}")

    # 3. kernel vs plain ---------------------------------------------------
    log("[3/7] kernel vs plain")
    for n, k, quarter in [(1, 1, True), (37, 5, True), (513, 33, True),
                          (300, 70, False), (4096, 0, True),
                          (100_003, 32, True), (100_003, 32, False)]:
        labels, nbr, wgt, _ = lp_inputs(n, k, seed=n + k, quarter=quarter,
                                        device=dev)
        check_lp(labels, nbr, wgt)
    lp_main = lp_inputs(3_100_000, 32, seed=7, quarter=False, device=dev)
    check_lp(*lp_main[:3])
    log(f"    lp_round: labels equal at 8 shapes incl. N=3.1M K=32")
    topk_err = 0.0
    for q, n, d, k, neg in [(1, 1, 4, 1, False), (7, 513, 16, 5, True),
                            (33, 1000, 37, 8, False), (3, 5, 8, 9, True),
                            (1, 129, 2048, 3, True), (5, 40, 8, 60, False),
                            (3, 33, 16, 32, False), (9, 1000, 24, 100, True),
                            (128, 4096, 128, 32, False)]:
        qs, cs = topk_inputs(q, n, d, seed=q * n + d, negative=neg,
                             device=dev)
        topk_err = max(topk_err, check_topk(qs, cs, k))
    tq, tc = topk_inputs(128, 524_288, 2048, seed=11, negative=False,
                         device=dev)
    for k in (3, 10):
        topk_err = max(topk_err, check_topk(tq, tc, k))
    log(f"    topk_scores: within the summation bound at 11 shapes incl. "
        f"Q=128 N=524288 D=2048 k=3,10; max |err| {topk_err:.3e}")
    for q, n, d, k, neg in [(1, 1, 4, 1, False), (7, 513, 16, 5, True),
                            (33, 1000, 37, 8, False), (3, 5, 20, 9, True),
                            (5, 40, 8, 60, False), (9, 1000, 64, 100, True),
                            (128, 4096, 128, 40, False)]:
        check_topk_int8(*int8_inputs(q, n, d, seed=q * n + d, negative=neg,
                                     device=dev), k)
    iq, ic = int8_inputs(128, 524_288, 2048, seed=13, negative=False,
                         device=dev)
    for k in (10, 20, 40, 80):
        check_topk_int8(iq, ic, k)
    log("    topk_scores_int8: scores and ids equal at 11 shapes incl. "
        "Q=128 N=524288 D=2048 k=10,20,40,80")
    gath_err = 0.0
    for q, c, d, r, k in [(1, 1, 4, 1, 1), (3, 5, 8, 4, 9),
                          (7, 300, 37, 50, 5), (16, 1000, 64, 200, 32),
                          (5, 2000, 16, 100, 64), (4, 700, 128, 90, 100),
                          (2, 40, 2048, 40, 3), (33, 5000, 24, 3000, 10)]:
        gq, gt, gr, gi = gathered_inputs(q, c, d, r, seed=q * c + d,
                                         device=dev)
        gath_err = max(gath_err, check_gathered(gq, gt, gr, gi, k, gt))
    t0 = time.perf_counter()
    corpus, (ev_np, qv_np) = eval_corpus(EVAL_QUERIES, 2048)
    ev = torch.from_numpy(ev_np).to(dev)
    pq = torch.from_numpy(qv_np[:PROBE_QUERIES]).to(dev)
    del corpus, qv_np
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
    log(f"    gathered_topk: within the summation bound at 10 shapes incl. "
        f"the ivfflat probe Q={PROBE_QUERIES} C={p_ids.shape[1]} "
        f"D={ev.shape[1]} k=3,10; max |err| {gath_err:.3e}")
    for q, n, w, k in [(1, 1, 4, 1), (3, 5, 4, 9), (7, 513, 4, 5),
                       (33, 1000, 4, 32), (40, 4096, 4, 64),
                       (9, 1000, 3, 100), (5, 300, 1, 300),
                       (64, 20000, 4, 10), (2, 129, 8, 33)]:
        check_hamming(*hamming_inputs(q, n, w, seed=q * n + w, device=dev),
                      k)
    hq, hc = hamming_inputs(PROBE_QUERIES, 524_288, 4, seed=17, device=dev)
    for k in (3, 10, 64):
        check_hamming(hq, hc, k)
    lsh = lsh_engine.build(prng.prng_key(0), ev)
    lq = encode(lsh.proj, pq)
    check_hamming(lq, lsh.codes, lsh_engine.rerank)
    log(f"    hamming_topk: scores and ids equal at 13 shapes incl. "
        f"Q={PROBE_QUERIES} N=524288 W=4 k=3,10,64 and the lsh codes of "
        f"the corpus, N={lsh.codes.shape[0]} k={lsh_engine.rerank}")

    # 4. times -------------------------------------------------------------
    log("[4/7] times (CUDA events, after warm-up)")
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
                            2.0 * qn * n_c * d)
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
    valid = p_ids >= 0
    c_valid = int(valid.sum())
    probed_rows = int(torch.unique(p_rows[valid]).numel())
    g_bound, g_by = bound(
        probed_rows * d * 4 + pq.numel() * 4 + c_valid * 8
        + pq.shape[0] * k_g * 8, 2.0 * c_valid * d)
    log(f"    gathered_topk Q={pq.shape[0]} C={p_ids.shape[1]} "
        f"(valid {c_valid}, distinct probed rows {probed_rows}) D={d} "
        f"k={k_g}: kernel {g_ms:.4f} ms, plain {g_plain_ms:.4f} ms, "
        f"gather+bmm+stable sort by {lib_chunk} queries {g_lib_ms:.4f} ms, "
        f"bound {g_bound:.4f} ms ({g_by})")
    # Hamming at the lsh rerank pool of the main path (k = 64); three
    # integer operations (xor, popc, add) a word, counted at the f32 rate
    # of the CUDA cores; no single PyTorch call computes a popcount
    k_h = lsh_engine.rerank
    hn, hw = hc.shape
    h_ms = cuda_ms(lambda: hamming_topk(hq, hc, k=k_h), 10)
    h_plain_ms = cuda_ms(lambda: hamming_topk_ref(hq, hc, k=k_h), 2)
    h_bound, h_by = bound((hq.shape[0] + hn) * hw * 4
                          + hq.shape[0] * k_h * 8,
                          3.0 * hq.shape[0] * hn * hw)
    log(f"    hamming_topk Q={hq.shape[0]} N={hn} W={hw} k={k_h}: kernel "
        f"{h_ms:.4f} ms, plain {h_plain_ms:.4f} ms, no library call, "
        f"bound {h_bound:.4f} ms ({h_by})")
    del lp_main, labels, nbr, wgt, tq, tc, iq, ic, ev, pq, ivf, p_rows
    del p_ids, p_table, lsh, lq, hq, hc
    torch.cuda.empty_cache()

    # 5. sampling main path ------------------------------------------------
    os.makedirs(OUT, exist_ok=True)
    reset_counts(kernels)
    sample_trace = os.path.join(OUT, "sample_trace.jsonl")
    eval_trace = os.path.join(OUT, "eval_trace.jsonl")
    for path in (sample_trace, eval_trace):
        if os.path.exists(path):
            os.remove(path)
    stats, wall = run_sample([
        "--queries", str(SAMPLE_QUERIES), "--qrels-per-query", "32",
        "--topics", "96", "--aux-fraction", "2.0", "--engine", "cuda",
        "--device", "cuda", "--out", os.path.join(OUT, "sample"),
        "--trace", sample_trace])
    sample_launches = {kern.name: kern.launches for kern in kernels}
    log(f"[5/7] sampling: {wall:.2f} s wall, {stats['edges']} edges, "
        f"{stats['communities']} communities, changes/round "
        f"{stats['changes_per_round']}, {stats['entities']} entities "
        f"sampled; launches {sample_launches}")
    log(f"    time: {span_breakdown(sample_trace, wall)}")
    if sample_launches["lp_round"] == 0:
        fail("the sampling run launched no lp_round kernel")
    if sample_launches["lp_round"] != len(stats["changes_per_round"]):
        fail("lp_round launches != LP rounds on the sampling path")
    saved = np.load(os.path.join(OUT, "sample", "sample.npz"))
    if saved["labels"].min() < 0 or not saved["entity_mask"].any():
        fail("sample.npz has negative labels or an empty sample")

    # 6. evaluation main path ----------------------------------------------
    reset_counts(kernels)
    out, wall = run_evaluate([
        "--grid", "default", "--backend", "cuda", "--device", "cuda",
        "--queries", str(EVAL_QUERIES), "--json",
        os.path.join(OUT, "eval.json"), "--trace", eval_trace])
    eval_launches = {kern.name: kern.launches for kern in kernels}
    cells = out["grid"]["cells"]
    log(f"[6/7] evaluation: {wall:.2f} s wall, {len(cells)} cells; "
        f"launches {eval_launches}")
    trace.disable()
    log(f"    time: {span_breakdown(eval_trace, wall)}")
    log(f"    fidelity: {json.dumps(out['fidelity']['mean_abs_delta'])}")
    log(f"    winners: {json.dumps(out['fidelity']['winners'])}")
    log(f"    backend curve: {json.dumps(out['backend_curve'])}")
    for kname in ("gathered_partial", "hamming_partial", "topk_partial",
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

    # 7. small inputs: card vs the CPU's plain path --------------------------
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
    from repro_torch.core import SamplerSpec
    from repro_torch.data.synthetic import generate_corpus
    from repro_torch.eval import (build_fidelity_report, run_grid,
                                  tfidf_embedder)
    from repro_torch.launch.evaluate import GRIDS
    corpus = generate_corpus(num_queries=512, qrels_per_query=16,
                             num_topics=48, aux_fraction=1.0, vocab_size=256,
                             query_len=24, seed=0)
    # the default grid's ANN indexes start from cuBLAS vs CPU products and
    # libdevice vs CPU log1p: first their centroids and projection, then
    # the cells
    ev_small = torch.from_numpy(tfidf_embedder(corpus)[0])
    built = {}
    for where in ("cuda", "cpu"):
        vecs = ev_small.to(where)
        built[where] = (IVFFlatEngine().build(prng.prng_key(0), vecs),
                        LSHEngine().build(prng.prng_key(0), vecs))
    (ivf_g, lsh_g), (ivf_c, lsh_c) = built["cuda"], built["cpu"]
    for what, a, b in (("ivfflat centroids", ivf_g.centroids,
                        ivf_c.centroids),
                       ("lsh projection", lsh_g.proj, lsh_c.proj)):
        if not torch.allclose(a.cpu(), b, rtol=INDEX_RTOL, atol=0.0):
            fail(f"small index: {what} differ beyond rtol {INDEX_RTOL} "
                 f"between cuda and cpu (max |diff| "
                 f"{float((a.cpu() - b).abs().max()):.3e})")
    same_lists = torch.equal(ivf_g.ids.cpu(), ivf_c.ids)
    same_codes = torch.equal(lsh_g.codes.cpu(), lsh_c.codes)
    log(f"    small index ({tuple(ev_small.shape)}): centroids and "
        f"projection within rtol {INDEX_RTOL}; ivfflat lists "
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
    log("[7/7] small inputs: sample.npz and grid cells equal on cuda and cpu")

    table = {"kernels": [
        {"name": "lp_round", "route": "cuda",
         "source": "src/repro_torch/csrc/lp_round.cu",
         "replaces": "src/repro/kernels/label_prop/label_prop.py:29",
         "launches": sample_launches["lp_round"] + eval_launches["lp_round"],
         "max_abs_err": 0, "ms": lp_ms, "plain_ms": lp_plain_ms,
         "bound_ms": lp_bound, "bound_by": lp_by, "library_ms": None},
        {"name": "topk_scores", "route": "cuda",
         "source": "src/repro_torch/csrc/topk_scores.cu",
         "replaces": "src/repro/kernels/topk_scoring/topk_scoring.py:23",
         "launches": (sample_launches["topk_partial"]
                      + eval_launches["topk_partial"]),
         "max_abs_err": topk_err, "ms": tk_ms, "plain_ms": tk_plain_ms,
         "bound_ms": tk_bound, "bound_by": tk_by, "library_ms": tk_lib_ms},
        {"name": "topk_scores_int8", "route": "cuda",
         "source": "src/repro_torch/csrc/topk_scores.cu",
         "replaces": "src/repro/kernels/topk_scoring/topk_scoring.py:49",
         "launches": (sample_launches["topk_int8_partial"]
                      + eval_launches["topk_int8_partial"]),
         "max_abs_err": 0, "ms": i8_ms, "plain_ms": i8_plain_ms,
         "bound_ms": i8_bound, "bound_by": i8_by, "library_ms": i8_lib_ms},
        {"name": "gathered_topk", "route": "cuda",
         "source": "src/repro_torch/csrc/topk_scores.cu",
         "replaces": "src/repro/kernels/topk_scoring/topk_scoring.py:84",
         "launches": (sample_launches["gathered_partial"]
                      + eval_launches["gathered_partial"]),
         "max_abs_err": gath_err, "ms": g_ms, "plain_ms": g_plain_ms,
         "bound_ms": g_bound, "bound_by": g_by, "library_ms": g_lib_ms},
        {"name": "hamming_topk", "route": "cuda",
         "source": "src/repro_torch/csrc/topk_scores.cu",
         "replaces": "src/repro/kernels/lsh_hamming/lsh_hamming.py:27",
         "launches": (sample_launches["hamming_partial"]
                      + eval_launches["hamming_partial"]),
         "max_abs_err": 0, "ms": h_ms, "plain_ms": h_plain_ms,
         "bound_ms": h_bound, "bound_by": h_by, "library_ms": None},
    ]}
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(table))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
