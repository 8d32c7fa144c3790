#!/usr/bin/env python3
"""Split a top-k wrapper's call into its parts on one card.

    python3 tools/wrapper_split.py [--only gathered,narrow]

From the repository root, on a machine with a card. Groups:

- gathered: ``gathered_topk`` at the evaluation path's ivfflat probe (512
  queries over ``chip_smoke.py``'s 5.2e5 x 2048 corpus, 64 lists, nprobe
  8, k 10), at Table I's (256 unit-norm 128-wide queries over a
  projection of the same corpus, k 3), at the serving tier's ivfflat
  ticks (Q 1, 8, the gathered cutoff and one above it, and 32, over a
  1,048,576 x 768 tenant drawn as ``launch/serve.py`` draws it, k 16)
  and at the RAG stack's one-query
  calls (17c of ``chip_smoke.py``: a WindTunnel sample of an 8192-query
  corpus, its tf-idf vectors, k 3). For each: the whole call (CUDA events
  over many calls), the device time of each kernel launch (events around
  every launch, ``Kernel.timed``), the profiler's device time of the
  whole call and of each kernel and copy in it, and the host's time a
  call (the host clock over the calls, before the closing synchronize).
  Above the gathered cutoff, the wrapper's pieces step alone
  (``gathered_pieces``: events, host time and the profiler's device time
  of its kernels); at or below it (the runs path, no pieces step), the
  device time of the call's one read (the stray-row flag's copy).
- narrow: ``topk_scores`` (f32) and ``topk_scores_int8`` at one query over
  a rank's candidate shard (500,000 and 250,000 rows of D 16, k 100) and
  over 1,000,000 rows: the call's event time, each kernel's device time
  and the wrapper's host time a call.

Every line names the card (``nvidia-smi`` name and power limit); the last
line is one JSON object of it all.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
GROUPS = ("gathered", "narrow")


def launch_ms(fn, calls: int) -> dict:
    """Device ms a call of each kernel launch, by CUDA events around every
    launch (``Kernel.timed``)."""
    import torch
    from repro_torch.kernels.build import Kernel
    fn()
    torch.cuda.synchronize()
    Kernel.timed = []
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    timed, Kernel.timed = Kernel.timed, None
    out: dict = {}
    for name, a, b in timed:
        out[name] = out.get(name, 0.0) + a.elapsed_time(b) / calls
    return out


def profiled_ms(fn, calls: int):
    """The profiler's device ms a call over ``calls`` calls, in all and by
    kernel name (None: no device event seen)."""
    import chip_smoke as cs
    fn()
    per_kernel = cs.device_profile(lambda: [fn() for _ in range(calls)])[2]
    by_name = {name: sec * 1e3 / calls for name, (n, sec) in
               per_kernel.items()}
    return cs.call_device_ms(per_kernel, calls), by_name


def fmt(x) -> str:
    return "not measured" if x is None else f"{x:.4f}"


def gathered_cases():
    """(label, (queries, table, rows, ids), k, calls), each made on the
    card as it comes."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.core import prng
    from repro_torch.retrieval.engines import IVFFlatEngine
    from repro_torch.retrieval.ivfflat import probe_candidates
    dev = torch.device("cuda")
    engine = IVFFlatEngine()

    def probe(vecs, qs, k):
        index = engine.build(prng.prng_key(0), vecs)
        rows, ids = probe_candidates(index, qs, nprobe=engine.nprobe)
        return qs, index.vecs.reshape(-1, index.vecs.shape[2]), rows, ids

    _, (ev_np, qv_np) = cs.eval_corpus(cs.EVAL_QUERIES, 2048)
    ev = torch.from_numpy(ev_np).to(dev)
    pq = torch.from_numpy(qv_np[:cs.PROBE_QUERIES]).to(dev)
    del ev_np, qv_np
    yield "evaluation probe Q=512 D=2048", probe(ev, pq, 10), 10, 5
    g = torch.Generator(device="cpu").manual_seed(19)
    proj = torch.randn(ev.shape[1], cs.ENCODER_DIM, generator=g).to(dev)
    e128 = torch.nn.functional.normalize(ev @ proj, dim=1)
    q128 = torch.nn.functional.normalize(pq[:cs.ENCODER_BATCH] @ proj, dim=1)
    del ev, pq, proj
    yield "Table I probe Q=256 D=128", probe(e128, q128, 3), 3, 10
    del e128, q128
    torch.cuda.empty_cache()
    from repro_torch.launch import serve as serve_cli
    tenant = torch.from_numpy(serve_cli._tenant_corpus(
        "tenant-0", docs=cs.SERVE_DOCS, dim=cs.SERVE_DIM, seed=0)).to(dev)
    rng = np.random.default_rng(2024)
    sq = torch.from_numpy(rng.normal(size=(cs.SERVE_BATCH, cs.SERVE_DIM))
                          .astype(np.float32)).to(dev)
    qs, table, rows, ids = probe(tenant, sq, cs.SERVE_KMAX)
    del tenant
    from repro_torch.kernels.topk_scoring.ops import GATHERED_NARROW_QUERIES
    for q in sorted({1, 8, GATHERED_NARROW_QUERIES,
                     GATHERED_NARROW_QUERIES + 1, 32}):
        yield (f"serving ivfflat tick Q={q} D=768",
               (qs[:q], table, rows[:q].contiguous(), ids[:q].contiguous()),
               cs.SERVE_KMAX, 20)
    del qs, table, rows, ids
    torch.cuda.empty_cache()
    # the RAG stack's index (chip_smoke.rag_full_width): a WindTunnel
    # sample of its corpus, tf-idf vectors, one query a call
    from repro_torch.core import WindTunnelConfig, run_windtunnel
    from repro_torch.data.synthetic import generate_corpus
    from repro_torch.retrieval.tfidf import tfidf_vectors
    corpus = generate_corpus(num_queries=cs.RAG_CORPUS_QUERIES,
                             qrels_per_query=16, num_topics=48,
                             aux_fraction=1.0, vocab_size=2048,
                             query_len=24, seed=0)
    res = run_windtunnel(corpus.qrels, num_queries=corpus.num_queries,
                         num_entities=corpus.num_entities,
                         config=WindTunnelConfig(
                             tau_quantile=0.5, fanout=16, lp_rounds=4,
                             target_size=0.3 * corpus.num_primary, seed=0),
                         device="cuda")
    kept = torch.nonzero(res.sample.entity_mask)[:, 0].cpu().numpy()
    vecs, df = tfidf_vectors(corpus.passage_tokens[kept], corpus.vocab_size)
    qv = tfidf_vectors(np.asarray(corpus.query_tokens[:1]),
                       corpus.vocab_size, df)[0]
    yield (f"RAG Q=1 N={kept.size} D={vecs.shape[1]}",
           probe(torch.as_tensor(vecs, device=dev),
                 torch.as_tensor(qv, device=dev), 3), 3, 50)


def split_gathered(smi: str) -> dict:
    from chip_smoke import host_ms
    from repro_torch.kernels.topk_scoring import ops
    from repro_torch.obs.timing import cuda_ms
    out = {}
    for label, (qs, table, rows, ids), k, calls in gathered_cases():
        r = table.shape[0]
        narrow = qs.shape[0] <= ops.GATHERED_NARROW_QUERIES
        call = lambda: ops.gathered_topk(qs, table, rows, ids, k=k)
        pieces = lambda: ops.gathered_pieces(rows, ids, r, k)
        row = {
            "Q": qs.shape[0], "C": ids.shape[1], "D": qs.shape[1], "k": k,
            "valid": int((ids >= 0).sum()),
            "path": "runs" if narrow else "pieces",
            "call_ms": cuda_ms(call, calls),
            "launch_ms": launch_ms(call, calls),
            "host_ms": host_ms(call, calls),
        }
        row["device_ms"], row["device_by_kernel"] = profiled_ms(call, calls)
        if narrow:
            # no pieces step: the launches, then the one read (the
            # stray-row flag's copy to the host)
            read = [ms for name, ms in row["device_by_kernel"].items()
                    if "Memcpy DtoH" in name]
            row["read_device_ms"] = sum(read) if read else None
            parts = (f"runs path, no pieces step; the one read's copy "
                     f"device {fmt(row['read_device_ms'])} ms")
        else:
            row["pieces_ms"] = cuda_ms(pieces, calls)
            row["pieces_host_ms"] = host_ms(pieces, calls)
            row["pieces_device_ms"] = profiled_ms(pieces, calls)[0]
            parts = (f"pieces step {row['pieces_ms']:.4f} ms (host "
                     f"{row['pieces_host_ms']:.4f}, device "
                     f"{fmt(row['pieces_device_ms'])})")
        out[label] = row
        print(f"gathered split at {label} C={row['C']} (valid "
              f"{row['valid']}) k={k}: call {row['call_ms']:.4f} ms (host "
              f"{row['host_ms']:.4f}, device {fmt(row['device_ms'])}); "
              f"{parts}; launches: "
              + "; ".join(f"{n} {ms:.4f} ms"
                          for n, ms in row["launch_ms"].items())
              + "; profiler device ms a call: "
              + "; ".join(f"{n.split('(')[0][-36:]} {ms:.4f}"
                          for n, ms in row["device_by_kernel"].items())
              + f"; {smi}", flush=True)
        del qs, table, rows, ids, call, pieces
    return out


def split_narrow(smi: str) -> dict:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.topk_scoring import ops
    from repro_torch.obs.timing import cuda_ms
    dev = torch.device("cuda")
    out = {}
    qs, cs_ = cs.topk_inputs(1, 1_000_000, 16, seed=31, negative=False,
                             device=dev)
    qc, cc = cs.int8_inputs(1, 1_000_000, 16, seed=31, negative=False,
                            device=dev)
    for n in (1_000_000, 500_000, 250_000):
        for kind, fn, a, b in (("f32", ops.topk_scores, qs, cs_[:n]),
                               ("int8", ops.topk_scores_int8, qc, cc[:n])):
            call = lambda: fn(a, b, k=100)
            row = {"call_ms": cuda_ms(call, 200, 10),
                   "host_ms": cs.host_ms(call, 200),
                   "launch_ms": launch_ms(call, 50)}
            row["device_ms"] = profiled_ms(call, 50)[0]
            out[f"{kind} Q=1 N={n} D=16 k=100"] = row
            print(f"narrow wrapper {kind} Q=1 N={n} D=16 k=100: call "
                  f"{row['call_ms']:.4f} ms, host {row['host_ms']:.4f} ms a "
                  f"call, device {fmt(row['device_ms'])}; launches: "
                  + "; ".join(f"{name} {ms:.4f} ms"
                              for name, ms in row["launch_ms"].items())
                  + f"; {smi}", flush=True)
    return out


def main(groups) -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("wrapper_split: no CUDA card")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_grad_enabled(False)
    result = {"device": smi}
    if "narrow" in groups:
        result["narrow"] = split_narrow(smi)
    if "gathered" in groups:
        result["gathered"] = split_gathered(smi)
    print(json.dumps(result))


if __name__ == "__main__":
    argv = sys.argv[1:]
    only = GROUPS
    if "--only" in argv:
        i = argv.index("--only")
        only = tuple(argv[i + 1].split(","))
        del argv[i:i + 2]
    if argv or not set(only) <= set(GROUPS):
        sys.exit(__doc__)
    main(only)
