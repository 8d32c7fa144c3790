#!/usr/bin/env python3
"""Time the port's kernels in two or more checkouts against each other, in
turns, on one card.

    mkdir -p build/parent
    git archive REV src/repro_torch | tar -x -C build/parent
    python3 tools/kernel_ab.py build/parent . [--only dense,gathered]

Each argument is a checkout of the port: a directory holding
``src/repro_torch``, for example an earlier commit's, written out
beforehand under ``build/`` (which git ignores; the machine with the card
has no git). Each checkout runs in a process of its own, which builds its
own kernels (into its own ``build/kernels``) and calls its own public
entry points (``topk_scores``, ``topk_scores_int8``, ``gathered_topk``,
``hamming_topk``, ``label_prop_round``, ``flash_attention``,
``launch_merge``), so each
version is timed with the host work of its own wrapper, whatever its
kernels' C interface. The inputs are made once,
on the card, by this tree's ``chip_smoke.py`` helpers, and handed to every
process through CUDA IPC, so all versions see the same tensors.

Cases, at the main path's shapes (``--only`` picks groups):

- dense: ``topk_scores`` at Q 128, N 524288, D 2048, k 3 and 40; at a
  grid search's shape (256 queries over 39,780 rows of D 2048, k 10); at
  the serving tick (32 queries over 1,048,576 rows of D 768, k 16) and at
  the recsys retrieval step (one query over 1,000,000 rows of D 16, k 100),
  both on the narrow path where a checkout has one;
- int8: ``topk_scores_int8`` at the same shape, k 10, 20, 40 and 80 (the
  evaluation curve's pools), and at the serving tick (32 queries over
  1,048,576 codes of D 768, k 64, the int8 backend's pool);
- gathered: ``gathered_topk`` at the ivfflat probe of the evaluation path
  (512 queries, D 2048, k 10, over ``chip_smoke.py``'s 5.2e5-entity
  corpus and index), at one query over the same index (k 3, the RAG
  stack's calls), at Table I's (256 queries, D 128, k 3, over a
  128-wide projection of the same corpus) and at the serving tick's
  (a tenant of 1,048,576 normal rows of D 768, k 16) at Q 1, 2, 4, the
  gathered cutoff, one above it and 32; ``launch_merge`` alone on the f32
  kernel's partial lists at Q 128 (k 10) and at one query's widths of the
  two gathered paths (16,672 and 32,784 entries, k 16);
- hamming: ``hamming_topk`` at Q 512, N 524288, W 4 (random codes, half
  the rows duplicated), k 10 and 64 (the lsh engine's rerank pool);
- lp: ``label_prop_round`` at N 3.1M, K 32 (``chip_smoke.lp_inputs``:
  a heavy-tailed degree law, half the nodes isolated);
- flash: ``flash_attention`` at the encoder's passage and query batches
  (B 256, S 64 and 24, H 4, D 32, f32, bidirectional) and at S 2048,
  32/4 heads, D 128, bf16, causal.

Each case is timed with CUDA events, the versions in the order A B ... B A,
three times; each process then reports the profiler's device time a call
(every kernel the call launched, as ``chip_smoke.call_device_ms`` counts
it). The script prints each version's median
and range, its device time, how far each version's result is from the
first's and whether it agrees with it: ``topk_scores``'s lists with scores
within the summation bound D * 2**-24 * sum |q c| and ids equal but at
near-ties (exact scores within twice the bound), f32 attention within the
reference's tolerance (rtol 1e-5, atol 2e-5) of the plain version, every
other result to the bit (``topk_scores_int8``'s exact dots and bf16
attention included), then one JSON line of it all. Run it from the
repository root on a machine with a card.
"""
from __future__ import annotations

import contextlib
import functools
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
GROUPS = ("dense", "int8", "gathered", "hamming", "lp", "flash")


def worker(src: str, conn) -> None:
    """Serve one checkout: take a case (an entry point's name and its
    arguments), then time it, profile it and return its result on
    request."""
    sys.path.insert(0, src)
    import torch
    import chip_smoke
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.label_prop.ops import label_prop_round
    from repro_torch.kernels.lsh_hamming.ops import hamming_topk
    from repro_torch.kernels.topk_scoring.ops import (gathered_topk,
                                                      launch_merge,
                                                      topk_scores,
                                                      topk_scores_int8)
    entry = {"topk_scores": topk_scores, "topk_scores_int8": topk_scores_int8,
             "gathered_topk": gathered_topk, "hamming_topk": hamming_topk,
             "label_prop_round": label_prop_round,
             "flash_attention": flash_attention,
             "launch_merge": launch_merge}
    import repro_torch
    conn.send(str(Path(repro_torch.__file__).parent))
    fn = None
    torch.set_grad_enabled(False)
    while (msg := conn.recv()) is not None:
        if msg[0] == "case":
            fn = functools.partial(entry[msg[1]], *msg[2], **msg[3])
            conn.send(None)
        elif msg[0] == "time":
            iters, warmup = msg[1:]
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
            conn.send(start.elapsed_time(end) / iters)
        else:                                   # "result"
            reps = msg[1]
            per_kernel = chip_smoke.device_profile(
                lambda: [fn() for _ in range(reps)])[2]
            out = fn()
            out = out if isinstance(out, tuple) else (out,)
            conn.send((chip_smoke.call_device_ms(per_kernel, reps),
                       tuple(t.cpu() for t in out)))
            fn = msg = None              # let the case's inputs go


def cases(groups):
    """Yield (label, entry point, args, kwargs, iters, warmup), making each
    group's inputs on the card as it comes."""
    import torch
    import chip_smoke as cs
    dev = torch.device("cuda")
    if "dense" in groups:
        q, c = cs.topk_inputs(128, 524288, 2048, seed=11, negative=False,
                              device=dev)
        for k in (3, 40):
            yield f"topk_scores k={k}", "topk_scores", (q, c), {"k": k}, 8, 2
        del q, c
        for label, (nq, n, d, k), iters in (
                ("grid search Q=256 N=39780", (256, 39780, 2048, 10), 20),
                ("tick Q=32 N=1048576 D=768", (32, 1048576, 768, 16), 20),
                ("retrieval Q=1 N=1000000 D=16", (1, 1000000, 16, 100), 50)):
            q, c = cs.topk_inputs(nq, n, d, seed=n + d, negative=False,
                                  device=dev)
            yield (f"topk_scores {label} k={k}", "topk_scores", (q, c),
                   {"k": k}, iters, 3)
            del q, c
    if "int8" in groups:
        q, c = cs.int8_inputs(128, 524288, 2048, seed=11, negative=False,
                              device=dev)
        for k in (10, 20, 40, 80):
            yield (f"topk_scores_int8 k={k}", "topk_scores_int8", (q, c),
                   {"k": k}, 8, 2)
        del q, c
        # the serving tick: a bucket of 32 over a tenant's codes at the
        # pool k 64 (the narrow path where a checkout has one)
        q = cs.card_int8(cs.SERVE_BATCH, cs.SERVE_DIM, seed=37, device=dev)
        c = cs.card_int8(cs.SERVE_DOCS, cs.SERVE_DIM, seed=41, device=dev)
        yield (f"topk_scores_int8 tick Q={cs.SERVE_BATCH} N={cs.SERVE_DOCS} "
               f"D={cs.SERVE_DIM} k={cs.INT8_POOL}", "topk_scores_int8",
               (q, c), {"k": cs.INT8_POOL}, 20, 3)
        del q, c
    if "gathered" in groups:
        from repro_torch.core import prng
        from repro_torch.retrieval.engines import IVFFlatEngine
        from repro_torch.retrieval.ivfflat import probe_candidates
        _, (ev_np, qv_np) = cs.eval_corpus(cs.EVAL_QUERIES, 2048)
        ev = torch.from_numpy(ev_np).to(dev)
        pq = torch.from_numpy(qv_np[:cs.PROBE_QUERIES]).to(dev)
        del ev_np, qv_np
        g = torch.Generator(device="cpu").manual_seed(19)
        proj = torch.randn(ev.shape[1], cs.ENCODER_DIM, generator=g).to(dev)
        engine = IVFFlatEngine()
        for label, vecs, qs, k, iters in (
                ("evaluation D2048 k10", lambda: ev, pq, 10, 3),
                ("one query D2048 k3", lambda: ev, pq[:1], 3, 20),
                ("table1 D128 k3",
                 lambda: torch.nn.functional.normalize(ev @ proj, dim=1),
                 torch.nn.functional.normalize(
                     pq[:cs.ENCODER_BATCH] @ proj, dim=1), 3, 10)):
            index = engine.build(prng.prng_key(0), vecs())
            rows, ids = probe_candidates(index, qs, nprobe=engine.nprobe)
            table = index.vecs.reshape(-1, index.vecs.shape[2])
            yield (f"gathered_topk {label}", "gathered_topk",
                   (qs, table, rows, ids), {"k": k}, iters, 1)
            del index, rows, ids, table
        # the merge alone on the f32 kernel's partial lists at Q 128 (k
        # 10: 1280 entries a row)
        from repro_torch.kernels.topk_scoring.ops import topk_partials_cuda
        part = topk_partials_cuda(pq[:128], ev, 10)
        yield (f"launch_merge Q=128 W={part[0].shape[1]} k=10",
               "launch_merge", part, {"k": 10}, 50, 3)
        del ev, pq, proj, part
        # the serving tick's ivfflat calls (normal rows of a tenant's size,
        # 64 lists, nprobe 8, k 16) at the gathered cutoff's Q values
        from repro_torch.kernels.topk_scoring.ops import (
            GATHERED_NARROW_QUERIES)
        g = torch.Generator(device=dev).manual_seed(43)
        vecs = torch.randn(cs.SERVE_DOCS, cs.SERVE_DIM, generator=g,
                           device=dev)
        index = engine.build(prng.prng_key(0), vecs)
        del vecs
        sq = torch.randn(cs.SERVE_BATCH, cs.SERVE_DIM, generator=g,
                         device=dev)
        rows, ids = probe_candidates(index, sq, nprobe=engine.nprobe)
        table = index.vecs.reshape(-1, cs.SERVE_DIM)
        del index
        for q in sorted({1, 2, 4, GATHERED_NARROW_QUERIES,
                         GATHERED_NARROW_QUERIES + 1, cs.SERVE_BATCH}):
            yield (f"gathered_topk tick Q={q} C={ids.shape[1]} k=16",
                   "gathered_topk", (sq[:q], table, rows[:q].contiguous(),
                                     ids[:q].contiguous()),
                   {"k": cs.SERVE_KMAX}, 20, 2)
        del sq, table, rows, ids
        # the merge alone at one query's widths: the pieces path's at the
        # tick (16,672 entries) and the runs path's (2049 runs x 16);
        # normal scores, each id once
        for width in (16672, 32784):
            part_s = torch.randn(1, width, generator=g, device=dev)
            part_i = torch.randperm(width, device=dev)[None].to(torch.int32)
            yield (f"launch_merge Q=1 W={width} k=16", "launch_merge",
                   (part_s, part_i), {"k": 16}, 50, 3)
            del part_s, part_i
    if "hamming" in groups:
        q, c = cs.hamming_inputs(cs.PROBE_QUERIES, 524288, 4, seed=17,
                                 device=dev)
        for k in (10, 64):
            yield f"hamming_topk k={k}", "hamming_topk", (q, c), {"k": k}, \
                20, 2
        del q, c
    if "lp" in groups:
        labels, nbr, wgt, _ = cs.lp_inputs(3_100_000, 32, seed=7,
                                           quarter=False, device=dev)
        yield ("label_prop_round N=3.1M K=32", "label_prop_round",
               (labels, nbr, wgt), {}, 20, 2)
        del labels, nbr, wgt
    if "flash" in groups:
        for label, shp, dtype, causal, iters in (
                ("passages", (256, 64, 64, 4, 4, 32), torch.float32, False,
                 200),
                ("queries", (256, 24, 24, 4, 4, 32), torch.float32, False,
                 200),
                ("S2048 bf16 causal", (1, 2048, 2048, 32, 4, 128),
                 torch.bfloat16, True, 10)):
            qkv = cs.attn_inputs(*shp, dtype=dtype, seed=7, device=dev)
            yield (f"flash_attention {label}", "flash_attention", qkv,
                   {"causal": causal}, iters, 5)
    torch.cuda.empty_cache()


def agrees(entry, args, kwargs, out, first) -> bool:
    """Whether a version's result agrees with the first version's: the f32
    search within its summation bound (ids equal but at near-ties); f32
    attention, whose kernels sum in other orders (FMAs on the CUDA cores,
    3xTF32 on the tensor cores), within the reference's tolerance of the
    plain version, as the first version is; every other entry point to the
    bit."""
    import torch
    if entry == "flash_attention" and args[0].dtype == torch.float32:
        import chip_smoke
        from repro_torch.kernels.flash_attention.ref import \
            flash_attention_ref
        rtol, atol = chip_smoke.ATTN_F32_TOL
        want = flash_attention_ref(*args, **kwargs)
        return all(torch.allclose(t.to(want.device), want, rtol=rtol,
                                  atol=atol) for t in (out[0], first[0]))
    if entry != "topk_scores":
        return all(torch.equal(a, b) for a, b in zip(out, first))
    q, c = args
    s, i, s0, i0 = (t.to(q.device) for t in (*out, *first))
    rows = lambda ids: c[ids.long().clamp(min=0)].double()
    tol = (c.shape[1] * 2.0 ** -24
           * torch.einsum("qd,qkd->qk", q.abs().double(), rows(i0).abs())
           + 1e-30)
    if bool(((s.double() - s0.double()).abs() > tol).any()):
        return False
    diff = i != i0
    exact = lambda ids: torch.einsum("qd,qkd->qk", q.double(), rows(ids))
    gap = (exact(i) - exact(i0)).abs()
    return bool((gap[diff] <= 2 * tol[diff]).all())


def main(trees, groups) -> None:
    import torch
    import torch.multiprocessing as mp
    if not torch.cuda.is_available():
        sys.exit("kernel_ab: no CUDA card")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"kernel_ab on {smi}", flush=True)
    labels = [str(t) for t in trees]
    ctx = mp.get_context("spawn")
    conns, procs = [], []
    for tree in trees:
        src = Path(tree).resolve() / "src"
        if not (src / "repro_torch").is_dir():
            sys.exit(f"kernel_ab: no src/repro_torch in {tree}")
        ours, theirs = ctx.Pipe()
        proc = ctx.Process(target=worker, args=(str(src), theirs))
        proc.start()
        theirs.close()                  # so a worker's exit ends recv()
        print(f"{tree}: {ours.recv()}", flush=True)
        conns.append(ours)
        procs.append(proc)
    results = {}
    try:
        for name, entry, args, kwargs, iters, warmup in cases(groups):
            for conn in conns:
                conn.send(("case", entry, args, kwargs))
                conn.recv()
            times = {lb: [] for lb in labels}
            order = list(range(len(trees)))
            for _ in range(3):
                for i in order + order[::-1]:
                    conns[i].send(("time", iters, warmup))
                    times[labels[i]].append(conns[i].recv())
            reps = min(iters, 50)
            dev_ms, outs = {}, []
            for lb, conn in zip(labels, conns):
                conn.send(("result", reps))
                dev_ms[lb], out = conn.recv()
                outs.append(out)
            diff = {lb: {"agrees": agrees(entry, args, kwargs, out,
                                          outs[0]),
                         "max_abs_diff": max(
                        (float((a.float() - b.float()).abs()
                               .nan_to_num(0.0).max()) if a.numel() else 0.0
                         for a, b in zip(out, outs[0])
                         if a.is_floating_point()), default=0.0),
                         "ints_differ": sum(int((a != b).sum())
                                            for a, b in zip(out, outs[0])
                                            if not a.is_floating_point())}
                    for lb, out in zip(labels, outs)}
            results[name] = {lb: {"ms": statistics.median(times[lb]),
                                  "ms_range": [min(times[lb]),
                                               max(times[lb])],
                                  "device_ms": dev_ms[lb], **diff[lb]}
                             for lb in labels}
            print(f"{name}: " + "; ".join(
                f"{lb} {r['ms']:.4f} ms [{r['ms_range'][0]:.4f}, "
                f"{r['ms_range'][1]:.4f}], device "
                + ("not measured" if r["device_ms"] is None
                   else f"{r['device_ms']:.4f}")
                + f", vs {labels[0]}: max |diff| {r['max_abs_diff']:.3e}, "
                f"{r['ints_differ']} ids differ, "
                + ("agrees" if r["agrees"] else "DISAGREES")
                for lb, r in results[name].items()), flush=True)
    finally:
        for conn, proc in zip(conns, procs):
            with contextlib.suppress(OSError):
                conn.send(None)
            proc.join()
    print(json.dumps({"kernel_ab": results, "device": smi}))


if __name__ == "__main__":
    argv = sys.argv[1:]
    only = GROUPS
    if "--only" in argv:
        i = argv.index("--only")
        only = tuple(argv[i + 1].split(","))
        del argv[i:i + 2]
    if len(argv) < 2 or not set(only) <= set(GROUPS):
        sys.exit(__doc__)
    main(argv, only)
