#!/usr/bin/env python3
"""Why the narrow select reads slow beside a background compaction.

    python3 tools/select_compaction.py [--requests 4096]

From the repository root, on a machine with a card. Runs the serve CLI
with the arguments of ``chip_smoke.py``'s phase 15a (two tenants of
1,048,576 x 768, buckets up to 32, k_max 16, live appends to tenant-0 and
background compactions) inside one ``torch.profiler`` window, with CUDA
events recorded around every kernel launch (``Kernel.timed``, as the
phases' device-time sums are taken). For each ``topk_narrow_select``
launch it then sets side by side:

- its event time (the two events around the launch, on its stream);
- its own device time (the profiler's kernel record: start to end);
- the queue wait: from the end of its ``cudaLaunchCooperativeKernel``
  call on the host to the kernel's start on the card;
- the kernels of other names that ran on the card between the scorer of
  the same tick and the select: work another thread enqueued between the
  two events.

A cooperative launch that waited for its blocks to fit beside other work
would show as device or queue time; work enqueued between the events
(both threads enqueue on one stream) as the event time's excess over the
device time. Prints the medians and the largest of each, the launches
whose event time exceeds twice their device time with what ran inside,
the card's name and power limit, and one JSON line.
"""
from __future__ import annotations

import collections
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(requests: int) -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("select_compaction: no CUDA card")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.build import Kernel
    from repro_torch.kernels.topk_scoring import ops  # noqa: F401 (kernels)
    from repro_torch.launch import serve as serve_cli
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out_dir = ROOT / "build" / "select_compaction"
    out_dir.mkdir(parents=True, exist_ok=True)
    argv = ["--docs", str(cs.SERVE_DOCS), "--dim", str(cs.SERVE_DIM),
            "--k", str(cs.SERVE_K), "--k-max", str(cs.SERVE_KMAX),
            "--max-batch", str(cs.SERVE_BATCH), "--rate", "inf",
            "--device", "cuda", "--engine", "exact", "--backend", "cuda",
            "--tenants", "2", "--max-tenants", "2",
            "--append-every", "512", "--append-rows", "256",
            "--append-cap", "256", "--compact-threshold", "1024",
            "--requests", str(requests),
            "--out", str(out_dir / "serve.json")]
    # the tenants' host draws come first, outside the window
    drawn = {t: serve_cli._tenant_corpus(t, docs=cs.SERVE_DOCS,
                                         dim=cs.SERVE_DIM, seed=0)
             for t in ("tenant-0", "tenant-1")}
    serve_cli._tenant_corpus = lambda t, **kw: drawn[t]
    torch.cuda.synchronize()
    Kernel.timed = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rc = serve_cli.main(argv)
        torch.cuda.synchronize()
    timed, Kernel.timed = Kernel.timed, None
    if rc != 0:
        sys.exit(f"select_compaction: the serve CLI exited {rc}")
    path = out_dir / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.load(open(path))["traceEvents"]
    os.remove(path)
    row = json.load(open(out_dir / "serve.json"))
    kernels = sorted((e for e in events if e.get("cat") == "kernel"),
                     key=lambda e: e["ts"])
    runtime = {e["args"].get("correlation"): e for e in events
               if e.get("cat") == "cuda_runtime" and "args" in e}
    ev_ms = [a.elapsed_time(b) for name, a, b in timed
             if name == "topk_narrow_select"]
    sel = [i for i, e in enumerate(kernels) if "narrow_select" in e["name"]]
    if not sel or len(sel) != len(ev_ms):
        print(f"select_compaction: {len(sel)} select kernels in the trace, "
              f"{len(ev_ms)} launches timed: paired by order where they "
              f"agree in number, else not measured", flush=True)
    recs = []
    for n, i in enumerate(sel):
        e = kernels[i]
        rt = runtime.get(e["args"].get("correlation"))
        wait = (e["ts"] - rt["ts"] - rt["dur"]) / 1e3 if rt else None
        # back to the tick's scorer; what ran between it and the select
        j = i - 1
        while j >= 0 and "narrow_scores" not in kernels[j]["name"]:
            j -= 1
        between = [kernels[x]["name"] for x in range(j + 1, i)]
        gap = ((e["ts"] - kernels[j]["ts"] - kernels[j]["dur"]) / 1e3
               if j >= 0 else None)
        recs.append({"device_ms": e["dur"] / 1e3, "queue_ms": wait,
                     "gap_ms": gap, "between": between,
                     "event_ms": ev_ms[n] if len(sel) == len(ev_ms)
                     else None})

    def stats(key):
        xs = [r[key] for r in recs if r[key] is not None]
        return ({"median": statistics.median(xs), "max": max(xs),
                 "mean": sum(xs) / len(xs), "n": len(xs)} if xs else None)

    slow = [r for r in recs if r["event_ms"] is not None
            and r["event_ms"] > 2 * r["device_ms"]]
    inside = collections.Counter(name[:80] for r in slow
                                 for name in r["between"])
    result = {"device": smi, "requests": requests, "row": row,
              "selects": len(recs),
              **{k: stats(k) for k in ("event_ms", "device_ms", "queue_ms",
                                       "gap_ms")},
              "slow": len(slow),
              "slow_event_ms": sum(r["event_ms"] for r in slow),
              "slow_device_ms": sum(r["device_ms"] for r in slow),
              "with_work_between": sum(bool(r["between"]) for r in recs),
              "slow_with_work_between": sum(bool(r["between"])
                                            for r in slow),
              "between_slow": inside.most_common(12)}
    for key in ("event_ms", "device_ms", "queue_ms", "gap_ms"):
        s = result[key]
        print(f"select {key}: " + ("not measured" if s is None else
                                   f"median {s['median']:.4f}, mean "
                                   f"{s['mean']:.4f}, max {s['max']:.4f} "
                                   f"over {s['n']}"), flush=True)
    print(f"{len(slow)} of {len(recs)} selects with event time above twice "
          f"their device time ({result['slow_event_ms']:.3f} ms of events "
          f"against {result['slow_device_ms']:.3f} ms on the device), "
          f"{result['slow_with_work_between']} of them with other kernels "
          f"between the tick's scorer and the select "
          f"({result['with_work_between']} of all); inside them: "
          f"{inside.most_common(12)}; serve row {json.dumps(row)}; {smi}",
          flush=True)
    print(json.dumps(result))


if __name__ == "__main__":
    argv = sys.argv[1:]
    n = 4096
    if argv[:1] == ["--requests"] and len(argv) == 2:
        n = int(argv[1])
    elif argv:
        sys.exit(__doc__)
    main(n)
