"""Trace reader CLI (port of ``repro/launch/trace.py``; DESIGN.md §12) —
per-stage aggregates from a span JSONL produced by ``repro_torch.obs.trace``
(``REPRO_TRACE=<path>`` or the CLIs' ``--trace``).

  PYTHONPATH=src python -m repro_torch.launch.trace results/trace.jsonl
  PYTHONPATH=src python -m repro_torch.launch.trace trace.jsonl --json -
  PYTHONPATH=src python -m repro_torch.launch.trace trace.jsonl --sort name

Per span name: count, total/mean wall seconds, exact p50/p99 over the
recorded durations, and — for device-aware spans (``device_span``) — the
compile share: the fraction of total stage time spent in *first* calls
beyond the steady-state cost. A ``device_span`` record carries
``first: true`` the first time its compile key is seen in the process,
which is where the first call's one-off work lands: nvcc builds of the
CUDA kernels, their loading, the caching allocator's first requests.
With one call and no steady sample the whole first-call time is reported
as the (upper-bound) compile share.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Iterable, List, Optional

__all__ = ["aggregate", "format_table", "load_spans", "main"]


def load_spans(path: str) -> List[dict]:
    """Parse one span record per JSONL line (blank lines skipped)."""
    spans = []
    with open(path, encoding="utf-8") as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                spans.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(
                    f"{path}:{lineno}: not a JSON span record: {e}") from e
    return spans


def _percentile(sorted_vals: List[float], p: float) -> float:
    """Exact percentile (linear interpolation between closest ranks)."""
    if not sorted_vals:
        return 0.0
    if len(sorted_vals) == 1:
        return sorted_vals[0]
    pos = p / 100.0 * (len(sorted_vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    return sorted_vals[lo] + (pos - lo) * (sorted_vals[hi] - sorted_vals[lo])


def aggregate(spans: Iterable[dict], *,
              prefix: Optional[str] = None) -> Dict[str, dict]:
    """name -> {count, total_s, mean_s, p50_s, p99_s, first_count,
    compile_s, compile_share, errors}.  ``prefix`` keeps only span names
    under one namespace (e.g. ``serve.`` isolates the serving tier's
    ``serve.tick``/``serve.batch``/``serve.compact`` spans from a trace
    that also recorded builds and evals)."""
    by_name: Dict[str, List[dict]] = {}
    for rec in spans:
        name = rec.get("name", "?")
        if prefix is not None and not name.startswith(prefix):
            continue
        by_name.setdefault(name, []).append(rec)
    out: Dict[str, dict] = {}
    for name, recs in sorted(by_name.items()):
        durs = sorted(float(r.get("dur_s", 0.0)) for r in recs)
        total = sum(durs)
        first = [float(r.get("dur_s", 0.0)) for r in recs
                 if r.get("first") is True]
        steady = [float(r.get("dur_s", 0.0)) for r in recs
                  if r.get("first") is False]
        if first:
            steady_mean = (sum(steady) / len(steady)) if steady else 0.0
            compile_s = max(sum(first) - steady_mean * len(first), 0.0)
        else:
            compile_s = 0.0
        out[name] = {
            "count": len(recs),
            "total_s": total,
            "mean_s": total / len(recs),
            "p50_s": _percentile(durs, 50),
            "p99_s": _percentile(durs, 99),
            "first_count": len(first),
            "compile_s": compile_s,
            "compile_share": compile_s / total if total > 0 else 0.0,
            "errors": sum(1 for r in recs if "error" in r),
        }
    return out


def format_table(aggs: Dict[str, dict], *, sort: str = "name") -> str:
    rows = sorted(aggs.items(),
                  key=(lambda kv: -kv[1]["total_s"]) if sort == "total"
                  else (lambda kv: kv[0]))
    width = max([len(n) for n in aggs] + [5])
    lines = [f"{'stage':<{width}s} {'count':>6s} {'total_s':>9s} "
             f"{'mean_s':>9s} {'p50_s':>9s} {'p99_s':>9s} {'compile%':>8s}"]
    for name, a in rows:
        share = (f"{a['compile_share'] * 100:7.1f}%"
                 if a["first_count"] else f"{'-':>8s}")
        lines.append(
            f"{name:<{width}s} {a['count']:6d} {a['total_s']:9.4f} "
            f"{a['mean_s']:9.5f} {a['p50_s']:9.5f} {a['p99_s']:9.5f} "
            f"{share}")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="aggregate a repro_torch.obs.trace span JSONL per stage")
    p.add_argument("path", help="trace JSONL (REPRO_TRACE / --trace sink)")
    p.add_argument("--json", default=None, metavar="PATH",
                   help="write {spans, stages} JSON to PATH ('-' = stdout)")
    p.add_argument("--sort", default="total", choices=("name", "total"),
                   help="table order (default: total time, descending)")
    p.add_argument("--filter", default=None, metavar="PREFIX",
                   help="only aggregate span names starting with PREFIX "
                        "(e.g. 'serve.' for the serving tier)")
    args = p.parse_args(argv)
    try:
        spans = load_spans(args.path)
    except OSError as e:
        print(f"error: cannot read trace: {e}", file=sys.stderr)
        return 2
    aggs = aggregate(spans, prefix=args.filter)
    if args.json:
        payload = json.dumps({"spans": len(spans), "stages": aggs}, indent=2)
        if args.json == "-":
            print(payload)
        else:
            with open(args.json, "w") as f:
                f.write(payload + "\n")
    if args.json != "-":
        print(f"{len(spans)} spans in {args.path}")
        print(format_table(aggs, sort=args.sort))
    return 0


if __name__ == "__main__":
    sys.exit(main())
