"""Sample-fidelity report — does the sample preserve experimental
conclusions? (paper §I). Port of ``repro/eval/fidelity.py``.

Two views on a finished :class:`~repro_torch.eval.runner.GridResult`:

* **Metric deltas** — per cell, value(sampler) − value(baseline) for the
  same (engine, k, metric); aggregated to mean |Δ| per (sampler, metric).
  Small deltas mean absolute numbers survive sampling.
* **System-ranking preservation** — for each (metric, k) the grid induces a
  ranking of retrieval engines; Kendall-τ between each sampler's ranking
  and the full corpus's, plus whether the *winning* engine agrees.  This is
  the question the paper's §I poses: can the cheap sample pick the same
  winning system as the full corpus would?

Plus one backend-level view, :func:`backend_recall_curve`: recall@k vs
wall-clock of every registered scoring backend that runs on the device,
against the exact ``torch`` oracle on the same vectors.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np

import torch

from repro_torch.device import resolve_device
from repro_torch.eval.plans import GridSpec


def kendall_tau(a: Sequence[float], b: Sequence[float]) -> float:
    """Kendall's τ-b between two score vectors over the same systems
    (tie-corrected; O(n²), fine for system-ranking sized inputs)."""
    a = np.asarray(a, float)
    b = np.asarray(b, float)
    if a.size != b.size:
        raise ValueError(f"score vectors differ in length: {a.size} vs {b.size}")
    conc = disc = ties_a = ties_b = 0
    for i in range(a.size):
        for j in range(i + 1, a.size):
            sa = np.sign(a[i] - a[j])
            sb = np.sign(b[i] - b[j])
            if sa == 0 and sb == 0:
                continue
            elif sa == 0:
                ties_a += 1
            elif sb == 0:
                ties_b += 1
            elif sa == sb:
                conc += 1
            else:
                disc += 1
    denom = np.sqrt(float(conc + disc + ties_a) * float(conc + disc + ties_b))
    return float((conc - disc) / denom) if denom > 0 else 0.0


@dataclasses.dataclass
class FidelityReport:
    baseline: str
    #: (sampler, engine, k, metric) -> value(sampler) - value(baseline)
    cell_deltas: Dict[Tuple[str, str, int, str], float]
    #: (sampler, metric) -> mean |delta| over engines and ks
    mean_abs_delta: Dict[Tuple[str, str], float]
    #: (sampler, metric) -> mean Kendall-tau over ks vs the baseline ranking
    tau: Dict[Tuple[str, str], float]
    #: (sampler, metric) -> engine with the best mean-over-k score
    winners: Dict[Tuple[str, str], str]
    #: (sampler, metric) -> winner matches the baseline's winner
    winner_agreement: Dict[Tuple[str, str], bool]

    def to_json(self) -> dict:
        return {
            "baseline": self.baseline,
            "cell_deltas": [{"sampler": s, "engine": e, "k": k, "metric": m,
                             "delta": d}
                            for (s, e, k, m), d
                            in sorted(self.cell_deltas.items())],
            "mean_abs_delta": [{"sampler": s, "metric": m, "value": v}
                               for (s, m), v
                               in sorted(self.mean_abs_delta.items())],
            "kendall_tau": [{"sampler": s, "metric": m, "value": v}
                            for (s, m), v in sorted(self.tau.items())],
            "winners": [{"sampler": s, "metric": m, "engine": e,
                         "agrees_with_baseline":
                             self.winner_agreement.get((s, m), True)}
                        for (s, m), e in sorted(self.winners.items())],
        }


def _engine_scores(cells, sampler: str, metric: str, k: int,
                   engines: Sequence[str]):
    return [cells[(sampler, e, k, metric)] for e in engines]


def build_fidelity_report(cells: Dict[Tuple[str, str, int, str], float],
                          spec: GridSpec, *, baseline: str = "full"
                          ) -> FidelityReport:
    if baseline not in spec.samplers:
        raise ValueError(f"baseline sampler {baseline!r} not in grid "
                         f"{spec.samplers}")
    others = [s for s in spec.samplers if s != baseline]

    cell_deltas = {}
    for s in others:
        for e in spec.engines:
            for k in spec.ks:
                for m in spec.metrics:
                    cell_deltas[(s, e, k, m)] = (
                        cells[(s, e, k, m)] - cells[(baseline, e, k, m)])

    mean_abs_delta = {}
    for s in others:
        for m in spec.metrics:
            ds = [abs(cell_deltas[(s, e, k, m)])
                  for e in spec.engines for k in spec.ks]
            mean_abs_delta[(s, m)] = float(np.mean(ds))

    tau = {}
    for s in others:
        for m in spec.metrics:
            taus = [kendall_tau(
                _engine_scores(cells, s, m, k, spec.engines),
                _engine_scores(cells, baseline, m, k, spec.engines))
                for k in spec.ks]
            tau[(s, m)] = float(np.mean(taus))

    winners = {}
    for s in spec.samplers:
        for m in spec.metrics:
            mean_over_k = [np.mean([cells[(s, e, k, m)] for k in spec.ks])
                           for e in spec.engines]
            winners[(s, m)] = spec.engines[int(np.argmax(mean_over_k))]
    winner_agreement = {(s, m): winners[(s, m)] == winners[(baseline, m)]
                        for s in others for m in spec.metrics}

    return FidelityReport(baseline, cell_deltas, mean_abs_delta, tau,
                          winners, winner_agreement)


def backend_recall_curve(corpus_vecs, queries, *, k: int = 10,
                         rerank_factors: Sequence[int] = (1, 2, 4, 8),
                         timing_iters: int = 3, device="cuda") -> List[dict]:
    """Recall@k + us/query-batch of every registered scoring backend that
    runs on ``device`` vs the exact ``torch`` oracle, the ``int8`` backend
    swept over ``rerank_factor`` (its recall-vs-speed knob). Corpus
    preparation (quantization) is excluded from the timing: it is a
    build-time cost. A CUDA timing synchronizes the device around the
    calls, or it would time the enqueue.

    Returns one row dict per point: ``{"backend", "rerank_factor",
    "recall_at_k", "us_per_call"}`` (rerank_factor is None for the float
    backends)."""
    from repro_torch.retrieval.backends import available_backends, get_backend

    dev = resolve_device(device)
    corpus_vecs = torch.as_tensor(corpus_vecs).to(dev)
    queries = torch.as_tensor(queries).to(dev)
    k = min(k, int(corpus_vecs.shape[0]))
    exact = get_backend("torch").topk(queries, corpus_vecs, k=k)[1].cpu()

    def _sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _point(backend, label, rf):
        prepared = backend.prepare_corpus(corpus_vecs)
        ids = backend.topk(queries, prepared, k=k)[1].cpu()
        hits = [len(set(a.tolist()) & set(b.tolist())) / max(k, 1)
                for a, b in zip(ids, exact)]
        _sync()
        t0 = time.time()
        for _ in range(timing_iters):
            backend.topk(queries, prepared, k=k)
        _sync()
        us = (time.time() - t0) / timing_iters * 1e6
        return {"backend": label, "rerank_factor": rf,
                "recall_at_k": float(np.mean(hits)),
                "us_per_call": float(us)}

    rows = []
    for name in available_backends():
        backend = get_backend(name)
        if backend.needs_cuda and dev.type != "cuda":
            continue
        if name == "int8":
            for rf in rerank_factors:
                rows.append(_point(
                    dataclasses.replace(backend, rerank_factor=rf), name, rf))
        else:
            rows.append(_point(backend, name, None))
    return rows


def format_backend_curve(rows: Sequence[dict], *, k: int = 10) -> str:
    """Human-readable recall-vs-speed block for the fidelity output."""
    lines = [f"backend recall-vs-speed (recall@{k} vs torch exact)",
             f"  {'backend':<10s} {'rerank':>6s} {'recall':>8s} "
             f"{'us/call':>10s}"]
    for r in rows:
        rf = "-" if r["rerank_factor"] is None else str(r["rerank_factor"])
        lines.append(f"  {r['backend']:<10s} {rf:>6s} "
                     f"{r['recall_at_k']:8.4f} {r['us_per_call']:10.1f}")
    return "\n".join(lines)


def format_fidelity_report(report: FidelityReport, spec: GridSpec) -> str:
    """Human-readable fidelity table, one block per non-baseline sampler."""
    others = [s for s in spec.samplers if s != report.baseline]
    lines = [f"sample-fidelity report (baseline: {report.baseline})",
             ""]
    for s in others:
        lines.append(f"[{s}]")
        lines.append(f"  {'metric':<10s} {'mean|Δ|':>8s} {'τ(rank)':>8s} "
                     f"{'winner':>8s}  agrees")
        for m in spec.metrics:
            win = report.winners[(s, m)]
            agree = "yes" if report.winner_agreement[(s, m)] else "NO"
            lines.append(f"  {m:<10s} {report.mean_abs_delta[(s, m)]:8.4f} "
                         f"{report.tau[(s, m)]:8.3f} {win:>8s}  {agree}")
        lines.append("")
    base = ", ".join(f"{m}:{report.winners[(report.baseline, m)]}"
                     for m in spec.metrics)
    lines.append(f"baseline winners — {base}")
    return "\n".join(lines)
