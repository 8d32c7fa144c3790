"""Experiment-grid evaluation subsystem on PyTorch (port of ``repro.eval``).

* ``engines``  — the retrieval-engine registry façade (exact / ivfflat /
  lsh / tfidf).
* ``plans``    — declarative (sampler × engine × k × metric) grids expanded
  into a stage trie; shared prefixes execute exactly once.
* ``runner``   — stage implementations walking each grid cell through the
  trie over a :class:`~repro_torch.data.synthetic.SyntheticCorpus`.
* ``fidelity`` — per-metric deltas of each sampler vs the full corpus and
  Kendall-τ preservation of the engine ranking.
"""
from repro_torch.core.samplers import get_sampler
from repro_torch.core.sampling_core import SamplerSession, SamplerSpec
from repro_torch.eval.engines import (RetrievalEngine,
                                      available_retrieval_engines,
                                      get_retrieval_engine,
                                      register_retrieval_engine)
from repro_torch.eval.fidelity import (FidelityReport, backend_recall_curve,
                                       build_fidelity_report,
                                       format_backend_curve,
                                       format_fidelity_report, kendall_tau)
from repro_torch.eval.plans import (GridSpec, PlanTrie, RunSpec,
                                    execute_plan, expand_grid)
from repro_torch.eval.runner import (GridResult, available_samplers,
                                     run_grid, tfidf_embedder)
from repro_torch.retrieval.backends import available_backends, get_backend
from repro_torch.retrieval.search_core import SearchConfig, SearchSession

__all__ = [
    "RetrievalEngine", "available_retrieval_engines", "get_retrieval_engine",
    "register_retrieval_engine",
    "get_sampler", "SamplerSpec", "SamplerSession",
    "available_backends", "get_backend", "SearchConfig", "SearchSession",
    "GridSpec", "RunSpec", "PlanTrie", "expand_grid", "execute_plan",
    "GridResult", "run_grid", "tfidf_embedder", "available_samplers",
    "FidelityReport", "build_fidelity_report", "format_fidelity_report",
    "kendall_tau", "backend_recall_curve", "format_backend_curve",
]
