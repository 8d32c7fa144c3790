"""WindTunnel core on PyTorch (port of ``repro.core``).

GraphBuilder (Alg. 1) -> GraphSampler (Alg. 2, weighted label propagation +
cluster sampling) -> CorpusReconstructor, plus the Yule-Simon community-
structure analysis of §III-A, behind the ``SamplerSession`` front door,
with the legacy one-shot wrappers of ``core/pipeline.py`` and the
mesh-partitioned pipeline of ``core/sharded_pipeline.py``.
"""
from repro_torch.core.engines import (LPEngine, available_engines,
                                      get_engine, register, run_engine)
from repro_torch.core.graph_builder import (EdgeList, QRelTable,
                                            build_affinity_graph,
                                            node_degrees, symmetrize)
from repro_torch.core.label_prop import (edges_to_ell, ell_round, propagate,
                                         propagate_ell, sort_round)
from repro_torch.core.pipeline import (WindTunnelConfig, run_uniform_baseline,
                                       run_windtunnel)
from repro_torch.core.reconstructor import (associated_queries,
                                            query_density, reconstruct)
from repro_torch.core.sampler import cluster_sample, uniform_sample
from repro_torch.core.samplers import (SamplerStrategy, available_samplers,
                                       get_sampler, register_sampler)
from repro_torch.core.sampling_core import (SamplerDraw, SamplerSession,
                                            SamplerSpec, SweepResult,
                                            WindTunnelResult)
from repro_torch.core.sharded_pipeline import (run_windtunnel_sharded,
                                               sharded_graph_and_labels)
from repro_torch.core.yule_simon import YuleSimonFit, fit_em

__all__ = [
    "EdgeList", "QRelTable", "build_affinity_graph", "node_degrees",
    "symmetrize", "propagate", "propagate_ell", "edges_to_ell",
    "sort_round", "ell_round",
    "WindTunnelConfig", "run_windtunnel", "run_uniform_baseline",
    "run_windtunnel_sharded", "sharded_graph_and_labels",
    "LPEngine", "available_engines", "get_engine", "register", "run_engine",
    "SamplerStrategy", "available_samplers", "get_sampler",
    "register_sampler",
    "SamplerSpec", "SamplerSession", "SamplerDraw", "SweepResult",
    "WindTunnelResult", "associated_queries", "query_density",
    "reconstruct", "cluster_sample", "uniform_sample", "YuleSimonFit",
    "fit_em",
]
