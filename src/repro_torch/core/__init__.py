"""WindTunnel core on PyTorch (port of ``repro.core``, single device).

GraphBuilder (Alg. 1) -> GraphSampler (Alg. 2, weighted label propagation +
cluster sampling) -> CorpusReconstructor, plus the Yule-Simon community-
structure analysis of §III-A, behind the ``SamplerSession`` front door.
"""
from repro_torch.core.engines import (LPEngine, available_engines,
                                      get_engine, register, run_engine)
from repro_torch.core.graph_builder import (EdgeList, QRelTable,
                                            build_affinity_graph,
                                            node_degrees, symmetrize)
from repro_torch.core.label_prop import edges_to_ell, ell_round, sort_round
from repro_torch.core.reconstructor import (associated_queries,
                                            query_density, reconstruct)
from repro_torch.core.sampler import cluster_sample
from repro_torch.core.samplers import (SamplerStrategy, available_samplers,
                                       get_sampler, register_sampler)
from repro_torch.core.sampling_core import (SamplerDraw, SamplerSession,
                                            SamplerSpec, SweepResult,
                                            WindTunnelResult)
from repro_torch.core.yule_simon import YuleSimonFit, fit_em

__all__ = [
    "EdgeList", "QRelTable", "build_affinity_graph", "node_degrees",
    "symmetrize", "edges_to_ell", "sort_round", "ell_round",
    "LPEngine", "available_engines", "get_engine", "register", "run_engine",
    "SamplerStrategy", "available_samplers", "get_sampler",
    "register_sampler",
    "SamplerSpec", "SamplerSession", "SamplerDraw", "SweepResult",
    "WindTunnelResult", "associated_queries", "query_density",
    "reconstruct", "cluster_sample", "YuleSimonFit",
    "fit_em",
]
