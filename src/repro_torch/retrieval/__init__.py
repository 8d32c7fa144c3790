"""Retrieval on PyTorch (port of ``repro.retrieval``): the scoring-backend
registry, the exact, ivfflat, lsh and tf-idf engines, the search-core front
door (mesh-sharded search included), the retrieval encoder and the IR
metrics."""
from repro_torch.retrieval.encoder import (EncoderConfig, contrastive_loss,
                                           embed_tokens, init_encoder)
from repro_torch.retrieval.backends import (ScoringBackend,
                                            available_backends, get_backend,
                                            register_backend)
from repro_torch.retrieval.exact import exact_topk
from repro_torch.retrieval.ivfflat import (IVFFlatIndex, build_ivfflat,
                                           search_ivfflat)
from repro_torch.retrieval.lsh import LSHIndex, build_lsh, search_lsh
from repro_torch.retrieval.engines import (RetrievalEngine,
                                           available_retrieval_engines,
                                           get_retrieval_engine,
                                           register_retrieval_engine)
from repro_torch.retrieval.sharded import sharded_search
from repro_torch.retrieval.search_core import SearchConfig, SearchSession
from repro_torch.retrieval.metrics import (mrr, ndcg_at_k, precision_at_k,
                                           qrel_dict, qrel_set, recall_at_k)

__all__ = ["EncoderConfig", "init_encoder", "contrastive_loss",
           "embed_tokens",
           "ScoringBackend", "available_backends", "get_backend",
           "register_backend",
           "exact_topk", "IVFFlatIndex", "build_ivfflat",
           "search_ivfflat", "LSHIndex", "build_lsh", "search_lsh",
           "RetrievalEngine", "available_retrieval_engines",
           "get_retrieval_engine", "register_retrieval_engine",
           "sharded_search", "SearchConfig", "SearchSession",
           "precision_at_k", "recall_at_k", "ndcg_at_k", "mrr",
           "qrel_set", "qrel_dict"]
