"""Retrieval-engine registry — the eval subsystem's façade over
``repro_torch.retrieval.engines``, where the implementation lives (port of
``repro/eval/engines.py``)."""
from repro_torch.retrieval.engines import (ExactEngine, IVFFlatEngine,
                                           LSHEngine, RetrievalEngine,
                                           TfIdfEngine, TfIdfIndex,
                                           available_retrieval_engines,
                                           get_retrieval_engine,
                                           register_retrieval_engine)

__all__ = [
    "RetrievalEngine", "available_retrieval_engines",
    "get_retrieval_engine", "register_retrieval_engine",
    "ExactEngine", "IVFFlatEngine", "LSHEngine", "TfIdfEngine", "TfIdfIndex",
]
