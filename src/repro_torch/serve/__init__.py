"""Serving (port of ``repro.serve``): the continuous-batching decoder and
its RAG front, and the retrieval serving tier — microbatch scheduler,
tenant cache, live ingest, load generator, frontend and server."""
from repro_torch.serve.engine import (RagEngine, RetrievalFrontend,
                                      SearchServer, ServeConfig, ServeEngine)
from repro_torch.serve.ingest import IngestConfig, LiveIndex
from repro_torch.serve.loadgen import LoadReport, LoadSpec, run_load
from repro_torch.serve.scheduler import (MicrobatchScheduler, PendingResult,
                                         SchedulerConfig)
from repro_torch.serve.tenants import LRUCache, TenantCache

__all__ = ["ServeEngine", "ServeConfig", "RetrievalFrontend", "RagEngine",
           "SearchServer", "IngestConfig", "LiveIndex", "LoadSpec",
           "LoadReport", "run_load", "MicrobatchScheduler", "PendingResult",
           "SchedulerConfig", "LRUCache", "TenantCache"]
