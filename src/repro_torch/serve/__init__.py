"""The retrieval serving tier (port of ``repro.serve``): microbatch
scheduler, tenant cache, live ingest, load generator, frontend and server.
The reference's decoder-backed names (``ServeEngine``, ``ServeConfig``,
``RagEngine``) come with ROADMAP.md queue 1 item 15."""
from repro_torch.serve.engine import RetrievalFrontend, SearchServer
from repro_torch.serve.ingest import IngestConfig, LiveIndex
from repro_torch.serve.loadgen import LoadReport, LoadSpec, run_load
from repro_torch.serve.scheduler import (MicrobatchScheduler, PendingResult,
                                         SchedulerConfig)
from repro_torch.serve.tenants import LRUCache, TenantCache

__all__ = ["RetrievalFrontend", "SearchServer", "IngestConfig", "LiveIndex",
           "LoadSpec", "LoadReport", "run_load", "MicrobatchScheduler",
           "PendingResult", "SchedulerConfig", "LRUCache", "TenantCache"]
