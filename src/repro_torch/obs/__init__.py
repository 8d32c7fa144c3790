"""Observability for the port (DESIGN.md §12): the span tracer and the
metrics registry, copied from ``repro.obs`` with ``device_span`` in place of
``jax_span``. Timing, memory, recompile and lock instrumentation are still
to be ported (ROADMAP queue 1 item 11).
"""
from repro_torch.obs import trace
from repro_torch.obs.metrics import (DEFAULT_BUCKETS, REGISTRY, Counter,
                                     Gauge, Histogram, Registry)

__all__ = ["trace", "DEFAULT_BUCKETS", "REGISTRY", "Counter", "Gauge",
           "Histogram", "Registry"]
