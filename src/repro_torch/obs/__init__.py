"""Unified observability layer for the port (port of ``repro.obs``;
DESIGN.md §12): structured span tracing, a metrics registry, the shared
timer, memory accounting, the recompile sentinel and debug locks.

  * :mod:`repro_torch.obs.trace`   — nested spans -> JSONL sink; strict
    no-op when disabled (the default); ``REPRO_TRACE=<path>`` or
    ``--trace`` enables it; ``device_span`` in place of ``jax_span``.
    Read traces back with ``python -m repro_torch.launch.trace``.
  * :mod:`repro_torch.obs.metrics` — counters / gauges / fixed-bucket
    histograms with p50/p90/p99, snapshot-to-dict for JSON export.
  * :mod:`repro_torch.obs.timing`  — ``timeit`` (wall clock, CUDA outputs
    synchronized) and ``provenance`` (host/device/git identity).
  * :mod:`repro_torch.obs.memory`  — the CUDA allocator's peak bytes per
    card and the ``build.peak_bytes_per_device`` gauge.
  * :mod:`repro_torch.obs.recompile` — nvcc builds of the CUDA kernels
    counted per region, asserted zero in steady state.
  * :mod:`repro_torch.obs.locks`   — instrumented debug locks recording
    acquisition order and counts (``REPRO_DEBUG_LOCKS=1``).
"""
from repro_torch.obs import locks, memory, recompile, trace
from repro_torch.obs.locks import make_lock, make_rlock
from repro_torch.obs.metrics import (DEFAULT_BUCKETS, REGISTRY, Counter,
                                     Gauge, Histogram, Registry)
from repro_torch.obs.timing import git_sha, provenance, timeit

__all__ = ["locks", "memory", "recompile", "trace", "make_lock",
           "make_rlock", "DEFAULT_BUCKETS", "REGISTRY", "Counter", "Gauge",
           "Histogram", "Registry", "git_sha", "provenance", "timeit"]
