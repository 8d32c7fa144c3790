"""Per-device memory accounting for index and graph builds (port of
``repro/obs/memory.py``).

:func:`bytes_per_device` reads the CUDA caching allocator's high-water
mark, ``torch.cuda.max_memory_allocated``, for each visible card: the most
bytes of tensors the process has held there since it started or since the
last ``torch.cuda.reset_peak_memory_stats``. On a host with no card it
returns an empty dict: PyTorch's CPU allocator keeps no statistics, and
the port does not walk the heap for live tensors in their place, so the
CPU has no reading (the gauge below then reads 0).

:func:`record_build_peak` publishes the worst card as the
``build.peak_bytes_per_device`` gauge; ``SearchSession`` calls it after
every index build, so the figure lands in ``--metrics-json`` exports.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.obs.metrics import REGISTRY, Registry

__all__ = ["PEAK_GAUGE", "bytes_per_device", "record_build_peak"]

#: gauge name for the per-device build high-water mark
PEAK_GAUGE = "build.peak_bytes_per_device"


def bytes_per_device() -> Dict[str, int]:
    """card ("cuda:<i>") -> the allocator's peak bytes; empty without a
    card."""
    import torch
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": int(torch.cuda.max_memory_allocated(i))
            for i in range(torch.cuda.device_count())}


def record_build_peak(registry: Registry = REGISTRY) -> int:
    """Publish max-over-devices peak bytes as the build gauge."""
    per = bytes_per_device()
    peak = max(per.values(), default=0)
    registry.gauge(PEAK_GAUGE).set(peak)
    return int(peak)
