"""Shared timing + provenance helpers (port of ``repro/obs/timing.py``).

``timeit`` is the one wall-clock timer (DESIGN.md §12): warm up once with
every output retired, so kernel builds and allocator warm-up land before
t0, then report the mean wall microseconds of n fully-retired calls. A
call is retired by ``torch.cuda.synchronize`` on the devices of its CUDA
outputs (CUDA launches return before the card finishes), and by nothing
on the CPU.

``cuda_ms`` is the device timer: CUDA events recorded around a run of
calls after a warm-up, so host time between launches that the card
overlaps does not count. The autotuner scores its candidates with it
(``kernels/tuning.measure``), and ``chip_smoke.py`` times every kernel
with it. It raises on a host with no card.

``provenance`` stamps the host/device/toolchain identity (platform, torch
and CUDA toolkit versions, backend, device kind/count, git SHA) into
artifacts — perf trajectories across machines are uninterpretable without
it.
"""
from __future__ import annotations

import os
import platform
import subprocess
import time
from typing import Callable, Optional

from repro_torch.obs.trace import _synchronize

__all__ = ["cuda_ms", "git_sha", "provenance", "timeit"]


def timeit(fn: Callable, n: int = 3) -> float:
    """Mean wall microseconds of ``fn()`` over ``n`` fully-retired calls,
    after one warmup call (builds and first-call work retired before
    timing)."""
    _synchronize(fn())
    t0 = time.perf_counter()
    for _ in range(n):
        _synchronize(fn())
    return (time.perf_counter() - t0) / n * 1e6


def cuda_ms(fn: Callable, iters: int, warmup: int = 2) -> float:
    """Mean device milliseconds a call of ``fn()`` over ``iters`` calls
    on the current CUDA device, between two CUDA events, after ``warmup``
    calls."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_ms times on the card, and "
                           "torch.cuda.is_available() is False")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def git_sha(cwd: Optional[str] = None) -> Optional[str]:
    """Short git SHA of the working tree (CI env fallback), else None."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=cwd,
            capture_output=True, text=True, timeout=5)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    sha = os.environ.get("GITHUB_SHA")
    return sha[:12] if sha else None


def provenance() -> dict:
    """Host/device/toolchain identity for bench + trace artifacts:
    ``backend`` is ``cuda`` where a card is visible, else ``cpu``;
    ``cuda`` is the toolkit version torch was built with (None on a
    CPU-only build)."""
    import torch
    on_card = torch.cuda.is_available()
    return {
        "platform": platform.platform(),
        "python": platform.python_version(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "backend": "cuda" if on_card else "cpu",
        "device_kind": (torch.cuda.get_device_name(0) if on_card
                        else platform.processor() or platform.machine()),
        "device_count": torch.cuda.device_count() if on_card else 1,
        "git_sha": git_sha(os.path.dirname(os.path.abspath(__file__))),
    }
