"""Recompile sentinel (port of ``repro/obs/recompile.py``): count kernel
compilations per region at runtime.

The port has no XLA and no ``torch.compile``: what it compiles is its
hand-written CUDA sources, one ``nvcc`` run each, in
``kernels/build.py::_build``. Each such build calls :func:`report` with
:data:`COMPILE_EVENT` once it has produced its library (a library already
built, found by its content hash and only loaded, is not reported), and
the sentinel attributes it to the innermost active :func:`region` on the
calling thread. The build runs synchronously on the thread that first
needed the kernel, so thread-local attribution is exact.

The contract this enforces: once the kernels a path needs are built,
**steady state never compiles**. ``chip_smoke.py`` counts one build per
CUDA source in its build phase and asserts zero in each main-path run.

Usage::

    from repro_torch.obs import recompile
    recompile.enable()
    with recompile.region("search"):
        session.search_scored(q, k=k)
    recompile.counts()   # {"search": 1} when the search built a kernel

Counting is disabled by default and costs one flag read per build when
disabled, nothing on the launch path.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, Optional

from repro_torch.obs.metrics import REGISTRY

__all__ = ["enable", "disable", "is_enabled", "region", "counts", "total",
           "mark", "since", "reset", "report", "UNATTRIBUTED",
           "COMPILE_EVENT"]

#: the event ``kernels/build.py`` reports once per nvcc build of a CUDA
#: source (the counterpart of the reference's jax.monitoring compile key)
COMPILE_EVENT = "/repro_torch/kernels/build/nvcc"

#: key for compilations that happen outside any region()
UNATTRIBUTED = "unattributed"


class _State:
    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.enabled = False
        self.counts: Dict[str, int] = {}
        self.marked: Dict[str, int] = {}
        self.local = threading.local()


_STATE = _State()


def _region_key() -> str:
    stack = getattr(_STATE.local, "stack", None)
    return stack[-1] if stack else UNATTRIBUTED


def report(event: str = COMPILE_EVENT) -> None:
    """Count one compilation ``event`` against the calling thread's
    innermost region (a no-op while disabled or for another event)."""
    if not _STATE.enabled or not event.startswith(COMPILE_EVENT):
        return
    key = _region_key()
    with _STATE.lock:
        _STATE.counts[key] = _STATE.counts.get(key, 0) + 1
    REGISTRY.counter(f"recompile.{key}").inc()


def enable() -> None:
    """Start counting compilations."""
    _STATE.enabled = True


def disable() -> None:
    """Stop counting (counts are kept until reset())."""
    _STATE.enabled = False


def is_enabled() -> bool:
    return _STATE.enabled


@contextlib.contextmanager
def region(key: str) -> Iterator[None]:
    """Attribute compilations on this thread to ``key`` while active.
    Regions nest; the innermost wins."""
    stack = getattr(_STATE.local, "stack", None)
    if stack is None:
        stack = _STATE.local.stack = []
    stack.append(key)
    try:
        yield
    finally:
        stack.pop()


def counts() -> Dict[str, int]:
    """Compilations per region key since enable()/reset()."""
    with _STATE.lock:
        return dict(_STATE.counts)


def total(key: Optional[str] = None) -> int:
    """Total compilations (or for one key) since enable()/reset()."""
    with _STATE.lock:
        if key is not None:
            return _STATE.counts.get(key, 0)
        return sum(_STATE.counts.values())


def mark() -> None:
    """Snapshot the current counts — the end-of-warmup waterline."""
    with _STATE.lock:
        _STATE.marked = dict(_STATE.counts)


def since(key: Optional[str] = None) -> int:
    """Compilations since the last mark() (all keys, or one)."""
    with _STATE.lock:
        if key is not None:
            return _STATE.counts.get(key, 0) - _STATE.marked.get(key, 0)
        return (sum(_STATE.counts.values())
                - sum(_STATE.marked.values()))


def reset() -> None:
    """Zero all counts and the mark (tests)."""
    with _STATE.lock:
        _STATE.counts.clear()
        _STATE.marked.clear()
