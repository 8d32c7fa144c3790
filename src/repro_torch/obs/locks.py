"""Instrumented debug locks (a copy of ``repro/obs/locks.py``; DESIGN.md
§15): runtime complement to the ``conc-lock-order`` static rule.

:func:`make_lock` / :func:`make_rlock` are what the serving tier uses to
create its locks (``repro_torch/serve/``: the scheduler's queue, the
tenant cache, the live index).  In production they return plain
``threading`` primitives — zero overhead.  With ``REPRO_DEBUG_LOCKS=1``
(or after :func:`enable`) they return :class:`DebugLock` wrappers that
record, per acquisition:

  * the **acquisition-order edge** held-lock -> new-lock, into a global
    edge set; :func:`inversions` reports every pair of locks observed in
    both orders — the dynamic witness of a potential deadlock the static
    lock-order graph can only approximate;
  * a per-lock **acquire count** (:func:`acquire_counts`), which is what
    the regression tests assert — e.g. "reading ``LiveIndex.pending_rows``
    acquires the index lock" becomes a counted fact instead of a comment.

State is process-global and lock-protected; :func:`reset` clears it
between tests.  The wrapper is context-manager compatible with the plain
primitives (``with lock:``, ``acquire(timeout=...)``, ``release``), so
enabling debug mode changes observability, never semantics.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, List, Set, Tuple

__all__ = ["DebugLock", "make_lock", "make_rlock", "enable", "disable",
           "is_enabled", "edges", "inversions", "acquire_counts", "reset"]


class _Tracker:
    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.enabled = os.environ.get("REPRO_DEBUG_LOCKS", "") not in (
            "", "0", "false")
        self.edges: Set[Tuple[str, str]] = set()
        self.acquires: Dict[str, int] = {}
        self.local = threading.local()


_TRACKER = _Tracker()


def enable() -> None:
    """Hand out DebugLock wrappers from make_lock()/make_rlock()."""
    _TRACKER.enabled = True


def disable() -> None:
    _TRACKER.enabled = False


def is_enabled() -> bool:
    return _TRACKER.enabled


def _held_stack() -> List[str]:
    stack = getattr(_TRACKER.local, "held", None)
    if stack is None:
        stack = _TRACKER.local.held = []
    return stack


class DebugLock:
    """A named lock recording acquisition order and counts.

    Wraps ``threading.Lock`` or ``threading.RLock``; re-entrant acquires
    of an RLock are counted but add no self-edges.
    """

    def __init__(self, name: str, reentrant: bool = False):
        self.name = name
        self._inner = threading.RLock() if reentrant else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            held = _held_stack()
            with _TRACKER.lock:
                _TRACKER.acquires[self.name] = \
                    _TRACKER.acquires.get(self.name, 0) + 1
                for h in held:
                    if h != self.name:
                        _TRACKER.edges.add((h, self.name))
            held.append(self.name)
        return ok

    def release(self) -> None:
        held = _held_stack()
        # remove the innermost occurrence (RLocks release in any depth)
        for i in range(len(held) - 1, -1, -1):
            if held[i] == self.name:
                del held[i]
                break
        self._inner.release()

    def __enter__(self) -> "DebugLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


def make_lock(name: str):
    """A mutex for ``serve``-tier state: plain ``threading.Lock`` in
    production, :class:`DebugLock` under REPRO_DEBUG_LOCKS."""
    return DebugLock(name) if _TRACKER.enabled else threading.Lock()


def make_rlock(name: str):
    """Re-entrant variant of :func:`make_lock`."""
    return DebugLock(name, reentrant=True) if _TRACKER.enabled \
        else threading.RLock()


def edges() -> Set[Tuple[str, str]]:
    """Observed acquisition-order edges (held -> acquired)."""
    with _TRACKER.lock:
        return set(_TRACKER.edges)


def inversions() -> List[Tuple[str, str]]:
    """Lock pairs observed in both orders — each is a latent deadlock."""
    with _TRACKER.lock:
        return sorted({(a, b) for (a, b) in _TRACKER.edges
                       if a < b and (b, a) in _TRACKER.edges})


def acquire_counts() -> Dict[str, int]:
    """Acquisitions per lock name since reset()."""
    with _TRACKER.lock:
        return dict(_TRACKER.acquires)


def reset() -> None:
    """Clear edges and counts (tests); leaves enablement untouched."""
    with _TRACKER.lock:
        _TRACKER.edges.clear()
        _TRACKER.acquires.clear()
