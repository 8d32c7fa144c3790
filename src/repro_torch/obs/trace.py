"""Zero-dependency structured span tracer (DESIGN.md §12); port of
``repro/obs/trace.py``.

One process-global tracer produces nested, attributed spans:

    from repro.obs import trace

    with trace.span("eval.sample", sampler="windtunnel") as sp:
        ...
        sp.set(n_entities=int(mask.sum()))

Spans record wall time (``perf_counter``), a span/parent id pair (so a
reader can reconstruct the nesting), and free-form JSON attributes, and are
appended to a JSONL sink — one JSON object per line, written as each span
closes.

The device-aware variant understands asynchronous CUDA execution: a plain
timer around a launch measures the enqueue, not the work. ``device_span``
lets the caller *declare* the outputs whose completion the span should
cover; on exit the tracer synchronizes the CUDA device of any declared
CUDA tensor and records the blocked tail separately (``block_s``), so the
span's duration is the true wall time of the computation:

    with trace.device_span("sampling.labels", engine="cuda") as sp:
        labels, changes = _labels_stage(...)
        sp.declare(labels, changes)

Each ``device_span`` record carries ``first`` — True the first time its key
(span name by default, ``compile_key=`` to override) is seen in the
process, which is where kernel builds and allocator warm-up land.

Disabled is the default and is a strict no-op fast path: ``span()`` /
``device_span()`` return one shared :data:`NOOP` singleton — no span object
is allocated, nothing is retained, nothing is written.  Enable with the
``REPRO_TRACE=<path>`` environment variable (honoured at import) or
programmatically / via the CLIs' ``--trace <path>`` flag through
:func:`enable`.
"""
from __future__ import annotations

import atexit
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, Optional

ENV_VAR = "REPRO_TRACE"

__all__ = ["ENV_VAR", "NOOP", "Span", "configure_from_env", "device_span",
           "disable", "enable", "enabled_path", "is_enabled", "span"]


class _NoopSpan:
    """Shared do-nothing span: the disabled tracer's entire surface."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NoopSpan":
        return self

    def declare(self, *outputs) -> "_NoopSpan":
        return self


NOOP = _NoopSpan()


class _State:
    """Process-global tracer state (one sink, one span-id sequence)."""

    def __init__(self) -> None:
        self.enabled = False
        self.path: Optional[str] = None
        self.sink = None                  # open file handle when enabled
        self.lock = threading.Lock()
        self.ids = itertools.count(1)
        self.local = threading.local()    # .stack: per-thread open span ids
        self.seen_first: set = set()      # compile keys already traced
        self.records_written = 0          # testability: sink write count


_STATE = _State()


def _stack() -> list:
    stack = getattr(_STATE.local, "stack", None)
    if stack is None:
        stack = _STATE.local.stack = []
    return stack


def enable(path: str) -> None:
    """Open ``path`` as the process-global JSONL sink and start tracing.
    Parent directories are created; re-enabling to the same path appends."""
    disable()
    dirname = os.path.dirname(path)
    if dirname:
        os.makedirs(dirname, exist_ok=True)
    _STATE.sink = open(path, "a", encoding="utf-8")
    _STATE.path = path
    _STATE.enabled = True


def disable() -> None:
    """Stop tracing and close the sink (idempotent)."""
    _STATE.enabled = False
    sink, _STATE.sink, _STATE.path = _STATE.sink, None, None
    if sink is not None:
        try:
            sink.close()
        except OSError:
            pass


def is_enabled() -> bool:
    return _STATE.enabled


def enabled_path() -> Optional[str]:
    return _STATE.path


def _write(record: Dict[str, Any]) -> None:
    with _STATE.lock:
        sink = _STATE.sink
        if sink is None:
            return
        sink.write(json.dumps(record, default=str) + "\n")
        sink.flush()
        _STATE.records_written += 1


def _cuda_devices(obj, found: set) -> set:
    """CUDA devices of the tensors nested in ``obj`` (tuples, lists,
    NamedTuples, dicts)."""
    if isinstance(obj, (tuple, list)):
        for x in obj:
            _cuda_devices(x, found)
    elif isinstance(obj, dict):
        for x in obj.values():
            _cuda_devices(x, found)
    elif getattr(obj, "is_cuda", False):
        found.add(obj.device)
    return found


def _synchronize(outputs) -> None:
    devices = _cuda_devices(outputs, set())
    if devices:
        import torch
        for dev in devices:
            torch.cuda.synchronize(dev)


class Span:
    """One live span; created only while tracing is enabled."""

    __slots__ = ("name", "attrs", "span_id", "parent_id", "_device",
                 "_compile_key", "_outputs", "_t0", "_wall0")

    def __init__(self, name: str, attrs: Dict[str, Any], *,
                 device_aware: bool = False,
                 compile_key: Optional[str] = None):
        self.name = name
        self.attrs = attrs
        self._device = device_aware
        self._compile_key = compile_key if compile_key is not None else name
        self._outputs: list = []
        self.span_id = 0
        self.parent_id: Optional[int] = None

    def __enter__(self) -> "Span":
        stack = _stack()
        self.parent_id = stack[-1] if stack else None
        self.span_id = next(_STATE.ids)
        stack.append(self.span_id)
        self._wall0 = time.time()
        self._t0 = time.perf_counter()
        return self

    def set(self, **attrs) -> "Span":
        """Attach/overwrite attributes on the open span."""
        self.attrs.update(attrs)
        return self

    def declare(self, *outputs) -> "Span":
        """Declare outputs the span must wait for on exit
        (``device_span`` only; a plain span ignores the block step)."""
        self._outputs.extend(outputs)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        block_s = None
        if self._device and self._outputs and exc_type is None:
            t_block = time.perf_counter()
            _synchronize(self._outputs)
            block_s = time.perf_counter() - t_block
        dur_s = time.perf_counter() - self._t0
        stack = _stack()
        if stack and stack[-1] == self.span_id:
            stack.pop()
        record: Dict[str, Any] = {
            "name": self.name, "id": self.span_id,
            "parent": self.parent_id, "t0": self._wall0,
            "dur_s": dur_s,
        }
        if self._device:
            first = self._compile_key not in _STATE.seen_first
            _STATE.seen_first.add(self._compile_key)
            record["first"] = first
            if block_s is not None:
                record["block_s"] = block_s
        if exc_type is not None:
            record["error"] = f"{exc_type.__name__}: {exc}"
        if self.attrs:
            record["attrs"] = self.attrs
        _write(record)
        return False


def span(name: str, **attrs):
    """Start a structured span; a shared no-op when tracing is disabled."""
    if not _STATE.enabled:
        return NOOP
    return Span(name, attrs)


def device_span(name: str, *, compile_key: Optional[str] = None, **attrs):
    """Device-aware span: ``declare(*outputs)`` inside the block and the
    span waits for them at exit (``block_s``), tagging the record with
    ``first`` vs steady-state per ``compile_key`` (default: the name)."""
    if not _STATE.enabled:
        return NOOP
    return Span(name, attrs, device_aware=True, compile_key=compile_key)


def configure_from_env() -> None:
    """Enable tracing when ``REPRO_TRACE`` names a sink path (import-time
    hook; a blank / ``off`` / ``0`` value keeps the tracer disabled)."""
    path = os.environ.get(ENV_VAR, "").strip()
    if path and path.lower() not in ("0", "off", "none"):
        enable(path)


configure_from_env()
atexit.register(disable)
