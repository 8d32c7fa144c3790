"""Shared CLI plumbing for the ``repro_torch.launch`` entry points (a copy
of ``repro/launch/logs.py``): stdlib logging under the ``repro_torch.*``
logger hierarchy, plus the observability flags every CLI carries
(DESIGN.md §12).

Logging: progress / diagnostic output goes through ``logging.getLogger
("repro_torch.<module>")`` instead of ad-hoc ``print`` — ``setup_logging``
installs one message-only stdout handler on the ``repro_torch`` root
logger
(so default CLI output looks exactly as before), ``--verbose`` drops the
level to DEBUG (and adds the logger name to the format), ``--quiet``
raises it to WARNING.  Library code just logs; only CLIs install
handlers.

Observability: ``--trace <path>`` enables the span tracer's JSONL sink
(equivalent to ``REPRO_TRACE=<path>``) and ``--metrics-json <path>``
writes the process-global metrics registry snapshot on exit via
:func:`write_metrics`.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import Optional

from repro_torch.obs import REGISTRY, trace

__all__ = ["add_logging_args", "add_obs_args", "init_obs", "setup_logging",
           "write_metrics"]


def add_logging_args(p: argparse.ArgumentParser) -> None:
    """Install the shared ``--verbose`` / ``--quiet`` flags."""
    g = p.add_mutually_exclusive_group()
    g.add_argument("--verbose", action="store_true",
                   help="debug-level progress output (repro_torch.* "
                        "loggers)")
    g.add_argument("--quiet", action="store_true",
                   help="warnings and errors only")


def add_obs_args(p: argparse.ArgumentParser) -> None:
    """Install the shared ``--trace`` / ``--metrics-json`` flags."""
    p.add_argument("--trace", default=None, metavar="PATH",
                   help="append structured spans to PATH as JSONL "
                        "(repro_torch.obs.trace; env: REPRO_TRACE)")
    p.add_argument("--metrics-json", default=None, metavar="PATH",
                   help="write the metrics-registry snapshot (counters/"
                        "gauges/histograms) to PATH on exit")


class _StdoutHandler(logging.StreamHandler):
    """StreamHandler that resolves ``sys.stdout`` at emit time, so stream
    replacement after setup (pytest capsys, redirection) is honoured."""

    def __init__(self):
        super().__init__(sys.stdout)

    @property
    def stream(self):
        return sys.stdout

    @stream.setter
    def stream(self, value):   # StreamHandler.__init__ assigns; ignore
        pass


def setup_logging(args: Optional[argparse.Namespace] = None, *,
                  verbose: bool = False, quiet: bool = False
                  ) -> logging.Logger:
    """Configure the ``repro_torch`` root logger for CLI use (idempotent)."""
    verbose = bool(getattr(args, "verbose", verbose))
    quiet = bool(getattr(args, "quiet", quiet))
    logger = logging.getLogger("repro_torch")
    logger.setLevel(logging.DEBUG if verbose
                    else logging.WARNING if quiet else logging.INFO)
    if not logger.handlers:
        logger.addHandler(_StdoutHandler())
        logger.propagate = False
    fmt = ("%(name)s: %(message)s" if verbose else "%(message)s")
    for handler in logger.handlers:
        handler.setFormatter(logging.Formatter(fmt))
    return logger


def init_obs(args: argparse.Namespace) -> None:
    """Apply the parsed ``--trace`` flag (before any instrumented work)."""
    if getattr(args, "trace", None):
        trace.enable(args.trace)


def write_metrics(args: argparse.Namespace, extra: Optional[dict] = None
                  ) -> Optional[str]:
    """Write the global registry snapshot (plus optional component
    sections, e.g. a grid's plan-trie registry) to ``--metrics-json``."""
    path = getattr(args, "metrics_json", None)
    if not path:
        return None
    out = {"global": REGISTRY.snapshot()}
    if extra:
        out.update(extra)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    return path
