"""Build and bind the port's hand-written CUDA kernels.

Each source under ``src/repro_torch/csrc/`` has a plain C interface and is
compiled at first use by ``nvcc`` into a shared library under
``build/kernels/`` at the repository root (git-ignored), then loaded with
``ctypes``. Libraries are named by a hash of their source and the csrc/
headers it includes, so an edited source or header is rebuilt and a stale
library is never loaded. Each source has its own lock, so callers on
several threads build several sources at once
(``chip_smoke.py`` does, to stay inside its time limit). Each nvcc run is
counted by the recompile sentinel against the calling thread's region.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no ``nvcc`` at all.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import ClassVar, Dict, Optional

from repro_torch.obs import recompile

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCKS: Dict[str, threading.Lock] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
_KERNELS: list = []     # every Kernel made, in the order the ops modules
                        # made them at import


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       "/usr/local/cuda/bin); the CUDA kernels are built "
                       "from src/repro_torch/csrc at first use")


def _source_bytes(src: Path) -> bytes:
    """A source's text and that of the headers of csrc/ it includes
    (``#include "name"``), so that an edited header rebuilds it too."""
    text = src.read_bytes()
    for name in re.findall(rb'^#include "([^"]+)"', text, re.M):
        text += _source_bytes(CSRC / name.decode())
    return text


def _paths(source: str):
    src = CSRC / source
    digest = hashlib.sha256(_source_bytes(src)).hexdigest()[:12]
    stem = src.stem
    lib = BUILD_DIR / f"lib{stem}-{digest}.so"
    return src, lib, lib.with_suffix(".log")


def _build(source: str) -> None:
    """Compile ``source`` into its library unless it is already built; a
    build is reported to the recompile sentinel (``obs/recompile``)."""
    src, lib, log = _paths(source)
    if lib.exists():
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    with open(log, "w") as f:
        rc = subprocess.run(cmd, stdout=f, stderr=subprocess.STDOUT).returncode
    if rc != 0:
        raise RuntimeError(f"nvcc failed ({rc}) building {lib.name}:\n"
                           f"{log.read_text()}")
    os.replace(tmp, lib)
    recompile.report(recompile.COMPILE_EVENT)


def load(source: str) -> ctypes.CDLL:
    """The loaded library for ``source`` (built first if missing)."""
    with _LOCKS.setdefault(source, threading.Lock()):
        lib = _LIBS.get(source)
        if lib is None:
            _build(source)
            lib = _LIBS[source] = ctypes.CDLL(str(_paths(source)[1]))
        return lib


def ptxas_report(source: str) -> str:
    """The ``-Xptxas -v`` output of the last build of ``source``."""
    log = _paths(source)[2]
    return log.read_text() if log.exists() else ""


@dataclasses.dataclass
class Kernel:
    """One C entry point of a CUDA source, with its launch count.

    ``launches`` is a plain integer bumped once per launch, so a run can
    show that its main path went through the kernel; ``shapes`` counts the
    launches by their integer arguments (the shape the entry point was
    given). While ``Kernel.timed`` is a list, each launch also appends
    (name, start, end) CUDA events recorded around it on its stream, whose
    elapsed times, read after a synchronize, are its device time."""

    name: str
    source: str
    argtypes: tuple
    launches: int = 0
    shapes: collections.Counter = dataclasses.field(
        default_factory=collections.Counter, repr=False)
    _fn: object = dataclasses.field(default=None, repr=False)
    timed: ClassVar[Optional[list]] = None

    def __post_init__(self) -> None:
        _KERNELS.append(self)
        # the integer arguments, which name a launch's shape
        self._ints = tuple(i for i, t in enumerate(self.argtypes)
                           if t is ctypes.c_int)

    def __call__(self, *args) -> None:
        """Launch on the current CUDA stream; raise on a launch error."""
        import torch
        if self._fn is None:
            fn = getattr(load(self.source), self.name)
            fn.argtypes = list(self.argtypes) + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        # the current stream's raw handle, as torch's own launchers read
        # it: torch.cuda.current_stream() builds a Stream object on every
        # launch
        stream = torch._C._cuda_getCurrentRawStream(
            torch.cuda.current_device())
        events = None
        if Kernel.timed is not None:
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        rc = self._fn(*args, stream)
        if rc != 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: "
                               f"cudaError {rc}")
        if events is not None:
            events[1].record()
            Kernel.timed.append((self.name, *events))
        self.launches += 1
        self.shapes[tuple(args[i] for i in self._ints)] += 1


def kernels() -> tuple:
    """Every :class:`Kernel` made so far: those of each ops module that
    has been imported (``launch/serve.py`` reads their launch shapes)."""
    return tuple(_KERNELS)
