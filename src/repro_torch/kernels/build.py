"""Build and bind the port's hand-written CUDA kernels.

Each source under ``src/repro_torch/csrc/`` has a plain C interface and is
compiled at first use by ``nvcc`` into a shared library under
``build/kernels/`` at the repository root (git-ignored), then loaded with
``ctypes``. Libraries are named by a hash of their source, so an edited
source is rebuilt and a stale library is never loaded. Each source has its
own lock, so callers on several threads build several sources at once
(``chip_smoke.py`` does, to stay inside its time limit).

Nothing here runs at import: the CPU tests import every module, and this
machine may have no ``nvcc`` at all.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCKS: Dict[str, threading.Lock] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       "/usr/local/cuda/bin); the CUDA kernels are built "
                       "from src/repro_torch/csrc at first use")


def _paths(source: str):
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    stem = src.stem
    lib = BUILD_DIR / f"lib{stem}-{digest}.so"
    return src, lib, lib.with_suffix(".log")


def _build(source: str) -> None:
    """Compile ``source`` into its library unless it is already built."""
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
    show that its main path went through the kernel."""

    name: str
    source: str
    argtypes: tuple
    launches: int = 0
    _fn: object = dataclasses.field(default=None, repr=False)

    def __call__(self, *args) -> None:
        """Launch on the current CUDA stream; raise on a launch error."""
        import torch
        if self._fn is None:
            fn = getattr(load(self.source), self.name)
            fn.argtypes = list(self.argtypes) + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        stream = torch.cuda.current_stream().cuda_stream
        rc = self._fn(*args, stream)
        if rc != 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: "
                               f"cudaError {rc}")
        self.launches += 1
