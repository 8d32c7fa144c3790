"""Device resolution and the per-device defaults of the two registries.

On a CUDA device the label-propagation engine and the scoring backend
default to the hand-written kernels (both registered as ``cuda``); on the
CPU they default to the plain PyTorch versions (``sort`` and ``torch``).
Naming a kernel engine or backend on the CPU is an error, never a silent
swap.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if CUDA is asked for and no
    card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' for the plain PyTorch path")
    return dev


def default_engine(device: torch.device) -> str:
    return "cuda" if device.type == "cuda" else "sort"


def default_backend(device: torch.device) -> str:
    return "cuda" if device.type == "cuda" else "torch"


def check_runs_on(kind: str, name: str, needs_cuda: bool,
                  device: torch.device) -> None:
    """Reject a kernel-only engine/backend on a device without the kernel."""
    if needs_cuda and device.type != "cuda":
        raise ValueError(
            f"{kind} {name!r} runs a CUDA kernel and needs device='cuda'; "
            f"got device={str(device)!r} (use the plain "
            f"{'sort/ell engines' if kind == 'engine' else 'torch backend'})")
