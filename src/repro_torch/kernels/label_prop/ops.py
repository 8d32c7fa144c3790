"""Dispatch wrapper for the label-propagation round kernel (port of
``repro/kernels/label_prop/ops.py``).

``label_prop_round(labels, nbr, wgt)`` takes the ELL adjacency itself; the
``labels[nbr]`` gather the reference does in XLA before its Pallas kernel
happens inside the CUDA kernel (csrc/lp_round.cu). ``row0`` makes the
table a block of rows of a larger graph (the sharded pipeline's rounds,
core/sharded_pipeline.py): row n is node ``row0 + n``, its own label
``labels[row0 + n]``, and the output has the block's rows. On a CPU tensor
the wrapper runs the plain version, ``ref.py::ell_round``; on
a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import tuning
from repro_torch.kernels.build import Kernel
from repro_torch.kernels.label_prop.ref import ell_round

LP_ROUND = Kernel("lp_round", "lp_round.cu",
                  (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 3)


def _check(t: torch.Tensor, name: str, dtype, ndim: int, device) -> None:
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"lp_round: {name} must be {ndim}-d {dtype}, got "
                         f"{t.dim()}-d {t.dtype}")
    if t.device != device:
        raise ValueError(f"lp_round: {name} is on {t.device}, expected "
                         f"{device}")
    if not t.is_contiguous():
        raise ValueError(f"lp_round: {name} must be contiguous")


def lp_round_cuda(labels: torch.Tensor, nbr: torch.Tensor,
                  wgt: torch.Tensor, row0: int = 0) -> torch.Tensor:
    """Launch the CUDA kernel: labels i32[L], nbr i32[N, K] (-1 pad), wgt
    f32[N, K], rows row0 .. row0 + N of the graph -> new labels i32[N]."""
    dev = labels.device
    if dev.type != "cuda":
        raise ValueError(f"lp_round_cuda needs CUDA tensors, got {dev}")
    _check(labels, "labels", torch.int32, 1, dev)
    _check(nbr, "nbr", torch.int32, 2, dev)
    _check(wgt, "wgt", torch.float32, 2, dev)
    n, k = nbr.shape
    if row0 < 0 or labels.shape[0] < row0 + n or wgt.shape != nbr.shape:
        raise ValueError(f"lp_round: shapes labels {tuple(labels.shape)}, "
                         f"nbr {tuple(nbr.shape)}, wgt {tuple(wgt.shape)} "
                         f"at row0 {row0}")
    if labels.shape[0] >= 2 ** 31 or n * k >= 2 ** 62:
        raise ValueError(f"lp_round: {labels.shape[0]} labels, {n} x {k} "
                         f"exceed the kernel's indices")
    out = torch.empty(n, dtype=labels.dtype, device=dev)
    with torch.cuda.device(dev):
        LP_ROUND(labels.data_ptr(), nbr.data_ptr(), wgt.data_ptr(),
                 out.data_ptr(), n, k, row0)
    return out


def label_prop_round(labels: torch.Tensor, nbr: torch.Tensor,
                     wgt: torch.Tensor, row0: int = 0) -> torch.Tensor:
    """One LP round over ELL adjacency: labels (L,), nbr (N, K) node ids
    (-1 pad), wgt (N, K) of nodes row0 .. row0 + N -> their new labels
    (N,). The kernel on CUDA tensors, ``ell_round`` on CPU tensors. Its
    block shape resolves through the autotuner, which holds a tuned
    table's to the compiled one (csrc/lp_round.cu)."""
    tuning.resolve("label_prop_round", n=labels.shape[0], dtype="float32")
    if labels.device.type == "cpu":
        return ell_round(labels, nbr, wgt, row0)
    return lp_round_cuda(labels, nbr, wgt, row0)
