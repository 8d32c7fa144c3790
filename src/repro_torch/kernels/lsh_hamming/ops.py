"""Dispatch wrapper for the Hamming top-k kernel (port of
``repro/kernels/lsh_hamming/ops.py``).

Shape contract, as in the reference: any Q/N/k is accepted; k is clamped to
the corpus size and the result padded back with score -inf / id -1. Rows
past the corpus end are masked inside the kernel (the reference's
``n_valid``), so nothing is padded. The kernel takes any k: the lsh engine
asks for its rerank pool, 64 by default, where the reference's k <= 32 cap
sends it to its jnp path.

On CPU tensors the wrapper runs the plain version (ref.py); on CUDA tensors
it launches ``hamming_partial`` and ``topk_merge`` of csrc/topk_scores.cu
or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import Kernel
from repro_torch.kernels.lsh_hamming import ref
from repro_torch.kernels.topk_scoring.ops import (HAMMING_BLOCKS,
                                                  HAMMING_QUERIES,
                                                  HAMMING_ROWS, empty_topk,
                                                  launch_topk)
from repro_torch.kernels.topk_scoring.ref import pad_topk

HAMMING_PARTIAL = Kernel("hamming_partial", "topk_scores.cu",
                         (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 7)


def hamming_topk_cuda(q_codes: torch.Tensor, c_codes: torch.Tensor, k: int):
    """Launch the Hamming kernel pair: codes i32[Q, W] x i32[N, W], 1 <= k
    <= N -> (-distance f32[Q, k], ids i32[Q, k])."""
    return launch_topk(HAMMING_PARTIAL, q_codes, c_codes, k, torch.int32, 4,
                       q_tile=HAMMING_QUERIES, rows=HAMMING_ROWS,
                       blocks=HAMMING_BLOCKS)


def hamming_topk(q_codes: torch.Tensor, c_codes: torch.Tensor, *, k: int):
    """Top-k of -Hamming distance: packed codes (Q, W) x (N, W) -> (Q, k)
    scores/ids, ties to the lowest id."""
    k_eff = min(k, c_codes.shape[0])
    if q_codes.device.type == "cpu":
        return pad_topk(*ref.hamming_topk_ref(q_codes, c_codes, k=k_eff), k)
    if k_eff == 0 or q_codes.shape[0] == 0:
        return empty_topk(q_codes.shape[0], k, q_codes.device)
    s, i = hamming_topk_cuda(q_codes.to(torch.int32).contiguous(),
                             c_codes.to(torch.int32).contiguous(), k_eff)
    return pad_topk(s, i, k)
