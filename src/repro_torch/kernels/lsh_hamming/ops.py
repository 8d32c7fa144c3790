"""Dispatch wrapper for the Hamming top-k kernel (port of
``repro/kernels/lsh_hamming/ops.py``).

Shape contract, as in the reference: any Q/N/k is accepted; k is clamped to
the corpus size and the result padded back with score -inf / id -1. Rows
past the corpus end are masked inside the kernel (the reference's
``n_valid``), so nothing is padded. The kernel takes any k: the lsh engine
asks for its rerank pool, 64 by default, where the reference's k <= 32 cap
sends it to its jnp path.

On CPU tensors the wrapper runs the plain version (ref.py); on CUDA tensors
it launches ``hamming_topk`` of csrc/hamming_topk.cu (a counting select:
per-split distance histograms, a threshold and the rows at or below it
written in (distance, id) order; where W <= 7 the distances are kept as
bytes between the two passes) or raises. It first resolves its launch
params through the autotuner (kernels/tuning.py), as the reference's
does; of these only the split target (``split_blocks``, HAMMING_BLOCKS by
default) varies a launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import tuning
from repro_torch.kernels.build import Kernel
from repro_torch.kernels.lsh_hamming import ref
from repro_torch.kernels.topk_scoring.ops import (_aligned, _check,
                                                  empty_topk, split_plan)
from repro_torch.kernels.topk_scoring.ref import pad_topk

HAMMING_TOPK = Kernel("hamming_topk", "hamming_topk.cu",
                      (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 7)
# the kernel's query and corpus tiles, kHQ and kHN in csrc/hamming_topk.cu:
# a block takes HAMMING_QUERIES queries and walks HAMMING_ROWS-row tiles of
# its split; the plan aims at four blocks for each of an H100's 132 SMs
HAMMING_QUERIES, HAMMING_ROWS = 32, 128
HAMMING_BLOCKS = 4 * 132
# up to this many words a distance fits a byte, and the kernel keeps each
# one (uint8 [Q, N] scratch) for its collect pass: kStoreWords there
STORE_WORDS = 7


def hamming_bins(w: int) -> int:
    """Distances to W packed words lie in [0, 32 W]: one bin each."""
    return 32 * w + 1


def hamming_topk_cuda(q_codes: torch.Tensor, c_codes: torch.Tensor, k: int,
                      blocks: int = HAMMING_BLOCKS):
    """Launch the Hamming kernels: codes i32[Q, W] x i32[N, W], 1 <= k <= N
    -> (-distance f32[Q, k], ids i32[Q, k]), ordered by (distance, id);
    ``blocks`` is the split plan's target block count."""
    dev = q_codes.device
    name = HAMMING_TOPK.name
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    _check(q_codes, "q_codes", torch.int32, dev, name)
    _check(c_codes, "c_codes", torch.int32, dev, name)
    nq, w = q_codes.shape
    n = c_codes.shape[0]
    if c_codes.shape[1] != w:
        raise ValueError(f"{name}: widths differ, {w} vs {c_codes.shape[1]}")
    if not 1 <= k <= n:
        raise ValueError(f"{name}: k={k} outside [1, N={n}]")
    per_split, n_splits = split_plan(nq, n, HAMMING_QUERIES, HAMMING_ROWS,
                                     blocks)
    bins = hamming_bins(w)
    if (max(nq * k, n * w, nq * n_splits * bins) >= 2 ** 31
            or nq * n >= 2 ** 62
            or -(-nq // HAMMING_QUERIES) >= 2 ** 16):
        raise ValueError(f"{name}: Q={nq} N={n} W={w} k={k} exceeds the "
                         f"kernel's indices")
    hist = torch.empty((nq, n_splits, bins), dtype=torch.int32, device=dev)
    thr = torch.empty(nq, dtype=torch.int32, device=dev)
    dist8 = torch.empty((nq, n) if w <= STORE_WORDS else (1,),
                        dtype=torch.uint8, device=dev)
    out_s = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    vec = int(w % 4 == 0 and _aligned(q_codes, c_codes))
    with torch.cuda.device(dev):
        HAMMING_TOPK(q_codes.data_ptr(), c_codes.data_ptr(), hist.data_ptr(),
                     thr.data_ptr(), dist8.data_ptr(), out_s.data_ptr(),
                     out_i.data_ptr(), nq, n, w, k, per_split, n_splits, vec)
    return out_s, out_i


def hamming_topk(q_codes: torch.Tensor, c_codes: torch.Tensor, *, k: int,
                 split_blocks: int = None):
    """Top-k of -Hamming distance: packed codes (Q, W) x (N, W) -> (Q, k)
    scores/ids, ties to the lowest id. The split target resolves through
    the autotuner (``kernels/tuning``): ``split_blocks`` > tuned table >
    HAMMING_BLOCKS."""
    blocks = tuning.resolve("hamming_topk", n=c_codes.shape[0],
                            dtype=c_codes.dtype, split_blocks=split_blocks)
    k_eff = min(k, c_codes.shape[0])
    if q_codes.device.type == "cpu":
        return pad_topk(*ref.hamming_topk_ref(q_codes, c_codes, k=k_eff), k)
    if k_eff == 0 or q_codes.shape[0] == 0:
        return empty_topk(q_codes.shape[0], k, q_codes.device)
    s, i = hamming_topk_cuda(q_codes.to(torch.int32).contiguous(),
                             c_codes.to(torch.int32).contiguous(), k_eff,
                             blocks["split_blocks"])
    return pad_topk(s, i, k)
