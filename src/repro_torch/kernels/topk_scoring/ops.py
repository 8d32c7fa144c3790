"""Dispatch wrappers for the top-k scoring kernels (port of
``repro/kernels/topk_scoring/ops.py``).

Shape contract, as in the reference: any Q/N/C/k is accepted; k is clamped
to the corpus (candidate) count; misses come back as score -inf / id -1.
The kernels take any k (csrc/topk_scores.cu keeps lists longer than 32 in
memory), so there is no cap and no plain fallback on the card. Rows past
the corpus end are masked inside the kernel, so nothing is padded or
copied.

On CPU tensors each wrapper runs its plain version (ref.py); on CUDA tensors
it launches its partial kernel and the merge kernel of csrc/topk_scores.cu
or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import Kernel
from repro_torch.kernels.topk_scoring import ref
from repro_torch.kernels.topk_scoring.ref import pad_topk

_BQ, _BN = 32, 128           # tile geometry of csrc/topk_scores.cu
_TARGET_BLOCKS = 4 * 132     # a few blocks per H100 SM

_PARTIAL_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 7
TOPK_PARTIAL = Kernel("topk_partial", "topk_scores.cu", _PARTIAL_ARGS)
TOPK_INT8_PARTIAL = Kernel("topk_int8_partial", "topk_scores.cu",
                           _PARTIAL_ARGS)
TOPK_MERGE = Kernel("topk_merge", "topk_scores.cu",
                    (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 3)
GATHERED_PARTIAL = Kernel("gathered_partial", "topk_scores.cu",
                          (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 7)
_SPLIT_WARPS = 8 * _TARGET_BLOCKS    # gathered: warps (query, split) to aim at
_MIN_SPLIT = 256                     # gathered: fewest positions a split takes


def _check(t: torch.Tensor, name: str, dtype, device, kernel: str) -> None:
    """Raise unless ``t`` is a contiguous 2-d ``dtype`` tensor on
    ``device``."""
    if t.dtype != dtype or t.dim() != 2:
        raise ValueError(f"{kernel}: {name} must be 2-d {dtype}, got "
                         f"{t.dim()}-d {t.dtype}")
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, expected "
                         f"{device}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def launch_topk(partial: Kernel, queries: torch.Tensor, corpus: torch.Tensor,
                k: int, dtype, vec_width: int):
    """Check the inputs, then launch ``partial`` (a dense scan over the
    corpus rows: ``topk_partial``, ``topk_int8_partial`` or
    ``hamming_partial``) and the merge kernel: queries [Q, D], corpus [N, D]
    of ``dtype``, 1 <= k <= N -> (scores f32[Q, k], ids i32[Q, k])."""
    dev = queries.device
    name = partial.name
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    _check(queries, "queries", dtype, dev, name)
    _check(corpus, "corpus", dtype, dev, name)
    nq, d = queries.shape
    n = corpus.shape[0]
    if corpus.shape[1] != d:
        raise ValueError(f"{name}: widths differ, {d} vs {corpus.shape[1]}")
    if not 1 <= k <= n:
        raise ValueError(f"{name}: k={k} outside [1, N={n}]")
    n_tiles = -(-n // _BN)
    q_tiles = -(-nq // _BQ)
    n_splits = max(1, min(n_tiles, -(-_TARGET_BLOCKS // max(q_tiles, 1))))
    per_split = -(-n_tiles // n_splits)
    n_splits = -(-n_tiles // per_split)
    width = n_splits * k
    if max(nq, n, d, width) >= 2 ** 31:
        raise ValueError(f"{name}: a dimension exceeds int32")
    if dtype == torch.int8 and d * 127 * 127 >= 2 ** 31:
        raise ValueError(f"{name}: D={d} overflows the int32 int8 dot")
    part_s = torch.empty((nq, width), dtype=torch.float32, device=dev)
    part_i = torch.empty((nq, width), dtype=torch.int32, device=dev)
    out_s = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    vec = int(d % vec_width == 0 and _aligned(queries, corpus))
    with torch.cuda.device(dev):
        partial(queries.data_ptr(), corpus.data_ptr(), part_s.data_ptr(),
                part_i.data_ptr(), nq, n, d, k, per_split, n_splits, vec)
        TOPK_MERGE(part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(),
                   out_i.data_ptr(), nq, width, k)
    return out_s, out_i


def topk_scores_cuda(queries: torch.Tensor, corpus: torch.Tensor, k: int):
    """Launch the f32 kernel pair: queries f32[Q, D], corpus f32[N, D],
    1 <= k <= N -> (scores f32[Q, k], ids i32[Q, k])."""
    return launch_topk(TOPK_PARTIAL, queries, corpus, k, torch.float32, 4)


def topk_scores_int8_cuda(q_codes: torch.Tensor, c_codes: torch.Tensor,
                          k: int):
    """Launch the int8 kernel pair: codes int8[Q, D] x int8[N, D], 1 <= k
    <= N -> (int dot as f32 [Q, k], ids i32[Q, k])."""
    return launch_topk(TOPK_INT8_PARTIAL, q_codes, c_codes, k, torch.int8,
                       16)


def gathered_topk_cuda(queries: torch.Tensor, table: torch.Tensor,
                       cand_rows: torch.Tensor, cand_ids: torch.Tensor,
                       k: int):
    """Launch the gathered kernel and the merge kernel: queries f32[Q, D],
    table f32[R, D], cand_rows/cand_ids i32[Q, C], 1 <= k <= C ->
    (scores f32[Q, k], ids i32[Q, k]). The kernels rank (score, position);
    one gather maps the winning positions to ids, -1 where the score is
    -inf."""
    dev = queries.device
    name = GATHERED_PARTIAL.name
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    _check(queries, "queries", torch.float32, dev, name)
    _check(table, "table", torch.float32, dev, name)
    _check(cand_rows, "cand_rows", torch.int32, dev, name)
    _check(cand_ids, "cand_ids", torch.int32, dev, name)
    nq, d = queries.shape
    c = cand_ids.shape[1]
    if table.shape[1] != d:
        raise ValueError(f"{name}: widths differ, {d} vs {table.shape[1]}")
    if cand_rows.shape != (nq, c) or cand_ids.shape[0] != nq:
        raise ValueError(f"{name}: cand_rows {tuple(cand_rows.shape)} and "
                         f"cand_ids {tuple(cand_ids.shape)} must both be "
                         f"(Q={nq}, C)")
    if not 1 <= k <= c:
        raise ValueError(f"{name}: k={k} outside [1, C={c}]")
    r = table.shape[0]
    stray = (cand_ids >= 0) & ((cand_rows < 0) | (cand_rows >= r))
    if bool(stray.any()):
        raise ValueError(f"{name}: a valid candidate's row lies outside the "
                         f"table's {r} rows")
    n_splits = max(1, min(-(-c // _MIN_SPLIT), -(-_SPLIT_WARPS // nq)))
    per_split = -(-c // n_splits)
    n_splits = -(-c // per_split)
    width = n_splits * k
    if max(nq, c, d, width) >= 2 ** 31:
        raise ValueError(f"{name}: a dimension exceeds int32")
    part_s = torch.empty((nq, width), dtype=torch.float32, device=dev)
    part_p = torch.empty((nq, width), dtype=torch.int32, device=dev)
    out_s = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_p = torch.empty((nq, k), dtype=torch.int32, device=dev)
    vec = int(d % 4 == 0 and _aligned(queries, table))
    with torch.cuda.device(dev):
        GATHERED_PARTIAL(queries.data_ptr(), table.data_ptr(),
                         cand_rows.data_ptr(), cand_ids.data_ptr(),
                         part_s.data_ptr(), part_p.data_ptr(), nq, c, d, k,
                         per_split, n_splits, vec)
        TOPK_MERGE(part_s.data_ptr(), part_p.data_ptr(), out_s.data_ptr(),
                   out_p.data_ptr(), nq, width, k)
    ids = torch.gather(cand_ids, 1, out_p.clamp(min=0).long())
    return out_s, torch.where(torch.isfinite(out_s), ids, -1)


def empty_topk(nq: int, k: int, device):
    """All misses: the result of a search with no query or no candidate."""
    return pad_topk(torch.empty((nq, 0), dtype=torch.float32, device=device),
                    torch.empty((nq, 0), dtype=torch.int32, device=device), k)


def topk_scores(queries: torch.Tensor, corpus: torch.Tensor, *, k: int):
    """Top-k inner-product search: (Q, D) x (N, D) -> (Q, k) scores/ids."""
    k_eff = min(k, corpus.shape[0])
    if queries.device.type == "cpu":
        return pad_topk(*ref.topk_scores_ref(queries, corpus, k=k_eff), k)
    if k_eff == 0 or queries.shape[0] == 0:
        return empty_topk(queries.shape[0], k, queries.device)
    s, i = topk_scores_cuda(queries.to(torch.float32).contiguous(),
                            corpus.to(torch.float32).contiguous(), k_eff)
    return pad_topk(s, i, k)


def topk_scores_int8(q_codes: torch.Tensor, c_codes: torch.Tensor, *,
                     k: int):
    """Quantized top-k scan: int8 codes (Q, D) x (N, D) -> (Q, k) int-dot
    scores (as f32) and ids. Ranking is scale-invariant, so callers rank on
    the raw dot and rerank the winners in float
    (retrieval/backends.py ``Int8Backend``)."""
    k_eff = min(k, c_codes.shape[0])
    if q_codes.device.type == "cpu":
        return pad_topk(*ref.topk_scores_int8_ref(q_codes, c_codes, k=k_eff),
                        k)
    if k_eff == 0 or q_codes.shape[0] == 0:
        return empty_topk(q_codes.shape[0], k, q_codes.device)
    s, i = topk_scores_int8_cuda(q_codes.contiguous(), c_codes.contiguous(),
                                 k_eff)
    return pad_topk(s, i, k)


def gathered_topk(queries: torch.Tensor, table: torch.Tensor,
                  cand_rows: torch.Tensor, cand_ids: torch.Tensor, *,
                  k: int):
    """Per-query candidate top-k: candidate c of query q is
    ``table[cand_rows[q, c]]``, id ``cand_ids[q, c]`` (-1 = invalid slot,
    scored -inf) -> (Q, k) scores/ids, ties to the earlier position. The
    ivfflat probe passes its index's list table and the probed list rows,
    so no (Q, C, D) tensor is ever built."""
    k_eff = min(k, cand_ids.shape[1])
    if queries.device.type == "cpu":
        return pad_topk(*ref.gathered_topk_ref(queries, table, cand_rows,
                                               cand_ids, k=k_eff), k)
    if k_eff == 0 or queries.shape[0] == 0:
        return empty_topk(queries.shape[0], k, queries.device)
    s, i = gathered_topk_cuda(queries.to(torch.float32).contiguous(),
                              table.to(torch.float32).contiguous(),
                              cand_rows.to(torch.int32).contiguous(),
                              cand_ids.to(torch.int32).contiguous(), k_eff)
    return pad_topk(s, i, k)
