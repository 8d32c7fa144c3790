"""Dispatch wrappers for the top-k scoring kernels (port of
``repro/kernels/topk_scoring/ops.py``).

Shape contract, as in the reference: any Q/N/C/k is accepted; k is clamped
to the corpus (candidate) count; misses come back as score -inf / id -1.
The kernels take any k (csrc/topk_scores.cu keeps lists longer than 32 in
memory), so there is no cap and no plain fallback on the card. Rows past
the corpus end are masked inside the kernel, so nothing is padded or
copied. The dense kernels run their products on the tensor cores: f32 as
three TF32 products of split operands ("3xTF32"), int8 as exact int32 MMA.

On CPU tensors each wrapper runs its plain version (ref.py); on CUDA tensors
it launches its kernels of csrc/topk_scores.cu or raises. ``topk_scores``
takes one of two paths by the query count. Above ``NARROW_QUERIES``: a
partial kernel whose blocks take 128 queries each (``DENSE_QUERIES``) and
keep per-split top-k lists, then the merge kernel. At or below it (a
serving tick, a retrieval step): ``topk_narrow_scores`` puts corpus rows
on the MMA's M side and only the real queries, rounded up to 8, on its N
side, and writes every score's order key ((Q, N) int32, 4 bytes a score
against the corpus's 4 D) and each tile's largest; ``topk_narrow_select``
then finds each query's k best by an exact radix select over those keys,
spread over the whole card (a floor from the tile maxima, a count pass
that gathers the keys above it, and only where those are many two more
digit passes, a count of the ties at the k-th key and a collect; then a
sort of the survivors), so no warp walks a long list at large k.
``topk_scores_int8`` takes the same two paths by ``INT8_NARROW_QUERIES``:
at or below it the scorer's s8 form (exact int32 dots on the tensor cores,
each keyed as the f32 it rounds to, as the reference ranks them) feeds the
same select through the same buffer (one code path for both types), above
it the 128-query int8 kernel and the merge. The narrow pair's plan is
computed once a (Q, N, k) (``_narrow_layout``).

``gathered_topk`` takes one of two paths by the query count. At or
below ``GATHERED_NARROW_QUERIES`` (a serving tick's small buckets, a RAG
call): ``gathered_runs`` scores each query's runs of ``RUN_SLOTS``
consecutive slots, a block each, with f32 FMAs over its valid rows
streamed through shared memory, and the merge maps the winning positions
to ids; the grid and buffers follow from (Q, C), and the one host read,
a stray-row flag, comes after the last launch. Above it, the wrapper
cuts each query's valid candidate slots into pieces (runs of rows inside
one 128-row table tile) with two small kernels and one host read
(``gathered_pieces``; its plain version runs on the CPU), sorts them by
tile, scores each tile once a block of up to 32 pieces on the tensor
cores (the narrow scorer's 3xTF32 products, f64 where D <= 8) and merges
each query's piece lists, reading only the entries its pieces wrote.
``topk_merge`` cuts each row into segments over the card where rows are
few (``merge_plan``).

Each wrapper first resolves its launch params through the autotuner
(kernels/tuning.py: explicit kwarg > tuned table > default), as the
reference's do; of these only the 128-query kernels' split target
(``split_blocks``, DENSE_BLOCKS by default) varies a launch.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import tuning
from repro_torch.kernels.build import Kernel
from repro_torch.kernels.topk_scoring import ref
from repro_torch.kernels.topk_scoring.ref import pad_topk

# the dense kernels' query and corpus tiles, kDQ and kDN in
# csrc/dense_topk.cu: a block takes DENSE_QUERIES queries and walks
# DENSE_ROWS-row tiles of its split; one block fills an H100 SM, so the
# plan aims at one block for each of its 132 SMs. DENSE_CLUSTER
# (kDCluster) blocks of one query tile and neighbouring splits form a
# cluster that loads each query chunk once for all of them (TMA
# multicast), so the splits come in multiples of it
DENSE_QUERIES, DENSE_ROWS = 128, 128
DENSE_BLOCKS = 132
DENSE_CLUSTER = 2

# the narrow path, Q <= NARROW_QUERIES (kNQMax in csrc/topk_scores.cu):
# the scorer's blocks (NARROW_BLOCKS, one an SM) walk NARROW_ROWS-row
# corpus tiles (kNRows) against all the queries; its key rows are n
# rounded up to KEY_ALIGN (kKeyAlign) apart. The select kernel cuts each
# query's keys into items of at least SELECT_MIN_ITEM keys, about
# SELECT_ITEMS items in all; its scratch holds HEAD_INTS ints (kHeadInts),
# then per query STATE_INTS (kStateInts), four histograms of RADIX_BINS
# bins (kRadixBins) and a tie count an item; it sorts up to SORT_K
# (kSortK) keys in shared memory
NARROW_QUERIES, NARROW_ROWS, NARROW_BLOCKS = 64, 256, 132
# the int8 search's cutoff (kNQInt8): at or below it the narrow scorer's
# s8 form feeds the same select, above it the 128-query int8 kernel runs
INT8_NARROW_QUERIES = 64
KEY_ALIGN = 8
SELECT_ITEMS, SELECT_MIN_ITEM = 528, 8192
HEAD_INTS, STATE_INTS, RADIX_BINS, SORT_K = 4, 11, 2048, 4096

_PARTIAL_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 7
TOPK_PARTIAL = Kernel("topk_partial", "dense_topk.cu", _PARTIAL_ARGS)
TOPK_INT8_PARTIAL = Kernel("topk_int8_partial", "dense_topk.cu",
                           _PARTIAL_ARGS)
TOPK_MERGE = Kernel("topk_merge", "topk_scores.cu",
                    (ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 6)
GATHERED_TILES = Kernel("gathered_tiles", "topk_scores.cu",
                        (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 7)
_NARROW_ARGS = ((ctypes.c_void_p,) * 5 + (ctypes.c_longlong,)
                + (ctypes.c_int,) * 7)
TOPK_NARROW_SCORES = Kernel("topk_narrow_scores", "topk_scores.cu",
                            _NARROW_ARGS)
TOPK_NARROW_SCORES_INT8 = Kernel("topk_narrow_scores_int8", "topk_scores.cu",
                                 _NARROW_ARGS)
TOPK_NARROW_SELECT = Kernel("topk_narrow_select", "topk_scores.cu",
                            (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 6)
GATHERED_PIECE_COUNT = Kernel("gathered_piece_count", "topk_scores.cu",
                              (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 4)
GATHERED_PIECE_EMIT = Kernel("gathered_piece_emit", "topk_scores.cu",
                             (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 6)
GATHERED_RUNS = Kernel("gathered_runs", "topk_scores.cu",
                       (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 6)
# the merge: warps a block (kMergeWarps), entries a lane loads before it
# offers any (kMergeVec); the plan aims at MERGE_TARGET warps (a block on
# each of the card's 132 SMs) and cuts no segment below MERGE_MIN_SEG
# entries, two rounds of a warp's loads
MERGE_WARPS, MERGE_VEC = 8, 4
MERGE_TARGET = DENSE_BLOCKS * MERGE_WARPS
MERGE_MIN_SEG = 2 * 32 * MERGE_VEC
# the gathered search's cutoff (kGNQMax): at or below it a call takes the
# runs kernel (a block a query's RUN_SLOTS (kRunSlots) consecutive slots,
# no pieces, no host read before the launches), above it the pieces path
GATHERED_NARROW_QUERIES, RUN_SLOTS = 12, 128
# gathered: table rows a tile, pieces a block; they must equal kGTR and
# kGBQ in csrc/topk_scores.cu, whose blocks find their tile and pieces
# by them; the pieces kernels scan a query's slots PIECE_SLOTS
# (kPieceSlots) a block and count into PIECE_INFO (kPieceInfo) ints
TILE_ROWS, TILE_PIECES = 128, 32
PIECE_SLOTS, PIECE_INFO = 8192, 4


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


def split_plan(nq: int, n: int, q_tile: int, rows: int, blocks: int):
    """(tiles per split, splits): the corpus's ``rows``-row tiles cut into
    splits so that (query tiles of ``q_tile``) x splits comes near
    ``blocks``, every split but the last as long as the first and none
    empty."""
    n_tiles = -(-n // rows)
    q_tiles = -(-nq // q_tile)
    n_splits = max(1, min(n_tiles, -(-blocks // max(q_tiles, 1))))
    per_split = -(-n_tiles // n_splits)
    return per_split, -(-n_tiles // per_split)


def dense_plan(nq: int, n: int, blocks: int = DENSE_BLOCKS):
    """(tiles per split, splits) of the dense kernels: the corpus's
    DENSE_ROWS-row tiles cut into splits, a multiple of DENSE_CLUSTER, so
    that (query tiles of DENSE_QUERIES) x splits stays at or below
    ``blocks`` (a grid over the target would leave a second wave of a few
    blocks) unless one cluster a query tile is more. Every split walks the
    same number of tiles, as a cluster's blocks share each step's query
    chunk; tiles past the corpus (in the last splits) score nothing."""
    n_tiles = -(-n // DENSE_ROWS)
    q_tiles = -(-nq // DENSE_QUERIES)
    want = min(n_tiles, max(blocks // max(q_tiles, 1), 1))
    n_splits = DENSE_CLUSTER * max(1, want // DENSE_CLUSTER)
    per_split = -(-n_tiles // n_splits)
    used = -(-n_tiles // per_split)
    return per_split, -(-used // DENSE_CLUSTER) * DENSE_CLUSTER


def launch_partials(partial: Kernel, queries: torch.Tensor,
                    corpus: torch.Tensor, k: int, dtype, vec_width: int, *,
                    blocks: int):
    """Check the inputs, plan the splits (:func:`dense_plan`) and launch
    ``partial`` (a dense scan over the corpus rows: ``topk_partial`` or
    ``topk_int8_partial``): queries [Q, D], corpus [N, D] of ``dtype``,
    1 <= k <= N -> each split's top k, (scores f32[Q, splits * k], ids
    i32[Q, splits * k]). Rows of ``vec_width`` values, both inputs 16-byte
    aligned, reach the kernel by TMA; others by its staging path."""
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
    per_split, n_splits = dense_plan(nq, n, blocks)
    width = n_splits * k
    if max(nq, n, d * dtype.itemsize, width) >= 2 ** 31:
        raise ValueError(f"{name}: a dimension exceeds int32")
    if dtype == torch.int8 and d * 127 * 127 >= 2 ** 31:
        raise ValueError(f"{name}: D={d} overflows the int32 int8 dot")
    part_s = torch.empty((nq, width), dtype=torch.float32, device=dev)
    part_i = torch.empty((nq, width), dtype=torch.int32, device=dev)
    vec = int(dense_tma(d, vec_width, queries.data_ptr(), corpus.data_ptr()))
    with torch.cuda.device(dev):
        partial(queries.data_ptr(), corpus.data_ptr(), part_s.data_ptr(),
                part_i.data_ptr(), nq, n, d, k, per_split, n_splits, vec)
    return part_s, part_i


def dense_tma(d: int, vec_width: int, *ptrs: int) -> bool:
    """Whether the dense kernels take rows of d values by TMA: each row a
    whole number of 16-byte units (``vec_width`` values) and every base
    16-byte aligned, as a tensor map needs; else (a ragged stride, a
    sliced base, D = 0) the kernel's staging path copies them."""
    return d > 0 and d % vec_width == 0 and all(p % 16 == 0 for p in ptrs)


@functools.lru_cache(maxsize=512)
def merge_plan(nq: int, width: int, k: int):
    """(entries a segment, segments a row) of the merge: each row's width
    entries cut into segments of ``seg`` (a multiple of 32 MERGE_VEC), a
    warp each, so that nq x segments comes near MERGE_TARGET warps; no
    segment below MERGE_MIN_SEG or sqrt(width k) entries (the second
    level merges segments x k), and each longer than k (the kernel's
    segment lists hold k entries), so a row of the many that already fill
    the card, or a short one, stays whole: (max(width, 1), 1)."""
    step = 32 * MERGE_VEC
    seg = max(math.isqrt(width * k), -(-width * nq // MERGE_TARGET),
              MERGE_MIN_SEG, k + 1)
    seg = -(-seg // step) * step
    if seg >= width:
        return max(width, 1), 1
    return seg, -(-width // seg)


def launch_merge(part_s: torch.Tensor, part_i: torch.Tensor, k: int,
                 row_len: torch.Tensor = None,
                 cand_ids: torch.Tensor = None):
    """The merge kernel over partial lists: the top k of each row by
    (score desc, id asc) -> (scores f32[Q, k], ids i32[Q, k]). ``row_len``
    (i32[Q], optional): the entries each row holds, its first ones; the
    rest are never read, so they need not be written. ``cand_ids`` (i32[Q,
    C], optional): the ids are candidate positions, and each winner's id
    is ``cand_ids[q, position]``, -1 where its score is not finite. Each
    row is cut into segments over the card (:func:`merge_plan`)."""
    nq, width = part_s.shape
    dev = part_s.device
    seg, n_seg = merge_plan(nq, width, k)
    out_s = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    seg_s = seg_i = done = None
    if n_seg > 1:           # the segments' lists, then a count a row
        scratch = torch.empty(2 * nq * n_seg * k + nq, dtype=torch.int32,
                              device=dev)
        seg_s = scratch.data_ptr()
        seg_i = seg_s + 4 * nq * n_seg * k
        done = seg_i + 4 * nq * n_seg * k
    with torch.cuda.device(dev):
        TOPK_MERGE(part_s.data_ptr(), part_i.data_ptr(),
                   None if row_len is None else row_len.data_ptr(),
                   None if cand_ids is None else cand_ids.data_ptr(),
                   out_s.data_ptr(), out_i.data_ptr(), seg_s, seg_i, done,
                   nq, width, k, 0 if cand_ids is None else cand_ids.shape[1],
                   seg, n_seg)
    return out_s, out_i


def merge_plain(part_s: torch.Tensor, part_i: torch.Tensor, k: int,
                row_len: torch.Tensor = None,
                cand_ids: torch.Tensor = None):
    """The merge kernel's plain version, in torch ops on the inputs'
    device: entries past a row's ``row_len`` and every -inf entry left out
    (the kernel keeps none), a stable sort by id, then a stable sort by
    score descending, the first k, padded with (-inf, -1); ids through
    ``cand_ids`` as :func:`launch_merge` maps them."""
    width = part_s.shape[1]
    s, i = part_s, part_i
    if row_len is not None:
        past = (torch.arange(width, device=s.device)[None, :]
                >= row_len[:, None])
        s = torch.where(past, -torch.inf, s)
    i = torch.where(s == -torch.inf, -1, i)
    by_id = torch.sort(i, dim=1, stable=True).indices
    s, i = torch.gather(s, 1, by_id), torch.gather(i, 1, by_id)
    pos = torch.sort(s, dim=1, descending=True, stable=True).indices[:, :k]
    s, i = pad_topk(torch.gather(s, 1, pos), torch.gather(i, 1, pos), k)
    if cand_ids is not None:
        ids = torch.gather(cand_ids, 1, i.clamp(min=0).long())
        i = torch.where(torch.isfinite(s), ids, -1)
    return s, i.to(torch.int32)


def topk_partials_cuda(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                       blocks: int = DENSE_BLOCKS):
    """The f32 kernel's partial lists before the merge: queries f32[Q, D],
    corpus f32[N, D], 1 <= k <= N -> (scores f32[Q, splits * k], ids
    i32[Q, splits * k]); ``blocks`` is the split plan's target block
    count."""
    return launch_partials(TOPK_PARTIAL, queries, corpus, k, torch.float32,
                           4, blocks=blocks)


def topk_scores_cuda(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                     blocks: int = DENSE_BLOCKS):
    """Launch the f32 kernel pair: queries f32[Q, D], corpus f32[N, D],
    1 <= k <= N -> (scores f32[Q, k], ids i32[Q, k]); ``blocks`` is the
    split plan's target block count."""
    return launch_merge(*topk_partials_cuda(queries, corpus, k, blocks), k)


def narrow_plan(n: int):
    """(tiles per block, blocks) of the narrow scorer: the corpus's
    NARROW_ROWS-row tiles cut into near NARROW_BLOCKS runs, every run but
    the last as long as the first and none empty; each block scores its
    run against every query."""
    return split_plan(1, n, 1, NARROW_ROWS, NARROW_BLOCKS)


def select_plan(nq: int, n: int):
    """(chunks, keys a chunk) of the narrow select: each query's n keys cut
    into chunks of whole NARROW_ROWS-row tiles (the last shorter, some
    past n empty), no more than SELECT_ITEMS // nq and none below
    SELECT_MIN_ITEM keys but where there is only one."""
    chunks = max(1, min(SELECT_ITEMS // max(nq, 1), -(-n // SELECT_MIN_ITEM)))
    per = -(-n // chunks)
    return chunks, -(-per // NARROW_ROWS) * NARROW_ROWS


def select_scratch_ints(nq: int, chunks: int) -> int:
    """Ints of the select kernel's scratch: its grid barrier and the count
    of queries it does not finish compact, each query's state, four
    histograms a query and a tie count an item."""
    return (HEAD_INTS + nq * STATE_INTS + 4 * nq * RADIX_BINS
            + nq * chunks)


class Narrow(NamedTuple):
    """The narrow scorer's output and the select kernel's working space:
    one int32 buffer ``buf`` holding, from ``at[0]``, ``at[1]``, ...:
    ``keys`` (Q, ldk), each score's order key in entries [0, N);
    ``tile_max`` (Q, tiles), each NARROW_ROWS-row tile's largest key;
    ``scratch``, zeroed by the scorer; ``cand_k`` and ``cand_i`` (Q, cap),
    cap the larger of SORT_K and the power of two at or above k. The
    launches take pointers into ``buf``; :meth:`view` gives a part as a
    tensor."""

    buf: torch.Tensor
    at: tuple
    shapes: tuple
    n: int
    chunks: int

    PARTS = ("keys", "tile_max", "scratch", "cand_k", "cand_i")

    def ptrs(self) -> list:
        """Each part's address, in PARTS' order."""
        base = self.buf.data_ptr()
        return [base + 4 * at for at in self.at]

    def view(self, part: str) -> torch.Tensor:
        i = self.PARTS.index(part)
        shape = self.shapes[i]
        size = shape[0] * shape[1] if len(shape) == 2 else shape[0]
        return self.buf[self.at[i]:self.at[i] + size].view(shape)


@functools.lru_cache(maxsize=512)
def _narrow_layout(nq: int, n: int, k: int):
    """The narrow pair's plan for (Q, N, k), computed once a shape: (ldk,
    tiles a scorer block, scorer blocks, select chunks, cap, scratch ints,
    the parts' shapes, their offsets in the buffer, its length)."""
    ldk = -(-n // KEY_ALIGN) * KEY_ALIGN
    per_block, blocks = narrow_plan(n)
    n_tiles = -(-n // NARROW_ROWS)
    chunks, _ = select_plan(nq, n)
    cap = max(1 << (k - 1).bit_length(), SORT_K)
    n_scratch = select_scratch_ints(nq, chunks)
    shapes = ((nq, ldk), (nq, n_tiles), (n_scratch,), (nq, cap), (nq, cap))
    sizes = [nq * ldk, nq * n_tiles, n_scratch, nq * cap, nq * cap]
    at = tuple(sum(sizes[:i]) for i in range(len(sizes)))
    return ldk, per_block, blocks, chunks, cap, n_scratch, shapes, at, \
        sum(sizes)


# the narrow scorer of each input type: its kernel, the most queries the
# path takes (the type's cutoff) and the row width in elements that makes
# a row 16-byte aligned
_NARROW = {torch.float32: (TOPK_NARROW_SCORES, NARROW_QUERIES, 4),
           torch.int8: (TOPK_NARROW_SCORES_INT8, INT8_NARROW_QUERIES, 16)}


def _narrow_scores(queries: torch.Tensor, corpus: torch.Tensor,
                   k: int) -> Narrow:
    dev, dtype = queries.device, queries.dtype
    if dtype not in _NARROW:
        raise ValueError(f"topk_narrow_scores: queries must be float32 or "
                         f"int8, got {dtype}")
    scorer, most, vec_width = _NARROW[dtype]
    name = scorer.name
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    _check(queries, "queries", dtype, dev, name)
    _check(corpus, "corpus", dtype, dev, name)
    nq, d = queries.shape
    n = corpus.shape[0]
    if corpus.shape[1] != d:
        raise ValueError(f"{name}: widths differ, {d} vs {corpus.shape[1]}")
    if not 1 <= nq <= most:
        raise ValueError(f"{name}: Q={nq} outside [1, {most}]")
    if not 1 <= k <= n:
        raise ValueError(f"{name}: k={k} outside [1, N={n}]")
    if dtype == torch.int8 and d * 127 * 127 >= 2 ** 31:
        raise ValueError(f"{name}: D={d} overflows the int32 int8 dot")
    (ldk, per_block, blocks, chunks, _, n_scratch, shapes, at,
     total) = _narrow_layout(nq, n, k)
    if max(ldk, d * dtype.itemsize) >= 2 ** 31:
        raise ValueError(f"{name}: a dimension exceeds int32")
    buf = torch.empty(total, dtype=torch.int32, device=dev)
    base = buf.data_ptr()
    vec = int(d % vec_width == 0 and _aligned(queries, corpus))
    scorer(queries.data_ptr(), corpus.data_ptr(), base + 4 * at[0],
           base + 4 * at[1], base + 4 * at[2], n_scratch, nq, n, d, ldk,
           per_block, blocks, vec)
    return Narrow(buf, at, shapes, n, chunks)


def _narrow_select(nar: Narrow, k: int):
    (nq, ldk), cap = nar.shapes[0], nar.shapes[3][1]
    out = torch.empty((2, nq, k), dtype=torch.int32, device=nar.buf.device)
    TOPK_NARROW_SELECT(*nar.ptrs(), out.data_ptr(),
                       out.data_ptr() + 4 * nq * k, nq, nar.n, ldk, k,
                       nar.chunks, cap)
    return out[0].view(torch.float32), out[1]


def narrow_scores_cuda(queries: torch.Tensor, corpus: torch.Tensor,
                       k: int) -> Narrow:
    """Launch the narrow scorer: queries f32[Q, D] (1 <= Q <=
    NARROW_QUERIES) or int8 codes (1 <= Q <= INT8_NARROW_QUERIES), corpus
    of the same type [N, D], 1 <= k <= N -> the keys and the select's
    space (:class:`Narrow`)."""
    with torch.cuda.device(queries.device):
        return _narrow_scores(queries, corpus, k)


def narrow_select_cuda(nar: Narrow, k: int):
    """Launch the select kernel over the narrow scorer's keys (its scratch
    as the scorer left it: zeroed) -> the k best of each query, (scores
    f32[Q, k], ids i32[Q, k]) by (score desc, id asc), -inf scores with id
    -1."""
    with torch.cuda.device(nar.buf.device):
        return _narrow_select(nar, k)


def topk_narrow_cuda(queries: torch.Tensor, corpus: torch.Tensor, k: int):
    """Launch the narrow kernel pair: queries f32[Q, D] (Q <=
    NARROW_QUERIES) or int8 codes (Q <= INT8_NARROW_QUERIES), corpus of
    the same type [N, D], 1 <= k <= N -> (scores f32[Q, k], ids i32[Q,
    k]); an int8 score is the exact dot rounded to f32."""
    with torch.cuda.device(queries.device):
        return _narrow_select(_narrow_scores(queries, corpus, k), k)


def score_keys(scores: torch.Tensor) -> torch.Tensor:
    """The order keys of f32 scores as the kernels make them (uint32 bits
    in int32): a larger score has a larger unsigned key, -0.0 has +0.0's
    and -inf the least of any number's."""
    bits = scores.contiguous().view(torch.int32)
    bits = torch.where(bits == -2 ** 31, 0, bits)
    return torch.where(bits < 0, ~bits, bits | -2 ** 31)


def key_scores(keys: torch.Tensor) -> torch.Tensor:
    """The f32 scores of order keys (int32 holding the kernels' uint32
    keys): the inverse of the key map, with -0.0 come back as +0.0."""
    bits = torch.where(keys < 0, keys & 0x7FFFFFFF, ~keys)
    return bits.view(torch.float32)


def topk_scores_int8_cuda(q_codes: torch.Tensor, c_codes: torch.Tensor,
                          k: int, blocks: int = DENSE_BLOCKS):
    """Launch the int8 kernel pair: codes int8[Q, D] x int8[N, D], 1 <= k
    <= N -> (int dot as f32 [Q, k], ids i32[Q, k]); ``blocks`` is the
    split plan's target block count."""
    return launch_merge(*launch_partials(
        TOPK_INT8_PARTIAL, q_codes, c_codes, k, torch.int8, 16,
        blocks=blocks), k)


class Pieces(NamedTuple):
    """The valid candidates of a gathered search, cut into pieces.

    A piece is a run of one query's valid candidate positions whose rows
    are consecutive table rows inside one tile of ``TILE_ROWS`` rows. Row
    ``j`` of ``pieces`` is (query, first row, length, first position, slot
    offset), int32, sorted by tile (stably, so queries keep their order in
    a tile). A piece's top-min(k, length) list goes to row ``query`` of a
    (Q, ``width``) partial buffer, from column ``slot offset``; ``width``
    bounds every query's slots (C, or k per piece of the query with the
    most, whichever is fewer), and a query's slots fill the first
    ``row_len[query]`` columns of its row. ``blk_first`` names the first
    piece of each block of the kernel: every ``TILE_PIECES``-th piece of a
    tile, then -1 up to a length the host can compute without reading the
    device."""

    pieces: torch.Tensor
    blk_first: torch.Tensor
    width: int
    row_len: torch.Tensor


def _stray_error(n_rows: int) -> ValueError:
    return ValueError(f"gathered_topk: a valid candidate's row lies "
                      f"outside the table's {n_rows} rows")


def _blocks(tiles_sorted: torch.Tensor, n: int, n_rows: int) -> torch.Tensor:
    """Each kernel block's first piece (every TILE_PIECES-th piece of a
    tile) from the pieces' tiles in sorted order, then -1 up to a length
    the host computes from n and the table's tiles."""
    rank = (torch.arange(n, device=tiles_sorted.device)
            - torch.searchsorted(tiles_sorted, tiles_sorted))
    n_blocks = -(-n // TILE_PIECES) + min(n, -(-n_rows // TILE_ROWS))
    return torch.nonzero_static(rank % TILE_PIECES == 0, size=n_blocks,
                                fill_value=-1).flatten().to(torch.int32)


def gathered_pieces(cand_rows: torch.Tensor, cand_ids: torch.Tensor,
                    n_rows: int, k: int) -> Pieces:
    """Cut the valid slots (``cand_ids >= 0``) of ``cand_rows`` (Q, C)
    into pieces. On the card, two kernels (``gathered_piece_count``, then
    ``gathered_piece_emit``) each read the slots once; on the CPU the
    plain version (:func:`gathered_pieces_plain`) gives the same pieces.
    Either way one host read (the piece count, the most pieces a query
    has, whether a valid slot's row lies outside ``[0, n_rows)``, which
    raises) sizes the outputs, and a stable sort orders the pieces by
    tile."""
    if n_rows + n_rows // TILE_ROWS >= 2 ** 31:
        raise ValueError(f"gathered_topk: {n_rows} table rows exceed the "
                         f"int32 row index with a gap after each tile")
    if cand_ids.device.type == "cpu":
        return gathered_pieces_plain(cand_rows, cand_ids, n_rows, k)
    return gathered_pieces_cuda(cand_rows, cand_ids, n_rows, k)


def gathered_pieces_cuda(cand_rows: torch.Tensor, cand_ids: torch.Tensor,
                         n_rows: int, k: int) -> Pieces:
    """:func:`gathered_pieces` by its kernels: cand_rows/cand_ids i32[Q, C]
    contiguous on the card."""
    qn, c = cand_ids.shape
    dev = cand_ids.device
    chunks = max(1, -(-c // PIECE_SLOTS))
    if qn * chunks >= 2 ** 31 or chunks >= 2 ** 16:
        raise ValueError(f"gathered_topk: Q={qn} x C={c} slots exceed the "
                         f"pieces kernels' grid")
    # info (zeroed: the count kernel's last block finds itself by it),
    # then counts and each (query, chunk)'s first piece number
    scratch = torch.zeros(PIECE_INFO + 2 * qn * chunks, dtype=torch.int32,
                          device=dev)
    ptr = scratch.data_ptr()
    info, counts, base = ptr, ptr + 4 * PIECE_INFO, \
        ptr + 4 * (PIECE_INFO + qn * chunks)
    with torch.cuda.device(dev):
        GATHERED_PIECE_COUNT(cand_rows.data_ptr(), cand_ids.data_ptr(),
                             counts, base, info, qn, c, chunks, n_rows)
        # the one host read (it sizes the outputs)
        # lint: disable=torch-host-sync
        n, stray, most = scratch[:3].tolist()
        if stray:
            raise _stray_error(n_rows)
        out = torch.empty(6 * n + qn, dtype=torch.int32, device=dev)
        pieces = out[:5 * n].view(n, 5)
        tiles, row_len = out[5 * n:6 * n], out[6 * n:]
        GATHERED_PIECE_EMIT(cand_rows.data_ptr(), cand_ids.data_ptr(), base,
                            pieces.data_ptr(), tiles.data_ptr(),
                            row_len.data_ptr(), qn, c, chunks, n, n_rows, k)
    t_sorted, order = torch.sort(tiles, stable=True)
    return Pieces(pieces[order], _blocks(t_sorted, n, n_rows),
                  max(min(c, k * most), 1), row_len)


def gathered_pieces_plain(cand_rows: torch.Tensor, cand_ids: torch.Tensor,
                          n_rows: int, k: int) -> Pieces:
    """The pieces kernels' plain version, in torch ops on the inputs'
    device: the passes over the (Q, C) inputs are elementwise, the rest
    works on the pieces."""
    qn, c = cand_ids.shape
    dev = cand_ids.device
    valid = cand_ids >= 0
    rows = cand_rows
    if n_rows:
        lo, hi = (torch.aminmax(torch.where(valid, rows, 0)) if valid.numel()
                  else (torch.zeros((), dtype=rows.dtype, device=dev),) * 2)
        stray = (lo < 0) | (hi >= n_rows)
    else:
        stray = valid.any()
    # rows with a gap after each tile and -2 at invalid slots: a slot
    # continues its left neighbour's piece (both valid, the next row, the
    # same tile) exactly when the step between them is 1
    gapped = torch.where(valid, rows + rows // TILE_ROWS, -2)
    cont = torch.diff(gapped, dim=1) == 1
    # cont implies valid on both sides, so xor clears the slots it joins
    start = torch.empty_like(valid)
    start[:, :1] = valid[:, :1]
    torch.bitwise_xor(valid[:, 1:], cont, out=start[:, 1:])
    end = torch.empty_like(valid)
    end[:, -1:] = valid[:, -1:]
    torch.bitwise_xor(valid[:, :-1], cont, out=end[:, :-1])
    per_query = start.sum(1)
    most = per_query.max() if qn else per_query.sum()
    # the one host read (it sizes the outputs)
    # lint: disable=torch-host-sync
    n, any_stray, most = torch.stack([per_query.sum(), stray.long(),
                                      most]).tolist()
    if any_stray:
        raise _stray_error(n_rows)
    s_at = torch.nonzero_static(start.flatten(), size=n).flatten()
    length = torch.nonzero_static(end.flatten(), size=n).flatten() - s_at + 1
    q_of = s_at // c
    # slot offsets: the lists of the query's earlier pieces come first
    kept = length.clamp(max=k)
    before = torch.cumsum(kept, 0) - kept
    off = before - before[torch.searchsorted(q_of, q_of)]
    row_len = torch.zeros(qn, dtype=torch.int32, device=dev).index_add_(
        0, q_of, kept.to(torch.int32))
    first_row = rows.flatten()[s_at].long()
    t_sorted, order = torch.sort(first_row // TILE_ROWS, stable=True)
    pieces = torch.stack([q_of, first_row, length, s_at % c, off],
                         1)[order].to(torch.int32)
    return Pieces(pieces, _blocks(t_sorted.contiguous(), n, n_rows),
                  max(min(c, k * most), 1), row_len)


def runs_width(c: int, k: int) -> int:
    """Columns of the runs kernel's partial buffer: a list of min(k,
    RUN_SLOTS) entries for each of a row's ceil(C / RUN_SLOTS) runs."""
    return -(-c // RUN_SLOTS) * min(k, RUN_SLOTS)


def gathered_runs_plain(queries: torch.Tensor, table: torch.Tensor,
                        cand_rows: torch.Tensor, cand_ids: torch.Tensor,
                        k: int, chunk_bytes: int = 1 << 30):
    """The runs kernel's plain version, in torch ops on the inputs' device:
    each run of RUN_SLOTS consecutive slots of a query keeps its top
    min(k, RUN_SLOTS) (score, position) list by (score desc, position
    asc), padded with (-inf, -1) -> (scores f32[Q, W], positions i32[Q,
    W]), W = :func:`runs_width`, run j's list in columns [j kk, + kk).
    Invalid slots (id -1) and -inf scores are left out; a valid slot whose
    row lies outside the table raises. Queries go in chunks whose gathered
    rows stay under ``chunk_bytes``, as ``ref.gathered_topk_ref``'s do.
    :func:`merge_plain` with ``cand_ids`` turns the lists into the
    search's result."""
    qn, c = cand_ids.shape
    r = table.shape[0]
    valid = cand_ids >= 0
    # lint: disable=torch-host-sync
    if bool((valid & ((cand_rows < 0) | (cand_rows >= r))).any()):
        raise _stray_error(r)
    runs, kk = -(-c // RUN_SLOTS), min(k, RUN_SLOTS)
    per_query = max(1, c * table.shape[1] * table.element_size())
    step = max(1, chunk_bytes // per_query)
    out_s, out_p = [], []
    for q0 in range(0, qn, step):
        ok = valid[q0:q0 + step]
        rows = torch.where(ok, cand_rows[q0:q0 + step], 0).long()
        s = torch.einsum("qd,qcd->qc", queries[q0:q0 + step],
                         table[rows]).to(torch.float32)
        s = torch.where(ok, s, -torch.inf)
        s = torch.nn.functional.pad(s, (0, runs * RUN_SLOTS - c),
                                    value=-torch.inf)
        s = s.view(s.shape[0], runs, RUN_SLOTS)
        pos = torch.sort(s, dim=2, descending=True,
                         stable=True).indices[:, :, :kk]
        top = torch.gather(s, 2, pos)
        pos = pos + RUN_SLOTS * torch.arange(runs, device=s.device)[:, None]
        pos = torch.where(top == -torch.inf, -1, pos)
        out_s.append(top.reshape(top.shape[0], runs * kk))
        out_p.append(pos.reshape(top.shape[0], runs * kk).to(torch.int32))
    if not out_s:
        dev = queries.device
        return (torch.empty((0, runs * kk), dtype=torch.float32, device=dev),
                torch.empty((0, runs * kk), dtype=torch.int32, device=dev))
    return torch.cat(out_s), torch.cat(out_p)


def _runs_lists(queries: torch.Tensor, table: torch.Tensor,
                cand_rows: torch.Tensor, cand_ids: torch.Tensor, k: int):
    """Launch the runs kernel (inputs as :func:`gathered_topk_cuda` takes
    them; any Q up to its grid's 65535) -> its lists (scores f32[Q, W],
    positions i32[Q, W], as :func:`gathered_runs_plain` gives them) and
    its stray-row flag (i32[], nonzero where a valid slot's row lies
    outside the table), not yet read. The grid and the buffers follow
    from (Q, C) alone."""
    nq, d, c, r = _gathered_shapes(queries, table, cand_rows, cand_ids, k,
                                   GATHERED_RUNS.name)
    if nq > 65535:
        raise ValueError(f"{GATHERED_RUNS.name}: Q={nq} exceeds its grid")
    dev = queries.device
    width = runs_width(c, k)
    part_s = torch.empty((nq, width), dtype=torch.float32, device=dev)
    part_p = torch.empty((nq, width), dtype=torch.int32, device=dev)
    stray = torch.empty((), dtype=torch.int32, device=dev)
    vec = int(d % 4 == 0 and _aligned(queries, table))
    with torch.cuda.device(dev):
        GATHERED_RUNS(queries.data_ptr(), table.data_ptr(),
                      cand_rows.data_ptr(), cand_ids.data_ptr(),
                      part_s.data_ptr(), part_p.data_ptr(), stray.data_ptr(),
                      nq, c, r, d, k, vec)
    return part_s, part_p, stray


def gathered_runs_cuda(queries: torch.Tensor, table: torch.Tensor,
                       cand_rows: torch.Tensor, cand_ids: torch.Tensor,
                       k: int):
    """The gathered search for few queries (the wrapper sends it Q <=
    GATHERED_NARROW_QUERIES): the runs kernel, then the merge, which maps
    positions to ids; inputs as :func:`gathered_topk_cuda` takes them.
    Nothing is read back before the last launch; then the runs kernel's
    stray-row flag is read (the call's one host read) and raises."""
    part_s, part_p, stray = _runs_lists(queries, table, cand_rows, cand_ids,
                                        k)
    with torch.cuda.device(queries.device):
        out = launch_merge(part_s, part_p, k, cand_ids=cand_ids)
    # the one host read, after the last launch: the stray-row flag
    # lint: disable=torch-host-sync
    if stray.item():
        raise _stray_error(table.shape[0])
    return out


def _gathered_shapes(queries: torch.Tensor, table: torch.Tensor,
                     cand_rows: torch.Tensor, cand_ids: torch.Tensor, k: int,
                     name: str) -> tuple:
    """Check a gathered search's inputs -> (Q, D, C, R)."""
    dev = queries.device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    _check(queries, "queries", torch.float32, dev, name)
    _check(table, "table", torch.float32, dev, name)
    _check(cand_rows, "cand_rows", torch.int32, dev, name)
    _check(cand_ids, "cand_ids", torch.int32, dev, name)
    nq, d = queries.shape
    c = cand_ids.shape[1]
    r = table.shape[0]
    if table.shape[1] != d:
        raise ValueError(f"{name}: widths differ, {d} vs {table.shape[1]}")
    if cand_rows.shape != (nq, c) or cand_ids.shape[0] != nq:
        raise ValueError(f"{name}: cand_rows {tuple(cand_rows.shape)} and "
                         f"cand_ids {tuple(cand_ids.shape)} must both be "
                         f"(Q={nq}, C)")
    if not 1 <= k <= c:
        raise ValueError(f"{name}: k={k} outside [1, C={c}]")
    if max(nq, c, d, r) >= 2 ** 31:
        raise ValueError(f"{name}: a dimension exceeds int32")
    return nq, d, c, r


def gathered_tiles_cuda(queries: torch.Tensor, table: torch.Tensor,
                        cand_rows: torch.Tensor, cand_ids: torch.Tensor,
                        k: int):
    """The gathered search's pieces path, for any Q: each probed row tile
    is read once for every 32 pieces that probe it (``gathered_pieces``),
    then the merge maps the winning positions to ids."""
    nq, d, _, r = _gathered_shapes(queries, table, cand_rows, cand_ids, k,
                                   GATHERED_TILES.name)
    dev = queries.device
    pieces, blk_first, width, row_len = gathered_pieces(cand_rows, cand_ids,
                                                        r, k)
    # the kernel writes each piece's slots and nothing else: a query's
    # lists fill its row's first row_len entries, all the merge reads
    part_s = torch.empty((nq, width), dtype=torch.float32, device=dev)
    part_p = torch.empty((nq, width), dtype=torch.int32, device=dev)
    vec = int(d % 4 == 0 and _aligned(queries, table))
    with torch.cuda.device(dev):
        GATHERED_TILES(queries.data_ptr(), table.data_ptr(),
                       pieces.data_ptr(), blk_first.data_ptr(),
                       part_s.data_ptr(), part_p.data_ptr(), pieces.shape[0],
                       blk_first.shape[0], r, d, k, width, vec)
        return launch_merge(part_s, part_p, k, row_len, cand_ids)


def gathered_topk_cuda(queries: torch.Tensor, table: torch.Tensor,
                       cand_rows: torch.Tensor, cand_ids: torch.Tensor,
                       k: int):
    """Launch the gathered kernels: queries f32[Q, D], table f32[R, D],
    cand_rows/cand_ids i32[Q, C], 1 <= k <= C -> (scores f32[Q, k], ids
    i32[Q, k]). Q <= GATHERED_NARROW_QUERIES: the runs kernel and the merge
    (:func:`gathered_runs_cuda`); above it the pieces path
    (:func:`gathered_tiles_cuda`). The kernels rank (score, position); the
    merge maps the winning positions to ids, -1 where the score is
    -inf."""
    if queries.shape[0] <= GATHERED_NARROW_QUERIES:
        return gathered_runs_cuda(queries, table, cand_rows, cand_ids, k)
    return gathered_tiles_cuda(queries, table, cand_rows, cand_ids, k)


def empty_topk(nq: int, k: int, device):
    """All misses: the result of a search with no query or no candidate."""
    return pad_topk(torch.empty((nq, 0), dtype=torch.float32, device=device),
                    torch.empty((nq, 0), dtype=torch.int32, device=device), k)


def topk_scores(queries: torch.Tensor, corpus: torch.Tensor, *, k: int,
                split_blocks: int = None):
    """Top-k inner-product search: (Q, D) x (N, D) -> (Q, k) scores/ids.
    On the card, Q <= NARROW_QUERIES takes the narrow kernel pair, a larger
    Q the 128-query partial kernel and the merge, whose split target
    resolves through the autotuner (``kernels/tuning``): ``split_blocks``
    > tuned table > DENSE_BLOCKS."""
    blocks = tuning.resolve("topk", n=corpus.shape[0], dtype=queries.dtype,
                            split_blocks=split_blocks)
    k_eff = min(k, corpus.shape[0])
    if queries.device.type == "cpu":
        return pad_topk(*ref.topk_scores_ref(queries, corpus, k=k_eff), k)
    if k_eff == 0 or queries.shape[0] == 0:
        return empty_topk(queries.shape[0], k, queries.device)
    q32 = queries.to(torch.float32).contiguous()
    c32 = corpus.to(torch.float32).contiguous()
    if queries.shape[0] <= NARROW_QUERIES:
        s, i = topk_narrow_cuda(q32, c32, k_eff)
    else:
        s, i = topk_scores_cuda(q32, c32, k_eff, blocks["split_blocks"])
    return pad_topk(s, i, k)


def topk_scores_int8(q_codes: torch.Tensor, c_codes: torch.Tensor, *,
                     k: int, split_blocks: int = None):
    """Quantized top-k scan: int8 codes (Q, D) x (N, D) -> (Q, k) int-dot
    scores (as f32) and ids. Ranking is scale-invariant, so callers rank on
    the raw dot and rerank the winners in float
    (retrieval/backends.py ``Int8Backend``). On the card, Q <=
    INT8_NARROW_QUERIES takes the narrow pair (the s8 scorer, then the
    select), a larger Q the 128-query int8 kernel and the merge."""
    blocks = tuning.resolve("topk", n=c_codes.shape[0], dtype="int8",
                            split_blocks=split_blocks)
    k_eff = min(k, c_codes.shape[0])
    if q_codes.device.type == "cpu":
        return pad_topk(*ref.topk_scores_int8_ref(q_codes, c_codes, k=k_eff),
                        k)
    if k_eff == 0 or q_codes.shape[0] == 0:
        return empty_topk(q_codes.shape[0], k, q_codes.device)
    qc, cc = q_codes.contiguous(), c_codes.contiguous()
    if q_codes.shape[0] <= INT8_NARROW_QUERIES:
        s, i = topk_narrow_cuda(qc, cc, k_eff)
    else:
        s, i = topk_scores_int8_cuda(qc, cc, k_eff, blocks["split_blocks"])
    return pad_topk(s, i, k)


def gathered_topk(queries: torch.Tensor, table: torch.Tensor,
                  cand_rows: torch.Tensor, cand_ids: torch.Tensor, *,
                  k: int):
    """Per-query candidate top-k: candidate c of query q is
    ``table[cand_rows[q, c]]``, id ``cand_ids[q, c]`` (-1 = invalid slot,
    scored -inf) -> (Q, k) scores/ids, ties to the earlier position. The
    ivfflat probe passes its index's list table and the probed list rows,
    so no (Q, C, D) tensor is ever built. Its tiles resolve through the
    autotuner, which holds a tuned table's to the compiled ones."""
    tuning.resolve("gathered_topk", n=cand_ids.shape[1], dtype=queries.dtype)
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
