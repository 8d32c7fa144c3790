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

Each wrapper first resolves its launch params through the autotuner
(kernels/tuning.py: explicit kwarg > tuned table > default), as the
reference's do; of these only the 128-query kernels' split target
(``split_blocks``, DENSE_BLOCKS by default) varies a launch.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import tuning
from repro_torch.kernels.build import Kernel
from repro_torch.kernels.topk_scoring import ref
from repro_torch.kernels.topk_scoring.ref import pad_topk

# the dense kernels' query and corpus tiles, kDQ and kDN in
# csrc/topk_scores.cu: a block takes DENSE_QUERIES queries and walks
# DENSE_ROWS-row tiles of its split; one block fills an H100 SM, so the
# plan aims at one block for each of its 132 SMs
DENSE_QUERIES, DENSE_ROWS = 128, 128
DENSE_BLOCKS = 132

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
KEY_ALIGN = 8
SELECT_ITEMS, SELECT_MIN_ITEM = 528, 8192
HEAD_INTS, STATE_INTS, RADIX_BINS, SORT_K = 4, 11, 2048, 4096

_PARTIAL_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 7
TOPK_PARTIAL = Kernel("topk_partial", "topk_scores.cu", _PARTIAL_ARGS)
TOPK_INT8_PARTIAL = Kernel("topk_int8_partial", "topk_scores.cu",
                           _PARTIAL_ARGS)
TOPK_MERGE = Kernel("topk_merge", "topk_scores.cu",
                    (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 3)
GATHERED_TILES = Kernel("gathered_tiles", "topk_scores.cu",
                        (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 7)
TOPK_NARROW_SCORES = Kernel("topk_narrow_scores", "topk_scores.cu",
                            (ctypes.c_void_p,) * 5 + (ctypes.c_longlong,)
                            + (ctypes.c_int,) * 7)
TOPK_NARROW_SELECT = Kernel("topk_narrow_select", "topk_scores.cu",
                            (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 6)
# gathered: table rows a tile, pieces a block; they must equal kGTR and
# kGBQ in csrc/topk_scores.cu, whose blocks find their tile and pieces
# by them
TILE_ROWS, TILE_PIECES = 128, 32


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


def launch_partials(partial: Kernel, queries: torch.Tensor,
                    corpus: torch.Tensor, k: int, dtype, vec_width: int, *,
                    q_tile: int, rows: int, blocks: int):
    """Check the inputs, plan the splits and launch ``partial`` (a dense
    scan over the corpus rows: ``topk_partial`` or ``topk_int8_partial``,
    whose tiles are ``q_tile`` queries by ``rows`` corpus rows): queries
    [Q, D], corpus [N, D] of ``dtype``, 1 <= k <= N -> each split's top k,
    (scores f32[Q, splits * k], ids i32[Q, splits * k])."""
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
    per_split, n_splits = split_plan(nq, n, q_tile, rows, blocks)
    width = n_splits * k
    if max(nq, n, d * dtype.itemsize, width) >= 2 ** 31:
        raise ValueError(f"{name}: a dimension exceeds int32")
    if dtype == torch.int8 and d * 127 * 127 >= 2 ** 31:
        raise ValueError(f"{name}: D={d} overflows the int32 int8 dot")
    part_s = torch.empty((nq, width), dtype=torch.float32, device=dev)
    part_i = torch.empty((nq, width), dtype=torch.int32, device=dev)
    vec = int(d % vec_width == 0 and _aligned(queries, corpus))
    with torch.cuda.device(dev):
        partial(queries.data_ptr(), corpus.data_ptr(), part_s.data_ptr(),
                part_i.data_ptr(), nq, n, d, k, per_split, n_splits, vec)
    return part_s, part_i


def launch_merge(part_s: torch.Tensor, part_i: torch.Tensor, k: int):
    """The merge kernel over partial lists: the top k of each row by
    (score desc, id asc) -> (scores f32[Q, k], ids i32[Q, k])."""
    nq, width = part_s.shape
    out_s = torch.empty((nq, k), dtype=torch.float32, device=part_s.device)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=part_s.device)
    with torch.cuda.device(part_s.device):
        TOPK_MERGE(part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(),
                   out_i.data_ptr(), nq, width, k)
    return out_s, out_i


def topk_partials_cuda(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                       blocks: int = DENSE_BLOCKS):
    """The f32 kernel's partial lists before the merge: queries f32[Q, D],
    corpus f32[N, D], 1 <= k <= N -> (scores f32[Q, splits * k], ids
    i32[Q, splits * k]); ``blocks`` is the split plan's target block
    count."""
    return launch_partials(TOPK_PARTIAL, queries, corpus, k, torch.float32,
                           4, q_tile=DENSE_QUERIES, rows=DENSE_ROWS,
                           blocks=blocks)


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


def _narrow_scores(queries: torch.Tensor, corpus: torch.Tensor,
                   k: int) -> Narrow:
    dev = queries.device
    name = TOPK_NARROW_SCORES.name
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    _check(queries, "queries", torch.float32, dev, name)
    _check(corpus, "corpus", torch.float32, dev, name)
    nq, d = queries.shape
    n = corpus.shape[0]
    if corpus.shape[1] != d:
        raise ValueError(f"{name}: widths differ, {d} vs {corpus.shape[1]}")
    if not 1 <= nq <= NARROW_QUERIES:
        raise ValueError(f"{name}: Q={nq} outside [1, {NARROW_QUERIES}]")
    if not 1 <= k <= n:
        raise ValueError(f"{name}: k={k} outside [1, N={n}]")
    ldk = -(-n // KEY_ALIGN) * KEY_ALIGN
    if max(ldk, d * 4) >= 2 ** 31:
        raise ValueError(f"{name}: a dimension exceeds int32")
    per_block, blocks = narrow_plan(n)
    n_tiles = -(-n // NARROW_ROWS)
    chunks, _ = select_plan(nq, n)
    cap = max(1 << (k - 1).bit_length(), SORT_K)
    n_scratch = select_scratch_ints(nq, chunks)
    shapes = ((nq, ldk), (nq, n_tiles), (n_scratch,), (nq, cap), (nq, cap))
    sizes = [nq * ldk, nq * n_tiles, n_scratch, nq * cap, nq * cap]
    at = tuple(sum(sizes[:i]) for i in range(len(sizes)))
    nar = Narrow(torch.empty(sum(sizes), dtype=torch.int32, device=dev), at,
                 shapes, n, chunks)
    vec = int(d % 4 == 0 and _aligned(queries, corpus))
    keys, tile_max, scratch = nar.ptrs()[:3]
    TOPK_NARROW_SCORES(queries.data_ptr(), corpus.data_ptr(), keys, tile_max,
                       scratch, n_scratch, nq, n, d, ldk, per_block, blocks,
                       vec)
    return nar


def _narrow_select(nar: Narrow, k: int):
    (nq, ldk), cap = nar.shapes[0], nar.shapes[3][1]
    out = torch.empty((2, nq, k), dtype=torch.int32, device=nar.buf.device)
    out_s, out_i = out[0].view(torch.float32), out[1]
    TOPK_NARROW_SELECT(*nar.ptrs(), out_s.data_ptr(), out_i.data_ptr(), nq,
                       nar.n, ldk, k, nar.chunks, cap)
    return out_s, out_i


def narrow_scores_cuda(queries: torch.Tensor, corpus: torch.Tensor,
                       k: int) -> Narrow:
    """Launch the narrow scorer: queries f32[Q, D] (1 <= Q <=
    NARROW_QUERIES), corpus f32[N, D], 1 <= k <= N -> the keys and the
    select's space (:class:`Narrow`)."""
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
    NARROW_QUERIES), corpus f32[N, D], 1 <= k <= N -> (scores f32[Q, k],
    ids i32[Q, k])."""
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
        q_tile=DENSE_QUERIES, rows=DENSE_ROWS, blocks=blocks), k)


class Pieces(NamedTuple):
    """The valid candidates of a gathered search, cut into pieces.

    A piece is a run of one query's valid candidate positions whose rows
    are consecutive table rows inside one tile of ``TILE_ROWS`` rows. Row
    ``j`` of ``pieces`` is (query, first row, length, first position, slot
    offset), int32, sorted by tile (stably, so queries keep their order in
    a tile). A piece's top-min(k, length) list goes to row ``query`` of a
    (Q, ``width``) partial buffer, from column ``slot offset``; ``width``
    bounds every query's slots (C, or k per piece of the query with the
    most, whichever is fewer). ``blk_first`` names the first piece of each
    block of the kernel: every ``TILE_PIECES``-th piece of a tile, then -1
    up to a length the host can compute without reading the device."""

    pieces: torch.Tensor
    blk_first: torch.Tensor
    width: int


def gathered_pieces(cand_rows: torch.Tensor, cand_ids: torch.Tensor,
                    n_rows: int, k: int) -> Pieces:
    """Cut the valid slots (``cand_ids >= 0``) of ``cand_rows`` (Q, C)
    into pieces, in plain torch ops on their device. One host read (the
    piece count, the most pieces a query has, whether a valid slot's row
    lies outside ``[0, n_rows)``, which raises) sizes the outputs; the
    passes over the (Q, C) inputs are elementwise, the rest works on the
    pieces."""
    qn, c = cand_ids.shape
    dev = cand_ids.device
    if n_rows + n_rows // TILE_ROWS >= 2 ** 31:
        raise ValueError(f"gathered_topk: {n_rows} table rows exceed the "
                         f"int32 row index with a gap after each tile")
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
        raise ValueError(f"gathered_topk: a valid candidate's row lies "
                         f"outside the table's {n_rows} rows")
    s_at = torch.nonzero_static(start.flatten(), size=n).flatten()
    length = torch.nonzero_static(end.flatten(), size=n).flatten() - s_at + 1
    q_of = s_at // c
    # slot offsets: the lists of the query's earlier pieces come first
    kept = length.clamp(max=k)
    before = torch.cumsum(kept, 0) - kept
    off = before - before[torch.searchsorted(q_of, q_of)]
    first_row = rows.flatten()[s_at].long()
    order = torch.sort(first_row // TILE_ROWS, stable=True).indices
    pieces = torch.stack([q_of, first_row, length, s_at % c, off],
                         1)[order].to(torch.int32)
    # blocks: every TILE_PIECES-th piece of a tile opens one
    t_sorted = (first_row // TILE_ROWS)[order].contiguous()
    rank = (torch.arange(n, device=dev)
            - torch.searchsorted(t_sorted, t_sorted))
    n_blocks = -(-n // TILE_PIECES) + min(n, -(-n_rows // TILE_ROWS))
    blk_first = torch.nonzero_static(rank % TILE_PIECES == 0, size=n_blocks,
                                     fill_value=-1)
    return Pieces(pieces, blk_first.flatten().to(torch.int32),
                  max(min(c, k * most), 1))


def gathered_topk_cuda(queries: torch.Tensor, table: torch.Tensor,
                       cand_rows: torch.Tensor, cand_ids: torch.Tensor,
                       k: int):
    """Launch the gathered kernel and the merge kernel: queries f32[Q, D],
    table f32[R, D], cand_rows/cand_ids i32[Q, C], 1 <= k <= C ->
    (scores f32[Q, k], ids i32[Q, k]). Each probed row tile is read once
    for every 32 pieces that probe it (``gathered_pieces``); the kernels
    rank (score, position); one gather maps the winning positions to ids,
    -1 where the score is -inf."""
    dev = queries.device
    name = GATHERED_TILES.name
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
    pieces, blk_first, width = gathered_pieces(cand_rows, cand_ids, r, k)
    part_s = torch.full((nq, width), -torch.inf, dtype=torch.float32,
                        device=dev)
    part_p = torch.full((nq, width), -1, dtype=torch.int32, device=dev)
    out_s = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_p = torch.empty((nq, k), dtype=torch.int32, device=dev)
    vec = int(d % 4 == 0 and _aligned(queries, table))
    with torch.cuda.device(dev):
        GATHERED_TILES(queries.data_ptr(), table.data_ptr(),
                       pieces.data_ptr(), blk_first.data_ptr(),
                       part_s.data_ptr(), part_p.data_ptr(), pieces.shape[0],
                       blk_first.shape[0], r, d, k, width, vec)
        TOPK_MERGE(part_s.data_ptr(), part_p.data_ptr(), out_s.data_ptr(),
                   out_p.data_ptr(), nq, width, k)
    ids = torch.gather(cand_ids, 1, out_p.clamp(min=0).long())
    return out_s, torch.where(torch.isfinite(out_s), ids, -1)


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
    (retrieval/backends.py ``Int8Backend``)."""
    blocks = tuning.resolve("topk", n=c_codes.shape[0], dtype="int8",
                            split_blocks=split_blocks)
    k_eff = min(k, c_codes.shape[0])
    if q_codes.device.type == "cpu":
        return pad_topk(*ref.topk_scores_int8_ref(q_codes, c_codes, k=k_eff),
                        k)
    if k_eff == 0 or q_codes.shape[0] == 0:
        return empty_topk(q_codes.shape[0], k, q_codes.device)
    s, i = topk_scores_int8_cuda(q_codes.contiguous(), c_codes.contiguous(),
                                 k_eff, blocks["split_blocks"])
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
