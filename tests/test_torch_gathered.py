"""The gathered top-k wrapper's piece construction, on the CPU.

On the card, ``gathered_topk`` cuts each query's valid candidate positions
into pieces (runs of consecutive table rows inside one row tile), sorts
them by tile and hands them to a kernel that scores each tile once for
every block of pieces that probe it (``ops.gathered_pieces``). The kernel
runs only on the card; the pieces are plain torch ops and run here.

These tests hold the pieces to their contract (every valid (query,
position) covered exactly once, with its row; pieces inside one tile,
sorted by tile; blocks of at most ``TILE_PIECES`` pieces of one tile; slots
of a query disjoint and inside its row of partials) and hold a plain
emulation of the kernel and its merge over those pieces equal to
``gathered_topk_ref`` and to the JAX package's jnp ``gathered_topk``.
Vectors are small integers, so every score is exact and the emulation
must give the same scores and ids, ties to the earlier position included.

The kernel takes its tile products on the tensor cores as the narrow dense
scorer does (the tile's 128 rows on the MMA's M side, one m16 tile a warp;
the block's pieces' query rows on N, rounded up to the n8 tiles that hold
them; 3xTF32, or f64 where D <= 8). Its fragment geometry, its arithmetic
(``test_torch_dense_narrow.emulate_narrow``) within D * 2**-24 * sum |q c|
of the f64 product, and the whole emulated path with those sums against
the plain version and the JAX package's jnp ``gathered_topk`` (at Q 1 and
at an ivfflat probe) are held here too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.retrieval.backends import get_backend as jget_backend
from repro_torch import interop
from repro_torch.core import prng
from repro_torch.kernels.topk_scoring.ops import (PIECE_INFO, PIECE_SLOTS,
                                                  TILE_PIECES, TILE_ROWS,
                                                  gathered_pieces)
from repro_torch.kernels.topk_scoring.ref import gathered_topk_ref, pad_topk
from repro_torch.retrieval.ivfflat import build_ivfflat, probe_candidates
from test_torch_dense_narrow import _ldmatrix, emulate_narrow


def _candidates(kind: str, seed: int):
    """(queries f32[Q, D], table f32[R, D], cand_rows i32[Q, C],
    cand_ids i32[Q, C]) with small-integer vectors. Query 0 has no valid
    slot in every kind."""
    rng = np.random.default_rng(seed)
    d = 5                                   # D not a multiple of 4
    if kind == "ivfflat":                   # a real index and probe
        vecs = torch.from_numpy(
            rng.integers(-3, 4, (600, d)).astype(np.float32))
        index = build_ivfflat(prng.prng_key(seed), vecs, n_lists=6)
        qs = torch.from_numpy(rng.integers(-3, 4, (48, d)).astype(np.float32))
        rows, ids = probe_candidates(index, qs, nprobe=3)
        ids = ids.clone()
        ids[0] = -1
        return qs, index.vecs.reshape(-1, d), rows, ids
    q, c, r = 24, 160, 700
    if kind == "random":                    # no runs to speak of
        rows = rng.integers(0, r, (q, c))
    elif kind == "no_runs":                 # every piece has length 1
        rows = 2 * rng.integers(0, r // 2, (q, c))
    elif kind == "repeats":                 # a row repeated within a query
        rows = np.repeat(rng.integers(0, r, (q, c // 3 + 1)), 3, axis=1)[:, :c]
    elif kind == "straddle":                # runs across tile boundaries
        rows = (rng.integers(0, r - c, (q, 1)) + np.arange(c)[None, :])
    elif kind == "crowded":                 # one tile, more than a block
        rows = np.broadcast_to(np.arange(c) % TILE_ROWS, (q, c)).copy()
    else:
        raise ValueError(kind)
    ids = rng.integers(0, 10 ** 6, (q, c))
    ids[rng.random((q, c)) < 0.2] = -1
    ids[0] = -1
    ids[1, 2:] = -1                         # k above this query's valid count
    qs = rng.integers(-3, 4, (q, d)).astype(np.float32)
    table = rng.integers(-3, 4, (r, d)).astype(np.float32)
    return (torch.from_numpy(qs), torch.from_numpy(table),
            torch.from_numpy(rows.astype(np.int32)),
            torch.from_numpy(ids.astype(np.int32)))


KINDS = ["random", "ivfflat", "no_runs", "repeats", "straddle", "crowded"]


def _blocks(pieces, blk_first):
    """The pieces each block of the kernel takes, as the kernel finds
    them: from its first piece on, at most TILE_PIECES, while they stay in
    the first one's tile."""
    pc = pieces.tolist()
    out = []
    for first in blk_first.tolist():
        if first < 0:
            continue
        t = pc[first][1] // TILE_ROWS
        out.append([j for j in range(first, min(first + TILE_PIECES,
                                                len(pc)))
                    if pc[j][1] // TILE_ROWS == t])
    return out


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [1, 3, 40])
def test_pieces_cover_every_valid_slot_once(kind, k):
    qs, table, rows, ids = _candidates(kind, 3)
    r = table.shape[0]
    pieces, blk_first, width, row_len = gathered_pieces(rows, ids, r, k)
    pc = pieces.tolist()
    rows_np, ids_np = rows.numpy(), ids.numpy()
    seen = np.zeros(ids.shape, dtype=np.int32)
    slots = {}
    for q, row0, length, p0, off in pc:
        assert length >= 1
        assert row0 // TILE_ROWS == (row0 + length - 1) // TILE_ROWS
        assert np.array_equal(rows_np[q, p0:p0 + length],
                              np.arange(row0, row0 + length))
        assert (ids_np[q, p0:p0 + length] >= 0).all()
        seen[q, p0:p0 + length] += 1
        kk = min(k, length)
        assert 0 <= off and off + kk <= width
        slots.setdefault(q, []).append((off, off + kk))
    assert np.array_equal(seen, ids_np >= 0)
    for q, spans in slots.items():          # a query's slots are disjoint
        spans.sort()                        # and fill its row's first
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
        assert spans[0][0] == 0 and spans[-1][1] == row_len[q]
    assert all(row_len[q] == 0 for q in range(ids.shape[0])
               if q not in slots)
    tiles = [p[1] // TILE_ROWS for p in pc]
    assert tiles == sorted(tiles)
    for a, b in zip(pc, pc[1:]):            # stable: query order in a tile
        if a[1] // TILE_ROWS == b[1] // TILE_ROWS:
            assert (a[0], a[3]) < (b[0], b[3])
    blocks = _blocks(pieces, blk_first)
    assert sorted(j for blk in blocks for j in blk) == list(range(len(pc)))
    if kind == "no_runs":
        assert all(p[2] == 1 for p in pc)
    if kind == "crowded":                   # one tile, several blocks
        assert len(set(tiles)) == 1 and len(blocks) > 1


def test_pieces_raise_on_a_stray_row():
    rows = torch.tensor([[0, 1, 9]], dtype=torch.int32)
    with pytest.raises(ValueError, match="outside the table's 9 rows"):
        gathered_pieces(rows, torch.tensor([[4, -1, 2]], dtype=torch.int32),
                        9, 2)
    # an invalid slot's row is never read
    pieces = gathered_pieces(
        rows, torch.tensor([[4, 5, -1]], dtype=torch.int32), 9, 2).pieces
    assert pieces.tolist() == [[0, 0, 2, 0, 0]]


def _torch_scores(qrows, trows):
    return qrows @ trows.T


def _tensor_core_scores(qrows, trows):
    """The kernel's tile sums (the narrow scorer's arithmetic): the
    pieces' query rows against the tile's rows."""
    return torch.from_numpy(emulate_narrow(qrows.numpy(), trows.numpy()))


def _emulate(queries, table, cand_rows, cand_ids, k, score=_torch_scores):
    """The kernel and its merge in plain Python over the pieces: each block
    scores its tile's rows against its pieces' queries (``score``), each
    piece offers its rows, as (score, position), to a list of min(k,
    length) entries in its slots, and each query's row of lists is merged
    by (score desc, position asc)."""
    qn = queries.shape[0]
    pieces, blk_first, width, _ = gathered_pieces(cand_rows, cand_ids,
                                                  table.shape[0], k)
    part_s = torch.full((qn, width), -torch.inf)
    part_p = torch.full((qn, width), -1, dtype=torch.int32)
    pc = pieces.tolist()
    for blk in _blocks(pieces, blk_first):
        t0 = pc[blk[0]][1] // TILE_ROWS * TILE_ROWS
        scores = score(queries[[pc[j][0] for j in blk]],
                       table[t0:t0 + TILE_ROWS])
        for b, j in enumerate(blk):
            q, row0, length, p0, off = pc[j]
            s = scores[b, row0 - t0:row0 - t0 + length].tolist()
            top = sorted(range(length), key=lambda x: (-s[x], x))
            for slot, x in enumerate(top[:min(k, length)]):
                part_s[q, off + slot] = s[x]
                part_p[q, off + slot] = p0 + x
    out_s = torch.full((qn, k), -torch.inf)
    out_i = torch.full((qn, k), -1, dtype=torch.int32)
    for q in range(qn):
        cand = sorted((-s, p) for s, p in zip(part_s[q].tolist(),
                                              part_p[q].tolist()) if p >= 0)
        for slot, (neg_s, p) in enumerate(cand[:k]):
            out_s[q, slot] = -neg_s
            out_i[q, slot] = cand_ids[q, p]
    return out_s, out_i


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [3, 40])
def test_grouped_scoring_equals_the_plain_version(kind, k):
    qs, table, rows, ids = _candidates(kind, 5)
    s, i = _emulate(qs, table, rows, ids, k)
    want_s, want_i = pad_topk(*gathered_topk_ref(
        qs, table, rows, ids, k=min(k, ids.shape[1])), k)
    assert torch.equal(s, want_s) and torch.equal(i, want_i)


@pytest.mark.parametrize("kind", ["ivfflat", "repeats", "straddle"])
def test_grouped_scoring_equals_the_reference_jnp(kind):
    qs, table, rows, ids = _candidates(kind, 7)
    s, i = _emulate(qs, table, rows, ids, 10)
    cand_vecs = table[rows.clamp(min=0).long()]
    js, ji = jget_backend("jnp").gathered_topk(
        jnp.asarray(qs.numpy()), jnp.asarray(cand_vecs.numpy()),
        jnp.asarray(ids.numpy()), k=10)
    assert np.array_equal(interop.to_numpy(s), np.asarray(js))
    assert np.array_equal(interop.to_numpy(i), np.asarray(ji))


def test_tile_constants_match_the_kernel():
    """The pieces are cut for the kernel's tile and block: TILE_ROWS and
    TILE_PIECES must be its kGTR and kGBQ, or pieces would cross its
    tiles or be dropped from its blocks."""
    import re
    from pathlib import Path
    src = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
           / "csrc" / "topk_scores.cu").read_text()
    consts = dict(re.findall(r"constexpr int (kGTR|kGBQ) = (\d+);", src))
    assert (int(consts["kGTR"]), int(consts["kGBQ"])) == (TILE_ROWS,
                                                          TILE_PIECES)


# ---- the tensor-core tile ------------------------------------------------

ROW = 144                 # kDRow: a staged row's stride in shared memory
CHUNK = 128               # kDChunk: bytes of a row staged per step


@pytest.mark.parametrize("n_pieces", [1, 5, 8, 9, 17, 32])
def test_tensor_core_tile_geometry(n_pieces):
    """Stage the tile's 128 rows, then the pieces' query rows (8 nt of
    them, nt the n8 tiles that hold n_pieces, pieces past n_pieces zero),
    144 bytes apart; the rows past 8 nt are never staged (NaN here). Warp
    w's A fragment (rows 16w..16w+15, its ldmatrix addresses) and B
    fragments (pieces' n8 tiles j < nt) in the m16n8k8 layout give lane
    (g, t) row 16w + g + 8h against piece 8j + 2t + b in acc[0][j][2h +
    b], as the kernel's score stores read them; no product reads a row
    past 8 nt."""
    nt = -(-n_pieces // 8)
    assert nt <= TILE_PIECES // 8
    rng = np.random.default_rng(n_pieces)
    rows = rng.integers(-8, 9, (TILE_ROWS + TILE_PIECES, CHUNK // 4)).astype(
        np.float32)
    rows[TILE_ROWS + n_pieces:] = 0.0                 # absent pieces: zeros
    rows[TILE_ROWS + 8 * nt:] = np.nan                # never staged
    stage = np.zeros((TILE_ROWS + TILE_PIECES) * ROW, np.uint8)
    for r in range(TILE_ROWS + TILE_PIECES):
        stage[r * ROW:r * ROW + CHUNK] = rows[r].view(np.uint8)
    lanes = np.arange(32)
    lr, lm, g, t = lanes & 7, lanes >> 3, lanes >> 2, lanes & 3
    for warp in (0, 3, 7):
        a_off = (16 * warp + lr + 8 * (lm & 1)) * ROW + 16 * (lm >> 1)
        b_off = (TILE_ROWS + lr + 8 * (lm >> 1)) * ROW + 16 * (lm & 1)
        for kk in range(CHUNK // 32):
            a = _ldmatrix(stage, a_off + kk * 32, 4)
            amat = np.zeros((16, 8))
            for lane in range(32):
                for r, (row, col) in enumerate(
                        [(g[lane], t[lane]), (g[lane] + 8, t[lane]),
                         (g[lane], t[lane] + 4),
                         (g[lane] + 8, t[lane] + 4)]):
                    amat[row, col] = a[lane, r:r + 1].view(np.float32)[0]
            acc = np.zeros((nt, 32, 4))
            for j in range(nt):            # narrow_b: tiles 2p, 2p + 1
                b = _ldmatrix(stage, b_off + j // 2 * 16 * ROW + kk * 32, 4)
                bmat = np.zeros((8, 8))
                for lane in range(32):
                    for r in range(2):
                        bmat[t[lane] + 4 * r, g[lane]] = b[
                            lane, 2 * (j % 2) + r:2 * (j % 2) + r + 1].view(
                                np.float32)[0]
                cm = amat @ bmat
                for lane in range(32):
                    acc[j, lane] = [cm[g[lane], 2 * t[lane]],
                                    cm[g[lane], 2 * t[lane] + 1],
                                    cm[g[lane] + 8, 2 * t[lane]],
                                    cm[g[lane] + 8, 2 * t[lane] + 1]]
            depth = slice(8 * kk, 8 * kk + 8)
            want = (rows[:TILE_ROWS, depth].astype(np.float64)
                    @ rows[TILE_ROWS:TILE_ROWS + 8 * nt, depth]
                    .astype(np.float64).T)
            assert np.isfinite(acc).all()
            for j in range(nt):
                for e in range(4):
                    np.testing.assert_array_equal(
                        acc[j, :, e], want[16 * warp + g + 8 * (e >> 1),
                                           8 * j + 2 * t + (e & 1)])


@pytest.mark.parametrize("d", [3, 8, 37, 768, 2048])
@pytest.mark.parametrize("wide", [False, True])
def test_tensor_core_tile_within_the_bound(d, wide):
    """The tile's emulated sums (3xTF32 with the 2**12 scale, each 128-byte
    chunk's MMAs truncating, a rounded add a chunk; f64 where D <= 8) lie
    within D * 2**-24 * sum |q c| of the f64 product, also with rows of
    magnitudes 2**-20..2**20."""
    rng = np.random.default_rng(d + wide)
    qs = rng.standard_normal((TILE_PIECES, d)).astype(np.float32)
    tile = rng.standard_normal((TILE_ROWS, d)).astype(np.float32)
    if wide:
        for x in (qs, tile):
            x *= 2.0 ** rng.integers(-20, 21, (x.shape[0], 1))
    got = emulate_narrow(qs, tile)
    exact = qs.astype(np.float64) @ tile.astype(np.float64).T
    tol = d * 2.0 ** -24 * (np.abs(qs.astype(np.float64))
                            @ np.abs(tile.astype(np.float64)).T)
    assert got.shape == (TILE_PIECES, TILE_ROWS)
    assert (np.abs(got - exact) <= tol).all()


def _float_probe(nq, d, seed):
    """An ivfflat index of normal vectors and its probe for ``nq``
    normal queries: lists are runs of rows, cut at the kernel's tiles."""
    rng = np.random.default_rng(seed)
    vecs = torch.from_numpy(rng.standard_normal((900, d)).astype(np.float32))
    index = build_ivfflat(prng.prng_key(seed), vecs, n_lists=6)
    qs = torch.from_numpy(rng.standard_normal((nq, d)).astype(np.float32))
    rows, ids = probe_candidates(index, qs, nprobe=3)
    return qs, index.vecs.reshape(-1, d), rows, ids, vecs


@pytest.mark.parametrize("nq,d", [(1, 37), (1, 5), (40, 37), (40, 64)])
def test_tensor_core_path_against_the_references(nq, d):
    """Float vectors at Q 1 and at an ivfflat probe: the emulated kernel
    with the tensor-core sums gives scores within D * 2**-24 * sum |q c|
    of the f64 product, and the plain version's and the JAX package's
    jnp ``gathered_topk`` ids away from near-ties (an id whose exact score
    lies within twice that bound of the other's)."""
    k = 10
    qs, table, rows, ids, vecs = _float_probe(nq, d, seed=nq + d)
    s, i = _emulate(qs, table, rows, ids, k, _tensor_core_scores)
    q64, v64 = qs.double(), vecs.double()
    fin = i >= 0
    exact = torch.einsum("qd,qkd->qk", q64, v64[i.clamp(min=0).long()])
    tol = d * 2.0 ** -24 * torch.einsum(
        "qd,qkd->qk", q64.abs(), v64[i.clamp(min=0).long()].abs())
    assert bool(((s.double() - exact).abs()[fin] <= tol[fin]).all())
    ps, pi = gathered_topk_ref(qs, table, rows, ids, k=k)
    cand_vecs = table[rows.clamp(min=0).long()]
    js, ji = jget_backend("jnp").gathered_topk(
        jnp.asarray(qs.numpy()), jnp.asarray(cand_vecs.numpy()),
        jnp.asarray(ids.numpy()), k=k)
    for name, want in (("plain", pi),
                       ("jax jnp", torch.from_numpy(np.array(ji)))):
        assert torch.equal(want < 0, i < 0), name
        diff = (i != want) & fin
        if bool(diff.any()):
            ex_w = torch.einsum("qd,qkd->qk", q64,
                                v64[want.clamp(min=0).long()])
            tol_w = d * 2.0 ** -24 * torch.einsum(
                "qd,qkd->qk", q64.abs(), v64[want.clamp(min=0).long()].abs())
            gap = (exact - ex_w).abs()
            near = 2 * torch.maximum(tol, tol_w)
            assert bool((gap[diff] <= near[diff]).all()), name


@pytest.mark.parametrize("kind", ["ivfflat", "straddle", "crowded"])
def test_tensor_core_scoring_equals_the_plain_version(kind):
    """Small-integer vectors: the tensor-core sums are exact, so the lists
    equal the plain version's, ties to the earliest position included."""
    qs, table, rows, ids = _candidates(kind, 11)
    s, i = _emulate(qs, table, rows, ids, 10, _tensor_core_scores)
    want_s, want_i = pad_topk(*gathered_topk_ref(
        qs, table, rows, ids, k=min(10, ids.shape[1])), 10)
    assert torch.equal(s, want_s) and torch.equal(i, want_i)


# ---- the pieces kernels ----------------------------------------------------

def emulate_pieces_kernels(rows, ids, n_rows, k):
    """gathered_piece_count, _emit and _finish step by step over numpy
    (Q, C) slots: blocks of PIECE_SLOTS slots a (query, chunk), runs of
    PIECE_SLOTS / 256 slots a thread, the count's scan into each chunk's
    first piece number, the emit's writes (a start at its number, its row
    read back from its key; an end at the number of the last start at or
    before it), the finish's
    lengths, slot offsets and row lengths -> (pieces in (query, position)
    order, tiles, row_len, most)."""
    qn, c = ids.shape
    vec = PIECE_SLOTS // 256
    chunks = max(1, -(-c // PIECE_SLOTS))
    valid = ids >= 0
    key = np.where(valid, rows.astype(np.int64) + rows // TILE_ROWS, -2)
    # the emit pass reads a start's row back from its key (129 a + b for
    # row 128 a + b)
    assert np.array_equal((key - key // (TILE_ROWS + 1))[valid], rows[valid])
    prev = np.concatenate([np.full((qn, 1), -2), key[:, :-1]], 1)
    nxt = np.concatenate([key[:, 1:], np.full((qn, 1), -2)], 1)
    starts = valid & (key != prev + 1)
    ends = valid & (nxt != key + 1)
    counts = np.zeros((qn, chunks), np.int64)
    for ch in range(chunks):
        counts[:, ch] = starts[:, ch * PIECE_SLOTS:(ch + 1) * PIECE_SLOTS] \
            .sum(1)
    base = (np.cumsum(counts.ravel()) - counts.ravel()).reshape(qn, chunks)
    n = int(counts.sum())
    pieces = np.full((n, 5), -7, np.int64)
    for q in range(qn):
        for ch in range(chunks):
            before = 0                      # the block's exclusive scan
            for th in range(256):
                lo = ch * PIECE_SLOTS + th * vec
                if lo >= c:
                    break
                idx = base[q, ch] + before
                for at in range(lo, min(lo + vec, c)):
                    if starts[q, at]:
                        pieces[idx, 1], pieces[idx, 3] = rows[q, at], at
                        idx += 1
                    if ends[q, at]:
                        pieces[idx - 1, 2] = at
                before += int(starts[q, lo:lo + vec].sum())
    row_len = np.zeros(qn, np.int64)
    for q in range(qn):
        b0 = base[q, 0]
        b1 = base[q + 1, 0] if q + 1 < qn else n
        length = pieces[b0:b1, 2] - pieces[b0:b1, 3] + 1
        kept = np.minimum(k, length)
        pieces[b0:b1, 0] = q
        pieces[b0:b1, 2] = length
        pieces[b0:b1, 4] = np.cumsum(kept) - kept
        row_len[q] = kept.sum()
    most = int(counts.sum(1).max()) if qn else 0
    return pieces, pieces[:, 1] // TILE_ROWS, row_len, most


@pytest.mark.parametrize("kind", KINDS + ["wide"])
@pytest.mark.parametrize("k", [3, 40])
def test_pieces_kernels_emulation_equals_the_plain_version(kind, k):
    """The pieces kernels' steps, emulated, then the wrapper's stable sort
    by tile: the same pieces, blocks' first pieces, width and row lengths
    as the plain version (on the card chip_smoke.py holds the kernels to
    it). "wide": rows of 20,000 slots, so pieces cross the kernels'
    8192-slot blocks and their threads' 32-slot runs."""
    if kind == "wide":
        rng = np.random.default_rng(k)
        c, r = 20000, 40000
        rows = (rng.integers(0, r - c, (3, 1)) + np.arange(c)[None, :])
        rows[:, 5000:5100] = rng.integers(0, r, (3, 100))
        ids = rng.integers(0, 10 ** 6, (3, c))
        ids[rng.random((3, c)) < 0.05] = -1
        ids[:, 8190:8194] = np.array([5, -1, 7, 8])
        rows_t = torch.from_numpy(rows.astype(np.int32))
        ids_t = torch.from_numpy(ids.astype(np.int32))
    else:
        _, table, rows_t, ids_t = _candidates(kind, 13)
        r = table.shape[0]
    plain = gathered_pieces(rows_t, ids_t, r, k)
    pieces, tiles, row_len, most = emulate_pieces_kernels(
        rows_t.numpy(), ids_t.numpy(), r, k)
    order = np.argsort(tiles, kind="stable")
    assert np.array_equal(pieces[order], plain.pieces.numpy())
    assert np.array_equal(row_len, plain.row_len.numpy())
    assert max(min(ids_t.shape[1], k * most), 1) == plain.width


def test_piece_constants_match_the_kernel():
    """The wrapper sizes the pieces kernels' grid and scratch by these:
    PIECE_SLOTS and PIECE_INFO must be kPieceSlots and kPieceInfo, and a
    thread's run (kPieceSlots over 256 threads) fits one flag word."""
    import re
    from pathlib import Path
    src = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
           / "csrc" / "topk_scores.cu").read_text()
    consts = dict(re.findall(r"constexpr int (kPieceSlots|kPieceInfo|"
                             r"kSelThreads) = (\d+);", src))
    assert (int(consts["kPieceSlots"]), int(consts["kPieceInfo"])) == (
        PIECE_SLOTS, PIECE_INFO)
    assert PIECE_SLOTS // int(consts["kSelThreads"]) <= 32
