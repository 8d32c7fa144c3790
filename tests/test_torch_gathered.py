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
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.retrieval.backends import get_backend as jget_backend
from repro_torch import interop
from repro_torch.core import prng
from repro_torch.kernels.topk_scoring.ops import (TILE_PIECES, TILE_ROWS,
                                                  gathered_pieces)
from repro_torch.kernels.topk_scoring.ref import gathered_topk_ref, pad_topk
from repro_torch.retrieval.ivfflat import build_ivfflat, probe_candidates


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
    pieces, blk_first, width = gathered_pieces(rows, ids, r, k)
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
    for spans in slots.values():            # a query's slots are disjoint
        spans.sort()
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
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
    pieces, _, _ = gathered_pieces(
        rows, torch.tensor([[4, 5, -1]], dtype=torch.int32), 9, 2)
    assert pieces.tolist() == [[0, 0, 2, 0, 0]]


def _emulate(queries, table, cand_rows, cand_ids, k):
    """The kernel and its merge in plain Python over the pieces: each block
    scores its tile's rows against its pieces' queries, each piece offers
    its rows, as (score, position), to a list of min(k, length) entries in
    its slots, and each query's row of lists is merged by (score desc,
    position asc)."""
    qn = queries.shape[0]
    pieces, blk_first, width = gathered_pieces(cand_rows, cand_ids,
                                               table.shape[0], k)
    part_s = torch.full((qn, width), -torch.inf)
    part_p = torch.full((qn, width), -1, dtype=torch.int32)
    pc = pieces.tolist()
    for blk in _blocks(pieces, blk_first):
        t0 = pc[blk[0]][1] // TILE_ROWS * TILE_ROWS
        scores = queries[[pc[j][0] for j in blk]] @ \
            table[t0:t0 + TILE_ROWS].T
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
