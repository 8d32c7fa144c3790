"""The narrow dense top-k path (few queries), emulated on the CPU.

On the card, ``topk_scores`` with Q at or below ``NARROW_QUERIES`` runs two
kernels of csrc/topk_scores.cu: ``narrow_scores``, which puts 256-row
corpus tiles on the MMA's M side (two m16 tiles a warp) and the real
queries, rounded up to 8, on its N side, and writes each score's order
key and each tile's largest key; and ``narrow_select``, an exact radix
select of each query's k best over those keys. Neither runs here, so these
tests hold numpy emulations of each step to the contract, and import no
kernel:

- the order key (``f32_key``): -0.0 takes +0.0's key, -inf the least of
  any number's, and the key orders scores as f32 compares them;
- the select: a floor digit from the tile maxima, a count of the keys at
  or above it by their top 11 bits that also gathers them, then either the
  k best of the gathered keys (where they number no more than SORT_K) or
  two more digit passes, a count of the ties at the k-th best key in each
  item and a collect that keeps the lowest ids among them; held to the
  port's plain version and the JAX package, with ties at the k-th key,
  signed zeros, -inf rows, k above an item's or a tile's rows, k = N and
  Q = 1;
- the scorer's fragment geometry (corpus rows as A, queries as B) and its
  arithmetic (3xTF32 with the scale on a low piece, f64 where D <= 8)
  within ``chip_smoke.check_topk``'s bound;
- the two plans (the scorer's tiles a block, the select's keys an item)
  and the constants ``ops.py`` shares with the kernel source.
Inputs are made with numpy from a seed.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.topk_scoring.ops import topk_scores as jtopk_scores
from repro.kernels.topk_scoring.ref import topk_scores_ref as jtopk_ref
from repro_torch.kernels.topk_scoring import ops
from repro_torch.kernels.topk_scoring.ref import topk_scores_ref

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "csrc" / "topk_scores.cu")
ROW = 144                 # kDRow: a staged row's stride in shared memory
CHUNK = 128               # kDChunk: bytes of a row staged per step


def _constants():
    return {name: int(v) for name, v in
            re.findall(r"constexpr int (k\w+) = (\d+);", SOURCE.read_text())}


def test_narrow_constants_match_the_kernel():
    """The wrapper sizes the scorer's grid, the keys' rows and the
    select's scratch by these; each must equal the source's."""
    c = _constants()
    assert c["kNQMax"] == ops.NARROW_QUERIES
    assert c["kNRows"] == ops.NARROW_ROWS == 8 * 32   # 8 warps x 2 m16
    assert c["kKeyAlign"] == ops.KEY_ALIGN
    assert (c["kHeadInts"], c["kStateInts"], c["kRadixBins"],
            c["kSortK"]) == (ops.HEAD_INTS, ops.STATE_INTS, ops.RADIX_BINS,
                             ops.SORT_K)
    assert (c["kDChunk"], c["kDChunk"] + 16) == (CHUNK, ROW)
    # an item is whole tiles, read kSelVec keys a thread a step
    assert ops.SELECT_MIN_ITEM % ops.NARROW_ROWS == 0
    assert ops.SELECT_MIN_ITEM % (c["kSelVec"] * c["kSelThreads"]) == 0
    assert ops.NARROW_ROWS % ops.KEY_ALIGN == 0
    assert c["kRadixBins"] == c["kSelThreads"] * 8   # 8 bins a thread
    # a block of the largest query tile fits the card's shared memory
    ring = c["kNStages"] * (c["kNRows"] + c["kNQMax"]) * ROW
    assert ring + 8 * c["kNQMax"] * 4 <= 227 * 1024


# ---- the order key and the select --------------------------------------------

def f32_key(s):
    """The kernels' f32_key on f32 scores -> uint32."""
    b = np.asarray(s, np.float32).view(np.uint32).copy()
    b[b == 0x80000000] = 0
    return np.where(b & 0x80000000, ~b, b | 0x80000000).astype(np.uint32)


def key_f32(k):
    k = np.asarray(k, np.uint32)
    return np.where(k & 0x80000000, k & 0x7FFFFFFF, ~k).astype(
        np.uint32).view(np.float32)


def find_bin(hist, rem):
    """(bin, count above it, its count) where the count from the top first
    reaches rem, or None where all bins hold fewer."""
    above = 0
    for b in range(hist.size - 1, -1, -1):
        if rem <= above + hist[b]:
            return b, above, int(hist[b])
        above += int(hist[b])
    return None


def emulate_select(keys, k, seed=0):
    """narrow_select on one query's keys (uint32, N) -> (scores, ids) of
    its k best, step by step; gathers and collects in a shuffled order
    where the kernel's atomics give any order."""
    rng = np.random.default_rng(seed)
    n = keys.size
    rows = ops.NARROW_ROWS
    chunks, per = ops.select_plan(1, n)
    ids = np.arange(n)
    # floor: the tile maxima's top digits
    tiles = -(-n // rows)
    tmax = np.zeros(tiles, np.uint32)
    np.maximum.at(tmax, ids // rows, keys)
    found = find_bin(np.bincount(tmax >> 21, minlength=2048), k)
    floor = found[0] if found else 0
    # pass 0: count and gather the keys at or above the floor
    inn = keys >> 21 >= floor
    b0, known, cnt = find_bin(np.bincount(keys[inn] >> 21, minlength=2048), k)
    gathered = rng.permutation(ids[inn])
    if inn.sum() <= ops.SORT_K:                              # compact
        chosen = gathered
    else:
        pre, thr_bits = b0, 21
        for shift, bits in ((10, 11), (0, 10)):
            sel = keys >> thr_bits == pre
            digit = keys[sel] >> shift & ((1 << bits) - 1)
            b, above, cnt = find_bin(np.bincount(digit, minlength=2048),
                                     k - known)
            pre, known, thr_bits = pre << bits | b, known + above, shift
        thr, room = np.uint32(pre), k - known
        above_ids = rng.permutation(ids[keys > thr])
        assert above_ids.size == known
        ties = ids[keys == thr]
        assert ties.size == cnt
        if cnt > room:          # each item's ties, ranked in chunk order
            rank = np.zeros(n, np.int64)
            before = 0
            for c in range(chunks):
                lo, hi = c * per, min(c * per + per, n)
                here = ties[(ties >= lo) & (ties < hi)]
                rank[here] = before + np.arange(here.size)
                before += here.size
            ties = ties[rank[ties] < room]
        chosen = np.concatenate([above_ids, rng.permutation(ties)])
        assert chosen.size == k
    # the sort: key desc, id asc
    order = np.lexsort((chosen, -keys[chosen].astype(np.int64)))[:k]
    top = chosen[order]
    s = key_f32(keys[top])
    return s, np.where(np.isneginf(s), -1, top).astype(np.int32)


def _select_all(scores, k):
    out = [emulate_select(f32_key(row), k, seed=i)
           for i, row in enumerate(scores)]
    return np.stack([o[0] for o in out]), np.stack([o[1] for o in out])


def test_order_key_orders_scores():
    """Keys compare as the scores do, signed zeros equal, -inf below
    every number, and the key maps back to the score (+0.0 for -0.0)."""
    rng = np.random.default_rng(0)
    s = np.concatenate([
        rng.standard_normal(4000) * 2.0 ** rng.integers(-130, 120, 4000),
        [0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45,
         np.finfo(np.float32).max, -np.finfo(np.float32).max],
    ]).astype(np.float32)
    k = f32_key(s)
    a, b = np.meshgrid(np.arange(s.size), np.arange(s.size)[:500])
    assert np.array_equal(k[a] > k[b], s[a] > s[b])
    assert np.array_equal(k[a] == k[b], s[a] == s[b])
    assert f32_key(np.float32(-np.inf)) == 0x007FFFFF
    back = key_f32(k)
    assert np.array_equal(back, np.where(s == 0, np.float32(0), s))
    assert not np.signbit(back[s == 0]).any()
    torch_keys = ops.score_keys(torch.from_numpy(s)).numpy().view(np.uint32)
    assert np.array_equal(torch_keys, k)
    assert np.array_equal(
        ops.key_scores(torch.from_numpy(k.view(np.int32))).numpy(), back)


def _int_inputs(q, n, d, seed, lo=-2, hi=3):
    """Small integers: every score is exact in f32, on every path."""
    rng = np.random.default_rng(seed)
    return (rng.integers(lo, hi, (q, d)).astype(np.float32),
            rng.integers(lo, hi, (n, d)).astype(np.float32))


def _port_plain(qs, cs, k):
    s, i = topk_scores_ref(torch.from_numpy(qs), torch.from_numpy(cs), k=k)
    return s.numpy(), i.numpy()


@pytest.mark.parametrize("q,n,d,k", [
    (1, 1000, 4, 100),         # Q = 1; ties at the k-th key
    (3, 5000, 3, 1000),        # k above a tile's 256 rows
    (2, 9000, 2, 8200),        # k above an item's 8192 keys, not compact
    (4, 300, 5, 300),          # k = N
    (1, 20000, 1, 100),        # scores in {-2..2}: the lowest ids win
    (5, 777, 6, 1),
])
def test_select_emulation_matches_the_plain_version(q, n, d, k):
    """Exact scores with many ties at the k-th key: the emulated select's
    lists equal the port's plain version's (scores and ids, ties to the
    lowest id), and the JAX reference's ``lax.top_k`` ids."""
    qs, cs = _int_inputs(q, n, d, seed=q + n + d + k)
    scores = (qs.astype(np.float64) @ cs.astype(np.float64).T).astype(
        np.float32)
    s, i = _select_all(scores, k)
    ps, pi = _port_plain(qs, cs, k)
    assert np.array_equal(s, ps) and np.array_equal(i, pi)
    js, ji = jtopk_ref(jnp.asarray(qs), jnp.asarray(cs), k=k)
    assert np.array_equal(s, np.asarray(js))
    assert np.array_equal(i, np.asarray(ji))


def test_select_takes_the_radix_path_and_keeps_the_lowest_ids():
    """More than SORT_K keys in the k-th key's top bin (scores in 0..2 on
    20000 rows): the select counts two more digits and the ties at the
    k-th key, and keeps the lowest ids of them, across items."""
    qs = np.ones((1, 1), np.float32)
    rng = np.random.default_rng(5)
    cs = rng.integers(0, 3, (20000, 1)).astype(np.float32)
    scores = (qs @ cs.T).astype(np.float32)
    keys = f32_key(scores[0])
    assert (keys >> 21 == keys.max() >> 21).sum() > ops.SORT_K
    assert ops.select_plan(1, 20000)[0] > 1
    for k in (100, 7000, 20000):
        s, i = emulate_select(keys, k)
        ps, pi = _port_plain(qs, cs, k)
        assert np.array_equal(s, ps[0]) and np.array_equal(i, pi[0])


def test_select_signed_zeros_and_neg_inf_rows():
    """Scores of -0.0 and +0.0 are one key (ties to the lowest id, as the
    port's plain version's stable sort has them); rows scoring -inf come
    back as misses (-inf, id -1), as the plain version and the JAX
    package's wrapper give them."""
    n = 600
    cs = np.zeros((n, 2), np.float32)
    cs[::3, 0] = -0.0                       # -0.0 + 0.0 = +0.0
    cs[1::3, 0] = -1.0
    cs[1::3, 1] = 1.0                       # -1 + 1 = +0.0
    cs[2::6, 0] = -np.inf                   # -inf
    cs[5::6, 0] = 1.0
    qs = np.ones((1, 2), np.float32)
    scores = (qs @ cs.T).astype(np.float32)
    zero_rows = np.where(scores[0] == 0)[0]
    scores[0, zero_rows[::2]] = -0.0        # signed zeros among the ties
    assert np.signbit(scores[0, zero_rows[::2]]).all()
    for k in (50, 150, 500, n):
        s, i = emulate_select(f32_key(scores[0]), k)
        order = np.lexsort((np.arange(n), -scores[0].astype(np.float64)))[:k]
        want_s = scores[0, order]
        want_i = np.where(np.isneginf(want_s), -1, order)
        assert np.array_equal(i, want_i)
        assert np.array_equal(s, np.where(want_s == 0, 0, want_s))
        ps, pi = topk_scores_ref(torch.from_numpy(qs), torch.from_numpy(cs),
                                 k=k)
        assert np.array_equal(i, pi.numpy()[0])
    s, i = emulate_select(f32_key(scores[0]), n)
    assert (i[np.isneginf(s)] == -1).all() and np.isneginf(s).sum() == n // 6
    # the JAX package's wrapper (its Pallas kernel, interpreted) at k = N
    # = 30 over the same rows: the same scores, the same ids where the
    # score is finite (at -inf its repeated extraction returns -1 for the
    # first misses and 0 after them)
    small = (qs @ cs[:30].T).astype(np.float32)
    s, i = emulate_select(f32_key(small[0]), 30)
    js, ji = jtopk_scores(jnp.asarray(qs), jnp.asarray(cs[:30]), k=30)
    fin = np.isfinite(s)
    assert np.array_equal(np.asarray(js)[0], s)
    assert np.array_equal(np.asarray(ji)[0][fin], i[fin])
    assert (i[~fin] == -1).all() and (~fin).sum() == 5


@pytest.mark.parametrize("seed", range(4))
def test_floor_lies_at_or_below_the_kth_key(seed):
    """k tiles' largest keys lie at or above the floor bin, so the k-th
    best key does: the keys below it never change the answer."""
    rng = np.random.default_rng(seed)
    n, k = int(rng.integers(300, 30000)), int(rng.integers(1, 300))
    scores = (rng.standard_normal(n) * rng.integers(1, 50)
              + rng.integers(-10, 10)).astype(np.float32)
    if seed % 2:
        scores = np.sort(scores)            # the best rows in one tile
    keys = f32_key(scores)
    tmax = np.zeros(-(-n // ops.NARROW_ROWS), np.uint32)
    np.maximum.at(tmax, np.arange(n) // ops.NARROW_ROWS, keys)
    found = find_bin(np.bincount(tmax >> 21, minlength=2048), k)
    kth = np.sort(keys)[::-1][min(k, n) - 1]
    assert found is None or found[0] <= kth >> 21
    s, i = emulate_select(keys, min(k, n), seed=seed)
    order = np.lexsort((np.arange(n), -scores.astype(np.float64)))[:k]
    assert np.array_equal(i, order)


# ---- the scorer's geometry and arithmetic -------------------------------------

def _ldmatrix(stage, addrs, mats):
    """ldmatrix (b16) over a byte array: lane 8m + r names row r of matrix
    m; lane l receives word l % 4 of row l // 4 of each matrix."""
    regs = np.empty((32, mats), np.uint32)
    for lane in range(32):
        for m in range(mats):
            a = addrs[8 * m + lane // 4] + 4 * (lane % 4)
            regs[lane, m] = stage[a:a + 4].view(np.uint32)[0]
    return regs


@pytest.mark.parametrize("qt", [1, 2, 4, 8])
def test_narrow_fragment_geometry(qt):
    """Stage 256 corpus rows, then 8 qt query rows, 144 bytes apart, as
    stage_rows does; warp w's A fragments (its two m16 tiles of corpus
    rows, from its ldmatrix addresses) and B fragments (query n8 tiles,
    .x2 for one tile) give, in the m16n8k8 layout, accumulators holding
    row 32w + 16m + g + 8h against query 8j + 2t + b in acc[m][j][2h + b],
    as the key writes and tile maxima read them."""
    rng = np.random.default_rng(qt)
    nq = 8 * qt
    rows = rng.integers(-8, 9, (256 + nq, CHUNK // 4)).astype(np.float32)
    stage = np.zeros((256 + nq) * ROW, np.uint8)
    for r in range(256 + nq):
        stage[r * ROW:r * ROW + CHUNK] = rows[r].view(np.uint8)
    lanes = np.arange(32)
    lr, lm, g, t = lanes & 7, lanes >> 3, lanes >> 2, lanes & 3
    for warp in (0, 3, 7):
        a_off = (32 * warp + lr + 8 * (lm & 1)) * ROW + 16 * (lm >> 1)
        b_off = (256 + lr + 8 * (lm >> 1)) * ROW + 16 * (lm & 1)
        for kk in range(CHUNK // 32):
            acc = np.zeros((2, qt, 32, 4))
            for m in range(2):
                a = _ldmatrix(stage, a_off + m * 16 * ROW + kk * 32, 4)
                amat = np.zeros((16, 8))
                for lane in range(32):
                    for r, (row, col) in enumerate(
                            [(g[lane], t[lane]), (g[lane] + 8, t[lane]),
                             (g[lane], t[lane] + 4),
                             (g[lane] + 8, t[lane] + 4)]):
                        amat[row, col] = a[lane, r:r + 1].view(np.float32)[0]
                for jp in range(-(-qt // 2)):
                    mats = 2 if qt == 1 else 4
                    b = _ldmatrix(stage, b_off + jp * 16 * ROW + kk * 32,
                                  mats)
                    for h in range(mats // 2):
                        bmat = np.zeros((8, 8))
                        for lane in range(32):
                            for r in range(2):
                                bmat[t[lane] + 4 * r, g[lane]] = b[
                                    lane, 2 * h + r:2 * h + r + 1].view(
                                        np.float32)[0]
                        cm = amat @ bmat
                        for lane in range(32):
                            acc[m, 2 * jp + h, lane] = [
                                cm[g[lane], 2 * t[lane]],
                                cm[g[lane], 2 * t[lane] + 1],
                                cm[g[lane] + 8, 2 * t[lane]],
                                cm[g[lane] + 8, 2 * t[lane] + 1]]
            depth = slice(8 * kk, 8 * kk + 8)
            want = (rows[:256, depth].astype(np.float64)
                    @ rows[256:, depth].astype(np.float64).T)
            for m in range(2):
                for j in range(qt):
                    for e in range(4):
                        np.testing.assert_array_equal(
                            acc[m, j, :, e],
                            want[32 * warp + 16 * m + g + 8 * (e >> 1),
                                 8 * j + 2 * t + (e & 1)])


def tf32_split2(x):
    """tf32_split<2>: the high piece rounded to TF32 (ties away, on the
    bit pattern), the low piece what is left; both as the MMA reads them
    (top 10 mantissa bits)."""
    x = np.asarray(x, np.float32)
    hi = ((x.view(np.uint32) + np.uint32(0x1000))
          & np.uint32(0xFFFFE000)).view(np.float32)
    lo = (x - hi).astype(np.float32)
    read = lambda v: (v.view(np.uint32) & np.uint32(0xFFFFE000)).view(
        np.float32)
    return read(hi), read(lo)


def emulate_narrow(qs, cs):
    """narrow_scores' sums: D <= 8, each dot in f64 (products exact) in
    row order, rounded once; else per 128-byte chunk and MMA step the
    products c0 * q1, c1 * q0, c0 * q0 (each 2**12 larger, the scale on
    q1, c1 and c0), each MMA's sum truncated to f32, the chunk's sum added
    with a rounded f32 add after scaling back."""
    d = qs.shape[1]
    if d <= 8:
        acc = np.zeros((cs.shape[0], qs.shape[0]))
        for x in range(d):
            acc += cs[:, x:x + 1].astype(np.float64) * qs[:, x].astype(
                np.float64)
        return acc.astype(np.float32).T
    q0, q1 = (p.astype(np.float64) for p in tf32_split2(qs))
    c0, c1 = (p.astype(np.float64) for p in tf32_split2(cs))
    s = 2.0 ** 12
    acc = np.zeros((cs.shape[0], qs.shape[0]), np.float32)
    for ch in range(0, d, CHUNK // 4):
        part = np.zeros_like(acc)
        for k0 in range(ch, min(ch + CHUNK // 4, d), 8):
            ks = slice(k0, k0 + 8)
            for a, b in ((c0, q1 * s), (c1 * s, q0), (c0 * s, q0)):
                exact = part.astype(np.float64) + a[:, ks] @ b[:, ks].T
                f = exact.astype(np.float32)
                over = np.abs(f.astype(np.float64)) > np.abs(exact)
                f[over] = np.nextafter(f[over], np.float32(0))
                part = f
        acc = (acc + part / np.float32(s)).astype(np.float32)
    return acc.T


@pytest.mark.parametrize("q,n,d,k", [(1, 3000, 16, 100), (32, 600, 768, 16),
                                     (7, 800, 37, 8), (64, 900, 3, 40),
                                     (5, 1200, 8, 1200)])
def test_emulated_narrow_path_matches_the_references(q, n, d, k):
    """The emulated scorer's scores lie within D * 2**-24 * sum |q c| of
    the f64 product; its keys through the emulated select give the plain
    version's and the JAX package's ids away from near-ties (an id whose
    exact score lies within twice that bound of the other's)."""
    rng = np.random.default_rng(q * d + k)
    qs = rng.standard_normal((q, d)).astype(np.float32)
    cs = rng.standard_normal((n, d)).astype(np.float32)
    got = emulate_narrow(qs, cs)
    exact = qs.astype(np.float64) @ cs.astype(np.float64).T
    tol = d * 2.0 ** -24 * (np.abs(qs.astype(np.float64))
                            @ np.abs(cs.astype(np.float64)).T)
    assert (np.abs(got - exact) <= tol).all()
    s, ids = _select_all(got, k)
    rows = np.arange(q)[:, None]
    assert (np.abs(s - exact[rows, ids]) <= tol[rows, ids]).all()
    others = {"plain": _port_plain(qs, cs, k)[1],
              "jax ref": np.asarray(jtopk_ref(jnp.asarray(qs),
                                              jnp.asarray(cs), k=k)[1])}
    if k <= 32 and n <= 2000:           # the Pallas kernel, interpreted
        others["jax wrapper"] = np.asarray(
            jtopk_scores(jnp.asarray(qs), jnp.asarray(cs), k=k)[1])
    for name, want in others.items():
        diff = ids != want
        gap = np.abs(exact[rows, ids] - exact[rows, want])
        near = 2 * np.maximum(tol[rows, ids], tol[rows, want])
        assert (gap[diff] <= near[diff]).all(), name


# ---- the plans -----------------------------------------------------------------

@pytest.mark.parametrize("nq,n", [(1, 1), (1, 1_000_000), (32, 1_048_576),
                                  (64, 500_000), (7, 257), (3, 250_000),
                                  (64, 100_003)])
def test_narrow_plans_cover_every_pair_once(nq, n):
    """The scorer's blocks take runs of 256-row tiles, each against every
    query (Q <= NARROW_QUERIES), so every (query, row) pair is scored by
    one block; the select's items cut each query's keys into whole tiles
    from KEY_ALIGN-aligned starts, every key in one item."""
    per, blocks = ops.narrow_plan(n)
    tiles = -(-n // ops.NARROW_ROWS)
    seen = np.zeros(tiles, np.int64)
    for b in range(blocks):
        seen[b * per:min(b * per + per, tiles)] += 1
    assert (seen == 1).all() and blocks <= ops.NARROW_BLOCKS
    assert nq <= ops.NARROW_QUERIES
    chunks, per_item = ops.select_plan(nq, n)
    assert per_item % ops.NARROW_ROWS == 0
    assert per_item % ops.KEY_ALIGN == 0
    assert nq * chunks <= max(ops.SELECT_ITEMS, nq)
    assert chunks == 1 or per_item >= ops.SELECT_MIN_ITEM
    covered = np.zeros(n, np.int64)
    for c in range(chunks):
        covered[c * per_item:min(c * per_item + per_item, n)] += 1
    assert (covered == 1).all()
    scratch = ops.select_scratch_ints(nq, chunks)
    assert scratch == (ops.HEAD_INTS + nq * ops.STATE_INTS
                       + 4 * nq * ops.RADIX_BINS + nq * chunks)
