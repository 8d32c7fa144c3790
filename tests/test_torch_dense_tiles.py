"""The dense top-k kernels' arithmetic and geometry, on the CPU.

On the card, ``topk_scores`` and ``topk_scores_int8`` run
``dense_partial`` of csrc/topk_scores.cu: 128 queries a block, 128-row
corpus tiles, fragments loaded by ldmatrix from rows staged 144 bytes
apart, products on the tensor cores (f32 as three TF32 products of split
operands, int8 as exact int32 MMA), a bitonic sort filling each list from
a split's first tile. None of that runs here, so these tests hold plain
numpy emulations of each piece to the contract, and import no kernel:

- the TF32 split (round to nearest, ties away, on the f32 bit pattern;
  the last piece read by the MMA as its top 10 mantissa bits) and the
  kernel's sums (three products a step, small terms first, summed a
  128-byte chunk at a time, whether the MMA rounds or truncates, the
  chunks added with rounded adds; the exact three-piece split where D is
  at most one MMA deep) held within ``chip_smoke.check_topk``'s bound
  D * 2**-24 * sum |q c| of the f64 product, at D 2048 and at
  adversarial magnitudes, with top-k ids equal to the plain version's and
  the JAX package's away from near-ties;
- the fragment geometry: the kernel's ldmatrix row addresses and the PTX
  fragment layouts of m16n8k8 (tf32) and m16n8k32 (s8) give each lane's
  accumulators the (query, row) products that selection assumes;
- the bitonic network that fills a list from a split's first tile;
- the split plan, and the tile constants ``ops.py`` shares with the
  kernel source.
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
from repro_torch.kernels.topk_scoring.ref import (topk_scores_int8_ref,
                                                  topk_scores_ref)

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "csrc" / "topk_scores.cu")
# the kernel's, pinned to its source by test_tile_constants_match_the_kernel
EXACT_DEPTH = 8          # kExactDepth: D at most one MMA step deep
CHUNK = 128              # kDChunk: bytes of a row staged per step
ROW = CHUNK + 16         # kDRow: a staged row's stride in shared memory
STEP = 32                # bytes of depth an MMA step takes (8 f32, 32 s8)


def _constants():
    return {name: int(v) for name, v in
            re.findall(r"constexpr int (k\w+) = (\d+);", SOURCE.read_text())}


def test_tile_constants_match_the_kernel():
    """The wrapper plans splits in the kernels' tiles and these tests
    emulate its staging: each shared constant must equal the source's."""
    c = _constants()
    assert (c["kDQ"], c["kDN"]) == (ops.DENSE_QUERIES, ops.DENSE_ROWS)
    assert (c["kExactDepth"], c["kDChunk"]) == (EXACT_DEPTH, CHUNK)
    assert c["kDChunk"] + 16 == ROW
    assert c["kDN"] == 128 and c["kDQ"] == 8 * 16   # 8 warps of 16 queries


# ---- the TF32 split and the kernel's sums ----------------------------------

def tf32_round(x):
    """Round f32 to TF32 (10 mantissa bits), to nearest, ties away: the
    kernel's integer add and mask on the bit pattern."""
    b = np.asarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_read(x):
    """What the MMA reads of an f32 register passed as TF32: its top 10
    mantissa bits."""
    b = np.asarray(x, np.float32).view(np.uint32)
    return (b & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_split(x, pieces):
    """The kernel's tf32_split: each piece but the last rounded from what
    the ones before leave, the last passed as it is; returned as the MMA
    reads them."""
    rest = np.asarray(x, np.float32)
    out = []
    for i in range(pieces):
        p = tf32_round(rest) if i + 1 < pieces else rest
        out.append(tf32_read(p))
        rest = (rest - p).astype(np.float32)
    return out


def _round_f32(s64, rounding):
    f = s64.astype(np.float32)
    if rounding == "zero":              # toward zero, as the MMA may
        over = np.abs(f.astype(np.float64)) > np.abs(s64)
        f[over] = np.nextafter(f[over], np.float32(0))
    return f


def emulate_dense(q, c, rounding):
    """Scores of the f32 kernel: per 128-byte chunk, every MMA step's
    products a_i * b_j (i + j < pieces, smallest first) summed into a
    fresh accumulator, each MMA's sum rounded as ``rounding`` says; each
    chunk's sum added to the running one with a rounded f32 add."""
    d = q.shape[1]
    pieces = 3 if d <= EXACT_DEPTH else 2
    a = [p.astype(np.float64) for p in tf32_split(q, pieces)]
    b = [p.astype(np.float64) for p in tf32_split(c, pieces)]
    acc = np.zeros((q.shape[0], c.shape[0]), np.float32)
    per_chunk, per_step = CHUNK // 4, STEP // 4
    for c0 in range(0, d, per_chunk):
        part = np.zeros_like(acc)
        for k0 in range(c0, min(c0 + per_chunk, d), per_step):
            ks = slice(k0, k0 + per_step)
            for total in range(pieces - 1, -1, -1):
                for i in range(total, -1, -1):
                    exact = part.astype(np.float64) + a[i][:, ks] @ \
                        b[total - i][:, ks].T
                    part = _round_f32(exact, rounding)
        acc = (acc + part).astype(np.float32)
    return acc


def _inputs(kind, q, n, d, seed):
    rng = np.random.default_rng(seed)
    qs = rng.standard_normal((q, d))
    cs = rng.standard_normal((n, d))
    if kind == "like_signed":           # no cancellation: a biased sum shows
        qs, cs = np.abs(qs), -np.abs(cs)
    elif kind == "wide":                # rows spanning 2**-20..2**20
        qs *= 2.0 ** rng.integers(-20, 21, (q, 1))
        cs *= 2.0 ** rng.integers(-20, 21, (n, 1))
    elif kind == "denormal_rest":       # q - tf32(q) below 2**-126
        qs *= 2.0 ** -118
        cs *= 2.0 ** 100
    return qs.astype(np.float32), cs.astype(np.float32)


def _bound(qs, cs):
    """chip_smoke.check_topk's tolerance for every (query, row) score."""
    mag = np.abs(qs.astype(np.float64)) @ np.abs(cs.astype(np.float64)).T
    return qs.shape[1] * 2.0 ** -24 * mag


def test_tf32_split_pieces():
    """Rounded pieces are TF32 values; three pieces hold x exactly (down
    to the TF32 step among denormals, 2**-136), two within 2**-21 of |x|
    or that step; denormal and wide-exponent inputs included."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(20000)
         * 2.0 ** rng.integers(-140, 100, 20000)).astype(np.float32)
    x = x[np.isfinite(x) & (x != 0)]
    for pieces in (2, 3):
        parts = tf32_split(x, pieces)
        for p in parts:
            assert not (p.view(np.uint32) & np.uint32(0x1FFF)).any()
        got = sum(p.astype(np.float64) for p in parts)
        err = np.abs(got - x.astype(np.float64))
        if pieces == 3:
            assert (err[np.abs(x) >= 2.0 ** -100] == 0).all()
            assert (err <= 2.0 ** -136).all()
        else:
            assert (err <= np.maximum(2.0 ** -21 * np.abs(x),
                                      2.0 ** -136)).all()
    hi = tf32_split(np.float32([1 + 2 ** -11, -(1 + 2 ** -11)]), 2)[0]
    assert hi.tolist() == [1 + 2 ** -10, -(1 + 2 ** -10)]   # ties away


@pytest.mark.parametrize("kind,d", [
    ("normal", 2048), ("like_signed", 2048), ("wide", 2048),
    ("denormal_rest", 2048), ("normal", 4), ("like_signed", 8),
    ("normal", 16), ("normal", 37), ("wide", 64), ("like_signed", 130)])
@pytest.mark.parametrize("rounding", ["nearest", "zero"])
def test_emulated_sums_within_the_summation_bound(kind, d, rounding):
    """Against the f64 product, every score the kernel's arithmetic gives
    lies within the bound chip_smoke.check_topk holds the kernel to
    against the plain version, whether the MMA rounds or truncates."""
    qs, cs = _inputs(kind, 8, 256, d, seed=d)
    got = emulate_dense(qs, cs, rounding).astype(np.float64)
    exact = qs.astype(np.float64) @ cs.astype(np.float64).T
    assert (np.abs(got - exact) <= _bound(qs, cs)).all()


def _topk(scores, k):
    """Top k of each row, ties to the lowest id."""
    order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(scores, order, 1), order


@pytest.mark.parametrize("kind,d", [("normal", 2048), ("wide", 2048),
                                    ("denormal_rest", 2048),
                                    ("normal", 37)])
def test_emulated_topk_matches_the_references(kind, d):
    """The emulated kernel's top-k ids equal the plain version's, the JAX
    reference's and the JAX package's kernel wrapper's (in interpret mode,
    as its own tests run it), except where the two ids' exact scores lie
    within twice the summation bound (a near-tie)."""
    k = 5
    qs, cs = _inputs(kind, 16, 512, d, seed=d + 1)
    _, ids = _topk(emulate_dense(qs, cs, "zero"), k)
    exact = qs.astype(np.float64) @ cs.astype(np.float64).T
    tol = _bound(qs, cs)
    others = {
        "plain": topk_scores_ref(torch.from_numpy(qs), torch.from_numpy(cs),
                                 k=k)[1].numpy(),
        "jax ref": np.asarray(jtopk_ref(jnp.asarray(qs), jnp.asarray(cs),
                                        k=k)[1]),
        "jax wrapper": np.asarray(jtopk_scores(jnp.asarray(qs),
                                               jnp.asarray(cs), k=k)[1]),
    }
    rows = np.arange(qs.shape[0])[:, None]
    for name, want in others.items():
        diff = ids != want
        gap = np.abs(exact[rows, ids] - exact[rows, want])
        near = 2 * np.maximum(tol[rows, ids], tol[rows, want])
        assert (gap[diff] <= near[diff]).all(), name


def test_int8_products_are_exact():
    """int8 codes: the MMA's int32 sums are the exact dots, ranked as f32
    like the plain version's, so the top-k is the plain version's to the
    bit, duplicated rows (exact ties) included."""
    rng = np.random.default_rng(3)
    qc = rng.integers(-127, 128, (9, 2047)).astype(np.int8)
    cc = rng.integers(-127, 128, (300, 2047)).astype(np.int8)
    cc[150:] = cc[:150]
    dots = qc.astype(np.int64) @ cc.astype(np.int64).T
    assert np.abs(dots).max() < 2 ** 31
    s, i = _topk(dots.astype(np.float32), 40)
    s_ref, i_ref = topk_scores_int8_ref(torch.from_numpy(qc),
                                        torch.from_numpy(cc), k=40)
    assert np.array_equal(s, s_ref.numpy())
    assert np.array_equal(i, i_ref.numpy())


# ---- fragment geometry ------------------------------------------------------

def _ldmatrix_x4(stage, addrs):
    """ldmatrix.x4 (b16) over a byte array: lane 8m + r names row r of
    matrix m; lane l receives word l % 4 of row l // 4 of each matrix."""
    regs = np.empty((32, 4), np.uint32)
    for lane in range(32):
        for m in range(4):
            a = addrs[8 * m + lane // 4] + 4 * (lane % 4)
            regs[lane, m] = stage[a:a + 4].view(np.uint32)[0]
    return regs


def _warp_tile(stage, warp, kk, as_type):
    """One MMA step of warp ``warp``'s 16 x 128 tile as the kernel runs
    it: ldmatrix addresses from its lane formulas, fragments placed by
    the PTX layouts of m16n8k8 (tf32: one value a register) or m16n8k32
    (s8: four a register), products exact. Returns acc[lane, j, e]."""
    per = 4 // np.dtype(as_type).itemsize        # values a register
    depth = STEP // np.dtype(as_type).itemsize
    lanes = np.arange(32)
    lr, lm = lanes & 7, lanes >> 3
    a_off = (16 * warp + lr + 8 * (lm & 1)) * ROW + 16 * (lm >> 1)
    b_off = (128 + lr + 8 * (lm >> 1)) * ROW + 16 * (lm & 1)
    vals = lambda reg: reg.reshape(-1).view(as_type).astype(np.float64)
    a_regs = _ldmatrix_x4(stage, a_off + kk * STEP)
    amat = np.zeros((16, depth))
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for r, (row, col) in enumerate([(g, 0), (g + 8, 0), (g, 1),
                                        (g + 8, 1)]):
            c0 = col * depth // 2 + per * t
            amat[row, c0:c0 + per] = vals(a_regs[lane, r])
    acc = np.zeros((32, 16, 4))
    for jp in range(8):
        b_regs = _ldmatrix_x4(stage, b_off + jp * 16 * ROW + kk * STEP)
        for h in range(2):
            bmat = np.zeros((depth, 8))
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for r in range(2):
                    k0 = r * depth // 2 + per * t
                    bmat[k0:k0 + per, g] = vals(b_regs[lane, 2 * h + r])
            cmat = amat @ bmat
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                acc[lane, 2 * jp + h] = [cmat[g, 2 * t], cmat[g, 2 * t + 1],
                                         cmat[g + 8, 2 * t],
                                         cmat[g + 8, 2 * t + 1]]
    return acc


@pytest.mark.parametrize("as_type", [np.float32, np.int8])
def test_fragment_geometry(as_type):
    """Stage 128 query rows and 128 corpus rows as the kernel does (144
    bytes apart, queries first); every warp's accumulators, read as
    selection reads them (lane (g, t), acc[j][2h + b] is query
    16w + g + 8h against row 8j + 2t + b), hold exactly those dots."""
    rng = np.random.default_rng(7)
    width = CHUNK // np.dtype(as_type).itemsize
    if as_type == np.int8:
        rows = rng.integers(-127, 128, (256, width)).astype(np.int8)
    else:
        rows = rng.integers(-8, 9, (256, width)).astype(np.float32)
    stage = np.zeros(256 * ROW, np.uint8)
    for r in range(256):
        stage[r * ROW:r * ROW + CHUNK] = rows[r].view(np.uint8)
    depth = STEP // np.dtype(as_type).itemsize
    lanes = np.arange(32)
    g, t = lanes >> 2, lanes & 3
    for warp in (0, 5, 7):
        for kk in range(CHUNK // STEP):
            acc = _warp_tile(stage, warp, kk, as_type)
            qpart = rows[:128, kk * depth:(kk + 1) * depth].astype(np.float64)
            cpart = rows[128:, kk * depth:(kk + 1) * depth].astype(np.float64)
            want = qpart @ cpart.T
            for j in range(16):
                for e in range(4):
                    h, b = e >> 1, e & 1
                    np.testing.assert_array_equal(
                        acc[:, j, e],
                        want[16 * warp + g + 8 * h, 8 * j + 2 * t + b])


# ---- the first tile's sort --------------------------------------------------

def sort_row(scores, n0):
    """The kernel's sort_row: a bitonic network over entry e = 32x + lane
    (4 registers a lane), partner e ^ j, the lower of a pair taking the
    better (by score, then lower id) where its block of 2**ls runs best
    first; -inf entries get id -1."""
    v = np.asarray(scores, np.float32).copy()
    e = np.arange(v.size)
    vi = np.where(np.isneginf(v), -1, n0 + e)
    ls = 1
    while (1 << ls) <= v.size:
        for lj in range(ls - 1, -1, -1):
            j = 1 << lj
            pv, pi = v[e ^ j], vi[e ^ j]
            mine_better = (v > pv) | ((v == pv) & (vi < pi))
            want_better = ((e & j) == 0) == ((e >> ls & 1) == 0)
            take = want_better != mine_better
            v, vi = np.where(take, pv, v), np.where(take, pi, vi)
        ls += 1
    return v, vi


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_first_tile_sort_network(seed):
    """Scores with many exact ties and some -inf (rows past N) come out
    best first, ties to the lower id: the list a split's first tile
    fills, for any k <= 128."""
    rng = np.random.default_rng(seed)
    scores = rng.integers(-5, 6, 128).astype(np.float32)
    scores[rng.random(128) < 0.2] = -np.inf
    v, vi = sort_row(scores, n0=1000)
    order = np.lexsort((np.arange(128), -scores))
    want_v = scores[order]
    want_i = np.where(np.isneginf(want_v), -1, 1000 + order)
    assert np.array_equal(v, want_v)
    assert np.array_equal(vi[np.isfinite(v)], want_i[np.isfinite(want_v)])


# ---- the split plan ---------------------------------------------------------

@pytest.mark.parametrize("nq,n", [(1, 1), (128, 524288), (256, 524700),
                                  (257, 78705), (129, 777), (5000, 300)])
def test_dense_split_plan(nq, n):
    """Every 128-row tile falls in exactly one split, no split is empty,
    and the grid stays near one block a streaming multiprocessor; at the
    curve's Q 128 over 524288 rows each of 128 blocks takes 32 tiles."""
    per, splits = ops.split_plan(nq, n, ops.DENSE_QUERIES, ops.DENSE_ROWS,
                                 ops.DENSE_BLOCKS)
    tiles = -(-n // ops.DENSE_ROWS)
    q_tiles = -(-nq // ops.DENSE_QUERIES)
    assert per * (splits - 1) < tiles <= per * splits
    assert splits * q_tiles <= max(ops.DENSE_BLOCKS, q_tiles)
    if (nq, n) == (128, 524288):
        assert (per, splits) == (32, 128)
