"""The dense top-k kernels' arithmetic and geometry, on the CPU.

On the card, ``topk_scores`` and ``topk_scores_int8`` above their narrow
cutoffs run ``dense_partial`` of csrc/dense_topk.cu: 128 queries a block
(two consumer warpgroups of 64), 128-row corpus tiles staged 64 bytes of
depth a step in the SWIZZLE_64B layout, by TMA (the query rows shared by
the two blocks of a cluster) or, for rows TMA cannot take, by the
producer warpgroup's word copies; products by ``wgmma`` with A (the
queries) in registers and B (the corpus) from shared memory, f32 as three
TF32 products of split operands summed a 512-byte chunk group at a time,
int8 as exact int32 sums; lists filled from a split's first tile by a
bitonic sort, later survivors buffered 32 a query and merged into the
lists by a bitonic merge. None of that runs here, so these tests hold
plain numpy emulations of each piece to the contract, and import no
kernel:

- the TF32 split (round to nearest, ties away, on the f32 bit pattern;
  the last piece read by the tensor cores as its top 10 mantissa bits)
  and the kernel's sums (three products a step, small terms first, summed
  a chunk group at a time into a fresh accumulator, whether the tensor
  cores round or truncate, the groups added with rounded adds; f64 sums
  on the CUDA cores where D is at most one step deep) held within
  ``chip_smoke.check_topk``'s bound D * 2**-24 * sum |q c| of the f64
  product, at D 2048 and at adversarial magnitudes, with top-k ids equal
  to the plain version's and the JAX package's away from near-ties;
- the geometry: the kernel's SWIZZLE_64B addresses are TMA's pattern, its
  staging path writes the box TMA would, and its A fragment words with
  the B operand its descriptors name give each lane's wgmma accumulators
  (m64nNk8 tf32, m64nNk32 s8) the (query, row) products that selection
  assumes;
- the route by stride and alignment (TMA or the staging path);
- the bitonic networks that fill a list from a split's first tile and
  merge 32 buffered survivors into a list, and the selection's buffered
  control flow against the exact top k;
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

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
SOURCE = CSRC / "dense_topk.cu"
# the kernel's, pinned to its source by test_tile_constants_match_the_kernel
EXACT_DEPTH = 8          # kExactDepth: D at most one wgmma step deep
SPAN = 64                # kDSpan: bytes of a row a ring stage holds
GROUP = 8                # kDGroup: stages a fresh accumulator sums
CHUNK = GROUP * SPAN     # bytes of depth a fresh accumulator sums
STEP = 32                # bytes of depth a wgmma step takes (8 f32, 32 s8)
BUF_K = 32               # kDBufK: survivors a query's buffer holds


def _constants(path=SOURCE):
    return {name: int(v) for name, v in
            re.findall(r"constexpr int (k\w+) = (\d+);", path.read_text())}


def test_tile_constants_match_the_kernel():
    """The wrapper plans splits in the kernels' tiles and these tests
    emulate their staging and sums: each shared constant must equal the
    source's."""
    c = _constants()
    assert (c["kDQ"], c["kDN"]) == (ops.DENSE_QUERIES, ops.DENSE_ROWS)
    assert c["kDCluster"] == ops.DENSE_CLUSTER
    assert (c["kExactDepth"], c["kDSpan"], c["kDGroup"], c["kDBufK"]) == (
        EXACT_DEPTH, SPAN, GROUP, BUF_K)
    # the narrow and gathered kernels' exact path takes the same depth
    assert _constants(CSRC / "topk_scores.cu")["kExactDepth"] == EXACT_DEPTH
    # two consumer warpgroups of 64 queries, one producer warpgroup
    assert c["kDQ"] == 2 * 64 and c["kDThreads"] == 3 * 128
    assert c["kDN"] == 128 and SPAN % STEP == 0
    assert c["kDMinStages"] >= 4


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
    """Scores of the f32 kernel: per chunk group (CHUNK bytes of depth),
    every wgmma step's products a_i * b_j (two pieces, i + j < 2, smallest
    first) summed into a fresh accumulator, each step's sum rounded as
    ``rounding`` says; each group's sum added to the running one with a
    rounded f32 add. D <= EXACT_DEPTH: each dot summed in f64 and rounded
    once."""
    d = q.shape[1]
    if d <= EXACT_DEPTH:                # f64 sums on the CUDA cores
        return (q.astype(np.float64) @ c.astype(np.float64).T).astype(
            np.float32)
    pieces = 2
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


# ---- geometry ---------------------------------------------------------------

def sw64(row, byte):
    """The kernel's sw64: byte ``byte`` of staged row ``row``."""
    return row * SPAN + ((((byte >> 4) ^ (row * SPAN >> 7)) & 3) << 4) + (
        byte & 15)


def tma_swizzle_64b(offset):
    """Where TMA's SWIZZLE_64B puts the byte at ``offset`` of a row-major
    box in a 512-byte aligned buffer: its 16-byte unit (bits 4-5) XORed
    with bits 7-8 (CUTLASS's Swizzle<2, 4, 3>)."""
    return offset ^ (((offset >> 7) & 3) << 4)


def stage(rows):
    """A box of 64-byte rows (uint8 [R, 64]) as TMA lands it."""
    out = np.zeros(rows.size, np.uint8)
    flat = rows.reshape(-1)
    out[tma_swizzle_64b(np.arange(flat.size))] = flat
    return out


def test_swizzle_is_tmas():
    """The staging path, the fragment loads and the wgmma descriptors all
    address staged bytes by sw64: it must be TMA's SWIZZLE_64B pattern,
    which the descriptors' layout type names."""
    rows, byte = np.meshgrid(np.arange(128), np.arange(SPAN), indexing="ij")
    assert np.array_equal(sw64(rows, byte), tma_swizzle_64b(rows * SPAN
                                                             + byte))
    # each 8-row group of 512 bytes is a permutation of itself
    for r0 in range(0, 128, 8):
        got = np.sort(sw64(rows[r0:r0 + 8], byte[r0:r0 + 8]).ravel())
        assert np.array_equal(got, np.arange(r0 * SPAN, (r0 + 8) * SPAN))


def _words(buf, offsets):
    return np.array([buf[o:o + 4].view(np.uint32)[0] for o in offsets])


def _values(words, as_type):
    return words.view(as_type).astype(np.float64)


def _warp_acc(qbuf, cbuf, warp, kk, as_type):
    """One wgmma step of warp ``warp``'s 16 queries x 128 rows as the
    kernel runs it: A fragment words loaded by frag_words' addresses and
    placed by the PTX layout of wgmma m64nNk8 tf32 (one value a register:
    a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)) or
    m64nNk32 s8 (four a register: a0 (g, 4t..), a1 (g + 8, 4t..), a2 (g,
    16 + 4t..), a3 (g + 8, 16 + 4t..)); B read as the descriptor names it,
    row n's bytes 32 kk.. at sw64(n, 32 kk + b); products exact. Returns
    acc[lane, j, e] by the accumulator layout: row 16 w' + g + 8 (e // 2),
    column 8j + 2t + e % 2."""
    per = 4 // np.dtype(as_type).itemsize        # values a register
    depth = STEP // np.dtype(as_type).itemsize
    amat = np.zeros((16, depth))
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        ra, rb = 16 * warp + g, 16 * warp + g + 8
        b0 = STEP * kk + 4 * t
        regs = _words(qbuf, [sw64(ra, b0), sw64(rb, b0), sw64(ra, b0 + 16),
                             sw64(rb, b0 + 16)])
        for r, (row, half) in enumerate([(g, 0), (g + 8, 0), (g, 1),
                                         (g + 8, 1)]):
            col = half * depth // 2 + per * t
            amat[row, col:col + per] = _values(regs[r:r + 1], as_type)
    bmat = np.zeros((128, depth))
    for nrow in range(128):
        offs = [sw64(nrow, STEP * kk + b) for b in range(0, STEP, 4)]
        bmat[nrow] = _values(_words(cbuf, offs), as_type)
    dmat = amat @ bmat.T
    acc = np.zeros((32, 16, 4))
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for j in range(16):
            acc[lane, j] = [dmat[g, 8 * j + 2 * t], dmat[g, 8 * j + 2 * t + 1],
                            dmat[g + 8, 8 * j + 2 * t],
                            dmat[g + 8, 8 * j + 2 * t + 1]]
    return acc


@pytest.mark.parametrize("as_type", [np.float32, np.int8])
def test_fragment_geometry(as_type):
    """Stage a chunk of 128 query rows and 128 corpus rows as TMA does;
    every consumer warp's accumulators, read as selection reads them
    (lane (g, t), acc[4j + 2h + b] is query 16w + g + 8h against row
    8j + 2t + b), hold exactly those dots, for both wgmma steps of the
    stage."""
    rng = np.random.default_rng(7)
    width = SPAN // np.dtype(as_type).itemsize
    if as_type == np.int8:
        rows = rng.integers(-127, 128, (256, width)).astype(np.int8)
    else:
        rows = rng.integers(-8, 9, (256, width)).astype(np.float32)
    qbuf = stage(rows[:128].view(np.uint8))
    cbuf = stage(rows[128:].view(np.uint8))
    depth = STEP // np.dtype(as_type).itemsize
    lanes = np.arange(32)
    g, t = lanes >> 2, lanes & 3
    for warp in (0, 3, 4, 7):
        for kk in range(SPAN // STEP):
            acc = _warp_acc(qbuf, cbuf, warp, kk, as_type)
            qpart = rows[:128, kk * depth:(kk + 1) * depth].astype(np.float64)
            cpart = rows[128:, kk * depth:(kk + 1) * depth].astype(np.float64)
            want = qpart @ cpart.T
            for j in range(16):
                for e in range(4):
                    h, b = e >> 1, e & 1
                    np.testing.assert_array_equal(
                        acc[:, j, e],
                        want[16 * warp + g + 8 * h, 8 * j + 2 * t + b])


def staged_words(mem, base, row_bytes, rows, ch):
    """The staging path's copy of chunk ``ch`` of ``rows`` rows at byte
    ``base`` of ``mem``: 4-byte words (a word of a row not 4-byte aligned
    assembled from its bytes, zeros past the row), each at sw64."""
    out = np.zeros(rows * SPAN, np.uint8)
    for r in range(rows):
        for x in range(0, SPAN, 4):
            off = ch * SPAN + x
            have = row_bytes - off
            src = base + r * row_bytes + off
            word = np.zeros(4, np.uint8)
            if have > 0:
                n = min(have, 4)
                word[:n] = mem[src:src + n]
            out[sw64(r, x):sw64(r, x) + 4] = word
    return out


@pytest.mark.parametrize("as_type,d,offset", [(np.float32, 9, 4),
                                              (np.int8, 20, 3)])
def test_staging_path_writes_the_tma_box(as_type, d, offset):
    """Rows TMA cannot take (a stride off 16 bytes, a base off 16): the
    producer's words land where TMA would put the same box, zeros past D,
    so the fragments and descriptors read them alike."""
    rng = np.random.default_rng(d)
    size = np.dtype(as_type).itemsize
    vals = rng.integers(-100, 100, (16, d)).astype(as_type)
    mem = np.zeros(offset + vals.nbytes, np.uint8)
    mem[offset:] = vals.view(np.uint8).ravel()
    row_bytes = d * size
    for ch in range(-(-row_bytes // SPAN)):
        box = np.zeros((16, SPAN), np.uint8)
        part = vals.view(np.uint8)[:, ch * SPAN:(ch + 1) * SPAN]
        box[:, :part.shape[1]] = part
        assert np.array_equal(staged_words(mem, offset, row_bytes, 16, ch),
                              stage(box))


@pytest.mark.parametrize("d,width,ptrs,want", [
    (2048, 4, (0, 1 << 20), True), (2050, 4, (0, 1 << 20), False),
    (768, 16, (0, 4096), True), (20, 16, (0, 4096), False),
    (2048, 4, (0, 1028), False), (0, 4, (0, 0), False)])
def test_route_by_stride_and_alignment(d, width, ptrs, want):
    """TMA takes rows whose stride is a whole number of 16-byte units at
    16-byte aligned bases; the rest (f32 D % 4, int8 D % 16, a sliced
    base, D = 0) take the staging path."""
    assert ops.dense_tma(d, width, *ptrs) is want


# ---- the lists: first-tile sort, buffered merges ---------------------------

def _better(s, i, t, ti):
    """beats: higher score, or equal score and lower id."""
    return (s > t) | ((s == t) & (i < ti))


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
            mine_better = _better(v, vi, pv, pi)
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


def _by_rank(s, i):
    order = np.lexsort((i, -s))
    return s[order], i[order]


def merge32(ls, li, cs, ci, k):
    """The kernel's lanes_merge32: the list (k <= 32 R entries, sorted)
    padded with empty entries to 32 X (X = 1, 2 or 4), the candidates
    sorted (warp_sort) and reversed into the last 32, the better of each
    pair of entries at one position, then half-cleaners of strides
    16 X .. 1 (the better to the lower entry); the first k."""
    r = -(-k // 32)
    x = {1: 1, 2: 2, 3: 4}[r]
    c = np.full(32 * x, -np.inf, np.float32)
    d = np.full(32 * x, -1, np.int64)
    c[:len(ls)], d[:len(li)] = ls, li
    cs, ci = _by_rank(cs, ci)
    rs = np.full(32 * x, -np.inf, np.float32)
    ri = np.full(32 * x, -1, np.int64)
    rs[32 * (x - 1):], ri[32 * (x - 1):] = cs[::-1], ci[::-1]
    take = _better(rs, ri, c, d)
    c, d = np.where(take, rs, c), np.where(take, ri, d)
    e = np.arange(32 * x)
    stride = 16 * x
    while stride >= 1:
        lo = (e & stride) == 0
        pe = e ^ stride
        pc, pd = c[pe], d[pe]
        take = np.where(lo, _better(pc, pd, c, d), _better(c, d, pc, pd))
        c, d = np.where(take, pc, c), np.where(take, pd, d)
        stride >>= 1
    return c[:k], d[:k]


@pytest.mark.parametrize("k", [10, 33, 80, 96])
def test_buffer_merge_network(k):
    """32 buffered survivors merged into a list of k entries (k in one,
    two and three registers a lane): the k best of both, best first, ties
    to the lower id, whatever their order in the buffer."""
    rng = np.random.default_rng(k)
    for trial in range(20):
        pool_s = rng.integers(-4, 5, k + 32).astype(np.float32)
        pool_i = rng.permutation(10_000)[:k + 32]
        ls, li = _by_rank(pool_s[:k], pool_i[:k])
        cs, ci = pool_s[k:].copy(), pool_i[k:].copy()
        if trial % 4 == 0:                  # a part-full buffer
            cs[rng.random(32) < 0.5] = -np.inf
        ci = np.where(np.isneginf(cs), -1, ci)
        got = merge32(ls, li, cs, ci, k)
        want = _by_rank(np.concatenate([ls, cs]), np.concatenate([li, ci]))
        assert np.array_equal(got[0], want[0][:k])
        fin = np.isfinite(want[0][:k])
        assert np.array_equal(got[1][fin], want[1][:k][fin])


def select_warp(scores, k, tile=128):
    """The kernel's selection for one warp's 16 queries over a split's
    tiles, step by step: the first tile fills each list by sort_row; later
    tiles filter each score against its query's bar (the k-th entry as of
    the last change of the list) and append the survivors to the query's
    buffer of BUF_K, merging a buffer into its list first where it would
    overflow; a tile with more survivors than a buffer holds for any query
    merges every buffer, then offers the survivors to the lists directly.
    The buffers are merged at the end."""
    nq, n = scores.shape
    empty = (np.full(k, -np.inf, np.float32), np.full(k, -1, np.int64))
    lists = [empty] * nq
    bars = [(-np.inf, -1)] * nq
    bufs = [([], []) for _ in range(nq)]

    def merge(q, s, i):
        cs, ci = _by_rank(np.concatenate([lists[q][0], s]),
                          np.concatenate([lists[q][1], i]))
        lists[q] = (cs[:k], ci[:k])
        bars[q] = (lists[q][0][k - 1], lists[q][1][k - 1])

    def flush(q):
        if bufs[q][0]:
            merge(q, np.float32(bufs[q][0]), np.int64(bufs[q][1]))
        bufs[q] = ([], [])

    for t0 in range(0, n, tile):
        ids = np.arange(t0, min(t0 + tile, n))
        surv = []
        for q in range(nq):
            s = scores[q, ids]
            keep = _better(s, ids, *bars[q]) & ~np.isneginf(s)
            surv.append((s[keep], ids[keep]))
        if t0 == 0:
            for q in range(nq):
                v, vi = sort_row(np.pad(scores[q, ids], (0, tile - len(ids)),
                                        constant_values=-np.inf), 0)
                lists[q] = (v[:k], vi[:k])
                bars[q] = (lists[q][0][k - 1], lists[q][1][k - 1])
            continue
        if any(len(s) > BUF_K for s, _ in surv):
            for q in range(nq):
                flush(q)
                merge(q, *surv[q])
            continue
        for q in range(nq):
            if len(bufs[q][0]) + len(surv[q][0]) > BUF_K:
                flush(q)
            bufs[q][0].extend(surv[q][0])
            bufs[q][1].extend(surv[q][1])
    for q in range(nq):
        flush(q)
    return lists


@pytest.mark.parametrize("kind,k", [("normal", 10), ("normal", 80),
                                    ("ties", 33), ("rising", 40)])
def test_buffered_selection_is_exact(kind, k):
    """The buffered selection's lists equal each query's exact top k by
    (score desc, id asc): on random scores (few survivors after the first
    tiles), on small integers (many exact ties) and on rising scores
    (every tile beats the lists: the direct path each tile)."""
    rng = np.random.default_rng(k)
    n = 1500
    if kind == "normal":
        scores = rng.standard_normal((16, n)).astype(np.float32)
    elif kind == "ties":
        scores = rng.integers(-3, 4, (16, n)).astype(np.float32)
    else:
        scores = (np.arange(n)[None, :] + rng.random((16, n))).astype(
            np.float32)
    lists = select_warp(scores, k)
    for q in range(16):
        want = _by_rank(scores[q], np.arange(n))
        assert np.array_equal(lists[q][0], want[0][:k])
        assert np.array_equal(lists[q][1], want[1][:k])


# ---- the split plan ---------------------------------------------------------

@pytest.mark.parametrize("nq,n", [(1, 1), (128, 524288), (256, 39780),
                                  (257, 78705), (129, 777), (5000, 300)])
def test_dense_split_plan(nq, n):
    """Splits come in clusters of DENSE_CLUSTER, every split walks the
    same number of tiles (those past N score nothing), every 128-row tile
    falls in one, and the grid stays at or below one block a streaming
    multiprocessor unless a cluster a query tile is more; at the curve's
    Q 128 over 524288 rows each of 128 blocks takes 32 tiles."""
    per, splits = ops.dense_plan(nq, n, ops.DENSE_BLOCKS)
    tiles = -(-n // ops.DENSE_ROWS)
    q_tiles = -(-nq // ops.DENSE_QUERIES)
    assert splits % ops.DENSE_CLUSTER == 0 and per >= 1
    assert per * (splits - ops.DENSE_CLUSTER) < tiles <= per * splits
    assert splits * q_tiles <= max(ops.DENSE_BLOCKS,
                                   ops.DENSE_CLUSTER * q_tiles)
    if (nq, n) == (128, 524288):
        assert (per, splits) == (32, 128)
