"""The int8 top-k for few queries, emulated on the CPU.

On the card, ``topk_scores_int8`` with Q at or below
``INT8_NARROW_QUERIES`` runs the narrow pair of csrc/topk_scores.cu with
the scorer's s8 form: ``narrow_scores<signed char, ...>`` puts 256-row
tiles of corpus codes on the M side of ``mma.sync.m16n8k32.s8.s8.s32``
and the real queries, rounded up to 8, on its N side, and writes each
exact int32 dot's order key as the f32 it rounds to (the reference ranks
``int32.astype(float32)``), with each tile's largest key; the f32 path's
``narrow_select`` then picks the k best. Neither runs here, so these tests
hold numpy emulations of each step to the contract:

- the s8 fragment geometry: the scorer's ldmatrix addresses over rows
  staged 144 bytes apart and the PTX m16n8k32 s8 fragment layouts give
  lane (g, t) of warp w row 32w + 16m + g + 8h against query 8j + 2t + b
  in acc[m][j][2h + b], as the key writes read them, per query tile;
- the keys through the emulated select (``test_torch_dense_narrow``'s)
  held bit for bit to ``topk_scores_int8_ref`` and to the JAX package's
  ``topk_scores_int8`` (its Pallas kernel, interpreted, where k <= 32 and
  N is small; else its jnp reference), at Q 1, 7, 32 and 64, a ragged N,
  D 768, 37 and 2048, the last with codes at +-127 so that distinct dots
  round to one f32 and the lowest id must win;
- the int8 cutoff constant and the C entry that enforces it, pinned to
  the kernel source; the wrapper on both sides of the cutoff.
Inputs are made with numpy from a seed.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.topk_scoring.ops import topk_scores_int8 as jtopk_int8
from repro.kernels.topk_scoring.ref import topk_scores_int8_ref as jint8_ref
from repro_torch.kernels.topk_scoring import ops
from repro_torch.kernels.topk_scoring.ref import topk_scores_int8_ref
from test_torch_dense_narrow import emulate_select, f32_key

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "csrc" / "topk_scores.cu")
ROW = 144                 # kDRow: a staged row's stride in shared memory
CHUNK = 128               # kDChunk: bytes (codes) of a row staged per step
STEP = 32                 # codes an m16n8k32 step takes


def _constants():
    return {name: int(v) for name, v in
            re.findall(r"constexpr int (k\w+) = (\d+);", SOURCE.read_text())}


def test_int8_cutoff_matches_the_kernel():
    """The wrapper routes Q <= INT8_NARROW_QUERIES to the s8 scorer, whose
    C entry refuses more than kNQInt8 queries; the scorer's blocks hold at
    most kNQMax, so the cutoff cannot pass it."""
    c = _constants()
    assert c["kNQInt8"] == ops.INT8_NARROW_QUERIES
    assert 1 <= ops.INT8_NARROW_QUERIES <= c["kNQMax"] == ops.NARROW_QUERIES
    src = SOURCE.read_text()
    entry = src[src.index('extern "C" int topk_narrow_scores_int8('):]
    assert "nq > kNQInt8" in entry[:entry.index("}")]
    assert "launch_narrow_depth<signed char, false>" in entry
    # a 128-byte chunk is four k32 steps, staged at the f32 path's stride
    assert (c["kDChunk"], c["kDChunk"] + 16) == (CHUNK, ROW)
    assert CHUNK % STEP == 0


def _ldmatrix(stage, addrs, mats):
    """ldmatrix (b16) over a byte array: lane 8m + r names row r of matrix
    m; lane l receives word l % 4 of row l // 4 of each matrix."""
    regs = np.empty((32, mats), np.uint32)
    for lane in range(32):
        for m in range(mats):
            a = addrs[8 * m + lane // 4] + 4 * (lane % 4)
            regs[lane, m] = stage[a:a + 4].view(np.uint32)[0]
    return regs


def _codes(reg):
    """The four s8 codes of a 32-bit register, lowest byte first."""
    return np.frombuffer(np.uint32(reg).tobytes(), np.int8).astype(np.int64)


@pytest.mark.parametrize("qt", [1, 2, 4, 8])
def test_int8_fragment_geometry(qt):
    """Stage 256 code rows, then 8 qt query rows, 144 bytes apart, as
    stage_rows does; warp w's A fragments (its two m16 tiles of corpus
    rows) and B fragments (query n8 tiles, .x2 for one tile) read in the
    m16n8k32 s8 layout (a0/a1: rows g and g + 8, codes 4t..4t+3; a2/a3:
    codes 16 + 4t..; b0/b1: query g, codes 4t.. and 16 + 4t..) give
    accumulators holding row 32w + 16m + g + 8h against query 8j + 2t + b
    in acc[m][j][2h + b]."""
    rng = np.random.default_rng(qt)
    nq = 8 * qt
    rows = rng.integers(-128, 128, (256 + nq, CHUNK)).astype(np.int8)
    stage = np.zeros((256 + nq) * ROW, np.uint8)
    for r in range(256 + nq):
        stage[r * ROW:r * ROW + CHUNK] = rows[r].view(np.uint8)
    lanes = np.arange(32)
    lr, lm, g, t = lanes & 7, lanes >> 3, lanes >> 2, lanes & 3
    for warp in (0, 5, 7):
        a_off = (32 * warp + lr + 8 * (lm & 1)) * ROW + 16 * (lm >> 1)
        b_off = (256 + lr + 8 * (lm >> 1)) * ROW + 16 * (lm & 1)
        for kk in range(CHUNK // STEP):
            acc = np.zeros((2, qt, 32, 4), np.int64)
            for m in range(2):
                a = _ldmatrix(stage, a_off + m * 16 * ROW + kk * STEP, 4)
                amat = np.zeros((16, STEP), np.int64)
                for lane in range(32):
                    for r, (row, col) in enumerate(
                            [(g[lane], 4 * t[lane]),
                             (g[lane] + 8, 4 * t[lane]),
                             (g[lane], 16 + 4 * t[lane]),
                             (g[lane] + 8, 16 + 4 * t[lane])]):
                        amat[row, col:col + 4] = _codes(a[lane, r])
                mats = 2 if qt == 1 else 4
                for jp in range(-(-qt // 2)):
                    b = _ldmatrix(stage, b_off + jp * 16 * ROW + kk * STEP,
                                  mats)
                    for h in range(mats // 2):
                        bmat = np.zeros((STEP, 8), np.int64)
                        for lane in range(32):
                            for r in range(2):
                                k0 = 16 * r + 4 * t[lane]
                                bmat[k0:k0 + 4, g[lane]] = _codes(
                                    b[lane, 2 * h + r])
                        cm = amat @ bmat
                        for lane in range(32):
                            acc[m, 2 * jp + h, lane] = [
                                cm[g[lane], 2 * t[lane]],
                                cm[g[lane], 2 * t[lane] + 1],
                                cm[g[lane] + 8, 2 * t[lane]],
                                cm[g[lane] + 8, 2 * t[lane] + 1]]
            depth = slice(STEP * kk, STEP * kk + STEP)
            want = (rows[:256, depth].astype(np.int64)
                    @ rows[256:, depth].astype(np.int64).T)
            for m in range(2):
                for j in range(qt):
                    for e in range(4):
                        np.testing.assert_array_equal(
                            acc[m, j, :, e],
                            want[32 * warp + 16 * m + g + 8 * (e >> 1),
                                 8 * j + 2 * t + (e & 1)])


def emulate_int8(qc, cc, k):
    """The s8 scorer's keys (each exact dot rounded to f32, keyed) through
    the emulated select -> (scores, ids) of each query's k best."""
    dots = qc.astype(np.int64) @ cc.astype(np.int64).T
    assert np.abs(dots).max(initial=0) < 2 ** 31          # int32 sums
    keys = f32_key(dots.astype(np.float32))
    out = [emulate_select(row, k, seed=i) for i, row in enumerate(keys)]
    return np.stack([o[0] for o in out]), np.stack([o[1] for o in out])


def _codes_for(q, n, d, kind, seed):
    """int8 codes. "random": uniform in [-127, 127], half the rows
    duplicating the other half (exact ties). "pm127": codes at +-127 but
    in the last two columns, where the queries hold 1 or 2 and the rows
    anything; each row flips up to three leading codes. Dots then lie
    near 127**2 (D - 2), past 2**24, a unit apart, and distinct dots
    round to one f32 (ties the lowest id must win)."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        qc = rng.integers(-127, 128, (q, d)).astype(np.int8)
        cc = rng.integers(-127, 128, (n, d)).astype(np.int8)
        cc[n // 2:] = cc[: n - n // 2]
        return qc, cc
    qc = np.full((q, d), 127, np.int8)
    qc[:, -2:] = rng.integers(1, 3, (q, 2))
    cc = np.full((n, d), 127, np.int8)
    cc[np.arange(d)[None, :] < rng.integers(0, 4, n)[:, None]] = -127
    cc[:, -2:] = rng.integers(-127, 128, (n, 2))
    return qc, cc


@pytest.mark.parametrize("q,n,d,k,kind", [
    (1, 1000, 768, 10, "random"),
    (7, 777, 37, 16, "random"),          # a ragged N and D
    (32, 1500, 768, 64, "random"),       # the serving tick's pool k
    (64, 513, 37, 32, "random"),         # Q at the cutoff
    (3, 2000, 2048, 40, "pm127"),        # f32-rounding ties, lowest id
    (1, 5000, 2048, 300, "pm127"),       # past SORT_K in one bin: radix
])
def test_emulated_int8_path_matches_the_references(q, n, d, k, kind):
    """The emulated s8 scorer and select equal the port's plain version
    bit for bit (scores and ids, ties to the lowest id) and the JAX
    package's int8 top-k."""
    qc, cc = _codes_for(q, n, d, kind, seed=q * n + d)
    s, i = emulate_int8(qc, cc, k)
    ps, pi = topk_scores_int8_ref(torch.from_numpy(qc), torch.from_numpy(cc),
                                  k=k)
    assert np.array_equal(s, ps.numpy()) and np.array_equal(i, pi.numpy())
    if kind == "pm127":         # distinct dots share an f32: ties decided
        dots = qc[:1].astype(np.int64) @ cc.astype(np.int64).T
        f = dots.astype(np.float32)
        assert np.abs(dots).max() > 2 ** 24
        assert np.unique(f).size < np.unique(dots).size
    if k <= 32 and n <= 1000:            # the Pallas kernel, interpreted
        js, ji = jtopk_int8(jnp.asarray(qc), jnp.asarray(cc), k=k)
    else:
        js, ji = jint8_ref(jnp.asarray(qc), jnp.asarray(cc), k=k)
    assert np.array_equal(s, np.asarray(js))
    assert np.array_equal(i, np.asarray(ji))


def test_int8_wrapper_routes_by_the_cutoff():
    """On the CPU both sides of the cutoff run the plain version; the
    narrow layout a shape takes is computed once (the wrapper's plan
    cache) and is the same for both input types."""
    rng = np.random.default_rng(0)
    for q in (ops.INT8_NARROW_QUERIES, ops.INT8_NARROW_QUERIES + 1):
        qc = torch.from_numpy(rng.integers(-127, 128, (q, 48)).astype(
            np.int8))
        cc = torch.from_numpy(rng.integers(-127, 128, (300, 48)).astype(
            np.int8))
        s, i = ops.topk_scores_int8(qc, cc, k=310)
        ps, pi = topk_scores_int8_ref(qc, cc, k=300)
        assert torch.equal(s[:, :300], ps) and torch.equal(i[:, :300], pi)
        assert bool((i[:, 300:] == -1).all())
    ops._narrow_layout.cache_clear()
    a = ops._narrow_layout(32, 1_048_576, 64)
    assert ops._narrow_layout(32, 1_048_576, 64) is a
    assert ops._narrow_layout.cache_info().hits == 1
