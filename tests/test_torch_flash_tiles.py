"""The short-row flash kernel on the tensor cores, on the CPU.

On the card, ``flash_attention`` at the encoder's shapes (f32, D 32, at
most 64 keys) runs ``flash_short_tc`` of csrc/flash_attention.cu:
persistent blocks whose producer warp fills a ring of Q, K and V boxes by
TMA in the SWIZZLE_128B layout, and four consumer warps of 16 query rows
that take S = Q K^T and O = P V as ``mma.sync.m16n8k8`` TF32 products of
split operands (3xTF32: hi*lo, lo*hi, hi*hi, each whole sum in one fresh
accumulator), with an exact one-pass softmax in registers between them.
None of that runs here, so these tests hold a numpy emulation of it, lane
by lane, to the contract, and import no kernel:

- the emulation reads the swizzled boxes at the kernel's offsets into the
  kernel's registers, forms each MMA from the PTX fragment maps of
  m16n8k8 (A row-major 16 x 8, B column-major 8 x 8, the accumulators),
  the MMA reading its operands' top 10 mantissa bits and rounding (or
  truncating) each step's sum, takes the softmax in log2 units as the
  kernel does and writes each lane's output where the kernel stores it;
  it is held within ``ATTN_F32_TOL`` of the JAX package's kernel (run in
  interpret mode, as its own CPU tests run it) and of the port's plain
  version, at the encoder's widths (B 2-4, S 64 and 24, H 4, D 32) and at
  the edges the kernel takes (GQA, ragged tiles, one key, one row, rows
  with no allowed key);
- every 16-byte shared-memory read of a quarter warp touches each bank
  group once under the swizzle;
- the ring's barrier phases: under any interleaving of the producer and
  the consumer warps, each consumer reads the item the producer put in
  the stage, and no stage is refilled before every warp released it;
- ``ops.kernel_name`` (which kernel a launch runs) and the constants the
  wrapper and these tests share with the kernel source.
Inputs are made with numpy from a seed.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jflash
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "csrc" / "flash_attention.cu")
# the kernel's, pinned to its source by test_tile_constants_match_the_kernel
STAGES = 4               # kRStages: ring stages
WARP_ROWS = 16           # kRWarpRows: query rows a consumer warp
WARPS = 4                # kRWarps: consumer warps a block
ROWS = WARPS * WARP_ROWS  # query rows a work item
DIM = 32                 # kRDim = ops.TC_HEAD_DIM
ATTN_F32_TOL = dict(rtol=1e-5, atol=2e-5)   # the reference's own
LANE = np.arange(32)
G, T = LANE >> 2, LANE & 3                  # mma.sync's groupID, threadID


def _constants():
    return {name: int(v) for name, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", SOURCE.read_text())}


def test_tile_constants_match_the_kernel():
    c = _constants()
    assert (c["kRStages"], c["kRWarpRows"], c["kRWarps"]) == (
        STAGES, WARP_ROWS, WARPS)
    assert (c["kRDim"], c["kRMaxKeys"]) == (ops.TC_HEAD_DIM,
                                            ops.TC_MAX_KEYS) == (DIM, 64)
    assert c["kRDim"] * 4 == 128        # one row: SWIZZLE_128B's span
    assert c["kShortMax"] == 128        # kernel_name's short-row limit
    cases = re.findall(r"case (\d+): return launch_d<T, \1>",
                       SOURCE.read_text())
    assert tuple(map(int, cases)) == ops.HEAD_DIMS
    assert ops.TC_HEAD_DIM in ops.HEAD_DIMS


# ---- the TF32 split and the MMA ---------------------------------------------

def tf32_round(x):
    """TF32 rounding to nearest, ties away: the kernel's tf32_split."""
    b = np.asarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_read(x):
    """What the MMA reads of an f32 register: its top 10 mantissa bits."""
    b = np.asarray(x, np.float32).view(np.uint32)
    return (b & np.uint32(0xFFFFE000)).view(np.float32)


def split2(x):
    """tf32_split<2>: hi = x rounded to TF32, lo = x - hi (f32)."""
    x = np.asarray(x, np.float32)
    hi = tf32_round(x)
    return hi, (x - hi).astype(np.float32)


def _round_f32(s64, rounding):
    f = s64.astype(np.float32)
    if rounding == "zero":              # toward zero, as the MMA may
        over = np.abs(f.astype(np.float64)) > np.abs(s64)
        f[over] = np.nextafter(f[over], np.float32(0))
    return f


def mma(c, a, b0, b1, rounding):
    """mma.sync.m16n8k8 TF32 for a batch of warps: c [W, 32, 4], a [W, 32,
    4], b0, b1 [W, 32] as lanes hold them (PTX's fragment maps: a0 (g, t),
    a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); b0 (k t, n g), b1
    (k t + 4, n g); c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8,
    2t + 1)). Products exact, each step's sum rounded once."""
    w = c.shape[0]
    A = np.zeros((w, 16, 8))
    B = np.zeros((w, 8, 8))
    C = np.zeros((w, 16, 8))
    a = tf32_read(a).astype(np.float64)
    A[:, G, T], A[:, G + 8, T] = a[..., 0], a[..., 1]
    A[:, G, T + 4], A[:, G + 8, T + 4] = a[..., 2], a[..., 3]
    B[:, T, G] = tf32_read(b0)
    B[:, T + 4, G] = tf32_read(b1)
    C[:, G, 2 * T], C[:, G, 2 * T + 1] = c[..., 0], c[..., 1]
    C[:, G + 8, 2 * T], C[:, G + 8, 2 * T + 1] = c[..., 2], c[..., 3]
    D = _round_f32(C + A @ B, rounding)
    return np.stack([D[:, G, 2 * T], D[:, G, 2 * T + 1], D[:, G + 8, 2 * T],
                     D[:, G + 8, 2 * T + 1]], -1)


# ---- the kernel, lane by lane -----------------------------------------------

def sw128(r, c):
    """The kernel's sw128: float offset of 16-byte chunk c of row r."""
    return r * DIM + ((c ^ (r & 7)) << 2)


def tma_box(x, rows, b, h, s0, n):
    """What cp.async.bulk.tensor lands for a box of `n` rows of head h of
    batch row b from row s0 of x (B, S, H, 32), zeros past S, in the
    SWIZZLE_128B layout: chunk c of row r at chunk c ^ (r % 8)."""
    box = np.zeros((n, DIM), np.float32)
    take = x[b, s0:min(s0 + n, rows), h]
    box[:len(take)] = take
    img = np.zeros((n, 8, 4), np.float32)
    r = np.arange(n)[:, None]
    c = np.arange(8)[None, :]
    img[r, c ^ (r & 7)] = box.reshape(n, 8, 4)[r, c]
    return img.reshape(-1)


def lds128(img, off):
    """Each lane's 16-byte read at float offset off [W, 32] of img [W, F]."""
    return img[np.arange(len(img))[:, None, None], off[..., None]
               + np.arange(4)]


def emulate_short_tc(q, k, v, *, causal, window, rounding="nearest"):
    """flash_short_tc's output for f32 q (B, Sq, H, 32), k/v (B, Skv, Hkv,
    32), 1 <= Skv <= 64: every (batch row, head, 64-row tile, consumer
    warp) at once."""
    b, sq, h, _ = q.shape
    skv, grp = k.shape[1], h // k.shape[2]
    nt = 4 if skv <= 32 else 8          # n-tiles of 8 keys
    n_qt = -(-sq // ROWS)
    tiles = [(bi, hi, qt, w) for bi in range(b) for hi in range(h)
             for qt in range(n_qt) for w in range(WARPS)]
    qimg = np.stack([tma_box(q, sq, bi, hi, qt * ROWS, ROWS)
                     for bi, hi, qt, w in tiles])
    kimg = np.stack([tma_box(k, skv, bi, hi // grp, 0, 8 * nt)
                     for bi, hi, qt, w in tiles])
    vimg = np.stack([tma_box(v, skv, bi, hi // grp, 0, 8 * nt)
                     for bi, hi, qt, w in tiles])
    warp = np.array([w for *_, w in tiles])[:, None]
    r0 = np.array([qt * ROWS + w * WARP_ROWS for _, _, qt, w in tiles])
    nw = len(tiles)

    # Q: floats 8t..8t+7 of rows g (0-7) and g + 8 (8-15)
    qv = np.concatenate([lds128(qimg, warp * WARP_ROWS * DIM
                                + sw128(G + 8 * rr, 2 * T + c))
                         for rr in (0, 1) for c in (0, 1)], -1)
    qh, ql = split2(qv)

    sc = [np.zeros((nw, 32, 4), np.float32) for _ in range(nt)]
    for j0 in range(0, nt, 4):
        kv = [np.concatenate([lds128(kimg, np.broadcast_to(
            sw128(8 * (j0 + jj) + G, 2 * T + c), (nw, 32))) for c in (0, 1)],
            -1) for jj in range(4)]
        kh, kl = zip(*map(split2, kv))
        for kk in range(DIM // 8):
            pick = [2 * kk, 8 + 2 * kk, 2 * kk + 1, 9 + 2 * kk]
            ah, al = qh[..., pick], ql[..., pick]
            for a, bs in ((ah, kl), (al, kh), (ah, kh)):
                for jj in range(4):
                    sc[j0 + jj] = mma(sc[j0 + jj], a, bs[jj][..., 2 * kk],
                                      bs[jj][..., 2 * kk + 1], rounding)

    # softmax in log2 units
    log2_scale = np.float32(np.float32(1 / np.sqrt(DIM))
                            * np.float32(1.4426950408889634))
    mx = np.full((nw, 32, 2), -1e30, np.float32)
    for j in range(nt):
        for e in range(4):
            i = r0[:, None] + G + 8 * (e >> 1)
            key = 8 * j + 2 * T + (e & 1)
            x = (sc[j][..., e] * log2_scale).astype(np.float32)
            if causal or window is not None:
                ok = np.ones_like(x, bool)
                if causal:
                    ok &= key <= i
                if window is not None:
                    ok &= key > i - window
                x = np.where(ok, x, np.float32(-1e30))
            x = np.where(key >= skv, np.float32(-np.inf), x)
            sc[j][..., e] = x
            mx[..., e >> 1] = np.maximum(mx[..., e >> 1], x)
    for off in (1, 2):                  # the row's 4 lanes
        mx = np.maximum(mx, mx[:, LANE ^ off])
    l = np.zeros((nw, 32, 2), np.float32)
    for j in range(nt):
        for e in range(4):
            sc[j][..., e] = np.exp2(sc[j][..., e] - mx[..., e >> 1])
            l[..., e >> 1] += sc[j][..., e]

    # O = P V: n-tile n's column c is d 4c + n
    o = [np.zeros((nw, 32, 4), np.float32) for _ in range(4)]
    for kk in range(nt):
        ph, pl = split2(sc[kk][..., [0, 2, 1, 3]])
        vv = [lds128(vimg, np.broadcast_to(sw128(8 * kk + 2 * T + u, G),
                                           (nw, 32))) for u in (0, 1)]
        (vh0, vl0), (vh1, vl1) = split2(vv[0]), split2(vv[1])
        for a, b0, b1 in ((ph, vl0, vl1), (pl, vh0, vh1), (ph, vh0, vh1)):
            for nn in range(4):
                o[nn] = mma(o[nn], a, b0[..., nn], b1[..., nn], rounding)

    out = np.full(q.shape, np.nan, np.float32)
    for off in (1, 2):
        l = (l + l[:, LANE ^ off]).astype(np.float32)
    inv = (np.float32(1) / np.maximum(l, np.float32(1e-30))).astype(
        np.float32)
    for x, (bi, hi, _, _) in enumerate(tiles):
        for rr in (0, 1):
            rows = r0[x] + G + 8 * rr
            for lane in np.flatnonzero(rows < sq):
                d = 8 * T[lane] + np.arange(4)
                vals = [o[nn][x, lane, 2 * rr + u] * inv[x, lane, rr]
                        for u in (0, 1) for nn in range(4)]
                out[bi, rows[lane], hi, np.concatenate([d, d + 4])] = vals
    return out


def _inputs(b, sq, skv, h, hkv, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return tuple((rng.standard_normal(s) * scale).astype(np.float32)
                 for s in ((b, sq, h, DIM), (b, skv, hkv, DIM),
                           (b, skv, hkv, DIM)))


def _plain(q, k, v, causal, window):
    return flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                               causal=causal, window=window).numpy()


@pytest.mark.parametrize("b,sq,skv,h,hkv,causal,window", [
    (4, 64, 64, 4, 4, False, None),     # the encoder's passages
    (4, 24, 24, 4, 4, False, None),     # and queries
    (2, 64, 64, 4, 2, True, None),      # GQA group 2, causal
    (2, 70, 40, 4, 4, True, 16),        # two query tiles, a window
    (3, 1, 1, 2, 1, False, None),       # one row, one key
    (2, 40, 33, 4, 1, True, 0)])        # no row has an allowed key
@pytest.mark.parametrize("rounding", ["nearest", "zero"])
def test_emulation_matches_the_references(b, sq, skv, h, hkv, causal, window,
                                          rounding):
    """The kernel's arithmetic, as its lanes do it, within the reference's
    own kernel tolerance of the JAX package's kernel and of the port's
    plain version, whether the tensor cores round or truncate."""
    q, k, v = _inputs(b, sq, skv, h, hkv, seed=sq * 100 + skv)
    got = emulate_short_tc(q, k, v, causal=causal, window=window,
                           rounding=rounding)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _plain(q, k, v, causal, window),
                               **ATTN_F32_TOL)
    if rounding == "nearest":
        want = np.asarray(jflash(*map(jnp.asarray, (q, k, v)), causal=causal,
                                 window=window))
        np.testing.assert_allclose(got, want, **ATTN_F32_TOL)


def _excess(got, want):
    """The largest |got - want| in units of ATTN_F32_TOL's allowance."""
    return float(np.max(np.abs(got - want) / (ATTN_F32_TOL["atol"]
                                              + ATTN_F32_TOL["rtol"]
                                              * np.abs(want))))


@pytest.mark.parametrize("rounding", ["nearest", "zero"])
def test_emulation_at_other_magnitudes(rounding):
    """Tiny inputs (scores all near 0) stay within tolerance of the plain
    version. Large ones (entries of 8: logits far apart) are where f32
    itself misses that tolerance, the plain version too: held to an f64
    evaluation, the kernel's error is of the plain version's size (within
    twice it; the truncating sums make it larger than the plain version's
    in some draws, smaller in others)."""
    q, k, v = _inputs(2, 64, 64, 4, 4, seed=5, scale=2.0 ** -60)
    got = emulate_short_tc(q, k, v, causal=False, window=None,
                           rounding=rounding)
    np.testing.assert_allclose(got, _plain(q, k, v, False, None),
                               **ATTN_F32_TOL)
    q, k, v = _inputs(2, 64, 64, 4, 4, seed=5, scale=8.0)
    exact = _plain(*(x.astype(np.float64) for x in (q, k, v)), False, None)
    plain = _excess(_plain(q, k, v, False, None), exact)
    got = emulate_short_tc(q, k, v, causal=False, window=None,
                           rounding=rounding)
    assert plain > 1 and _excess(got, exact) <= 2 * plain


# ---- shared-memory banks and the ring ------------------------------------

@pytest.mark.parametrize("what", ["q", "k", "v"])
def test_reads_are_free_of_bank_conflicts(what):
    """Each 16-byte read is served a quarter warp at a time; under the
    swizzle the 8 lanes of a quarter hit 8 different 16-byte bank groups
    (banks 4c..4c+3 for chunk c of a 128-byte row)."""
    if what == "q":
        offs = [sw128(G + 8 * rr, 2 * T + c) for rr in (0, 1)
                for c in (0, 1)]
    elif what == "k":
        offs = [sw128(8 * j + G, 2 * T + c) for j in range(8)
                for c in (0, 1)]
    else:
        offs = [sw128(8 * kk + 2 * T + u, G) for kk in range(8)
                for u in (0, 1)]
    for off in offs:
        group = (off // 4) % 8
        for quarter in range(4):
            assert len(set(group[8 * quarter:8 * quarter + 8])) == 8


@pytest.mark.parametrize("items,seed", [(1, 0), (4, 1), (9, 2), (31, 3)])
def test_ring_phases_hand_each_item_over_once(items, seed):
    """The kernel's waits (the producer on empty(s) with parity (n / STAGES
    - 1) & 1 from its (STAGES + 1)-th item, each consumer warp on full(s)
    with parity (n / STAGES) & 1) under random interleavings: every read
    finds the item it expects, and a stage is refilled only after all
    WARPS warps released it. A wait on parity P passes when the barrier's
    completed phases c have c % 2 != P."""
    rng = np.random.default_rng(seed)
    full = np.zeros(STAGES, int)        # completed phases
    empty = np.zeros(STAGES, int)
    arrivals = np.zeros(STAGES, int)
    slot = [None] * STAGES
    produced, consumed = 0, [0] * WARPS
    released = [0] * WARPS
    while produced < items or min(released) < items:
        actor = rng.integers(WARPS + 1)
        if actor == WARPS:                              # producer
            n = produced
            if n >= items:
                continue
            s = n % STAGES
            if n >= STAGES and empty[s] % 2 == (n // STAGES - 1) & 1:
                continue                                # still waiting
            assert slot[s] is None or slot[s][1] == WARPS
            slot[s] = [n, 0]
            full[s] += 1                                # TMA bytes landed
            produced += 1
        else:
            wp = actor
            n = consumed[wp]
            if n < items and released[wp] == n:
                s = n % STAGES
                if full[s] % 2 == (n // STAGES) & 1:
                    continue                            # still waiting
                assert slot[s][0] == n
                consumed[wp] += 1
            elif released[wp] < consumed[wp]:
                n = released[wp]
                s = n % STAGES
                slot[s][1] += 1
                arrivals[s] += 1
                if arrivals[s] == WARPS:
                    arrivals[s] = 0
                    empty[s] += 1
                released[wp] += 1
    assert consumed == [items] * WARPS


# ---- the route ----------------------------------------------------------

def test_kernel_name_follows_the_dispatch():
    """Which kernel a launch runs, read off its operands as launch_d
    reads them: f32 at D 32 with 1..64 keys, 16-byte rows and positive
    strides take flash_short_tc; everything else its earlier kernel."""
    def qkv(b, sq, skv, h, hkv, d, dtype=torch.float32):
        return (torch.zeros(b, sq, h, d, dtype=dtype),
                torch.zeros(b, skv, hkv, d, dtype=dtype),
                torch.zeros(b, skv, hkv, d, dtype=dtype))
    name = ops.kernel_name
    assert name(*qkv(256, 64, 64, 4, 4, 32)) == "flash_short_tc"
    assert name(*qkv(256, 24, 24, 4, 4, 32)) == "flash_short_tc"
    assert name(*qkv(2, 100, 1, 8, 1, 32)) == "flash_short_tc"
    assert name(*qkv(2, 64, 64, 4, 4, 32, torch.bfloat16)) == "flash_short"
    assert name(*qkv(2, 64, 64, 4, 4, 64)) == "flash_short"
    assert name(*qkv(2, 65, 65, 4, 4, 32)) == "flash_short"
    assert name(*qkv(2, 5, 0, 4, 4, 32)) == "flash_short"
    assert name(*qkv(1, 300, 300, 4, 2, 32)) == "flash_long"
    assert name(*qkv(1, 300, 300, 4, 2, 32, torch.bfloat16)) == \
        "flash_long_tc"
    # (B, H, S, D) storage read as (B, S, H, D): strides TMA describes
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
               for t in qkv(2, 50, 50, 4, 2, 32))
    assert name(q, k, v) == "flash_short_tc"
    # a row of 32 floats one float into a wider one: not 16-byte aligned
    wide = torch.zeros(2, 50, 4, 36)
    q = wide[..., 1:33]
    k = v = wide[:, :, :2, 1:33]
    assert name(q, k, v) == "flash_short"
    # a broadcast batch (stride 0): not a tensor map
    q, k, v = qkv(1, 64, 64, 4, 4, 32)
    assert name(q.expand(3, -1, -1, -1), k.expand(3, -1, -1, -1),
                v.expand(3, -1, -1, -1)) == "flash_short"
