"""The arithmetic of two CUDA kernels, emulated in plain torch on the CPU,
against the plain versions and the JAX package.

The kernels run only on the card, so these tests hold step-by-step
emulations of what they compute to the contract, and pin the constants a
wrapper shares with a kernel:

- ``csrc/hamming_topk.cu``, a counting select: per-(query, split)
  histograms of the distances over the wrapper's split plan; a threshold
  t (the first distance with count(<= t) >= k) found 32 bins at a time
  as the kernel's warp scans them, with each (split, bin)'s start slot;
  then the rows at distance <= t collected in 32-row chunks in id order,
  each at its bin's start plus its rank among the chunk's lanes of that
  distance, written only below k. The result equals ``hamming_topk_ref``
  and the JAX wrapper (its Pallas kernel in interpret mode where k <= 32)
  exactly: distances are integers.
- ``csrc/lp_round.cu``: each candidate slot's score summed over the valid
  slots only, in slot order, with -1 anywhere in a row; the argmax by an
  order-preserving int key of the f32 score, then the smallest label. It
  equals ``ell_round`` and the JAX reference bit for bit.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import label_prop as jlp
from repro.kernels.lsh_hamming.ops import hamming_topk as jhamming
from repro_torch.core.label_prop import ell_round
from repro_torch.kernels.lsh_hamming import ops as hops
from repro_torch.kernels.lsh_hamming.ref import _neg_hamming, hamming_topk_ref
from repro_torch.kernels.topk_scoring.ops import split_plan
from repro_torch.kernels.topk_scoring.ref import pad_topk

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


def _constants(source):
    return {name: int(v) for name, v in re.findall(
        r"constexpr int (k\w+) = (\d+)", (CSRC / source).read_text())}


def test_tile_constants_match_the_kernel():
    """The wrapper plans splits in the Hamming kernel's tiles, and the
    emulation walks its warps' queries: each constant equals the
    source's."""
    c = _constants("hamming_topk.cu")
    assert (c["kHQ"], c["kHN"]) == (hops.HAMMING_QUERIES, hops.HAMMING_ROWS)
    assert c["kHQ"] == c["kHQW"] * c["kHThreads"] // 32
    assert c["kHN"] == 4 * 32            # lane l holds rows 32j + l, j < 4
    assert c["kStoreWords"] == hops.STORE_WORDS
    assert hops.hamming_bins(hops.STORE_WORDS) <= 256 \
        < hops.hamming_bins(hops.STORE_WORDS + 1)  # a distance fits a byte
    lp = _constants("lp_round.cu")
    assert lp["kNodes"] <= 32            # lane i < kNodes holds a node's label


# -- Hamming: count -> threshold -> ordered collect ----------------------------

def _threshold(hist, k):
    """The threshold kernel: for one query's hist [splits, bins], t and the
    start slot of every (split, bin) up to t's chunk of 32 bins."""
    n_splits, bins = hist.shape
    start = torch.full_like(hist, -1)
    below, t = 0, -1
    for b0 in range(0, bins, 32):
        tot = hist[:, b0:b0 + 32].sum(0)
        incl = torch.cumsum(tot, 0)
        excl = below + incl - tot
        start[:, b0:b0 + 32] = excl + torch.cumsum(hist[:, b0:b0 + 32], 0) \
            - hist[:, b0:b0 + 32]
        hit = torch.nonzero(below + incl >= k).flatten()
        if hit.numel():
            t = b0 + int(hit[0])
            break
        below += int(incl[-1])
    return t, start


def emulate_hamming(q_codes, c_codes, k):
    """What ``hamming_topk_cuda`` computes, 1 <= k <= N, step by step."""
    nq, w = q_codes.shape
    n = c_codes.shape[0]
    per_split, n_splits = split_plan(nq, n, hops.HAMMING_QUERIES,
                                     hops.HAMMING_ROWS, hops.HAMMING_BLOCKS)
    bins = hops.hamming_bins(w)
    dist = (-_neg_hamming(q_codes, c_codes)).to(torch.int64)
    span = per_split * hops.HAMMING_ROWS           # rows a split walks
    split_of = torch.arange(n) // span
    # count: hist [query, split, bin]
    hist = torch.zeros((nq, n_splits, bins), dtype=torch.int64)
    qi = torch.arange(nq)[:, None].expand(nq, n)
    hist.index_put_((qi, split_of[None, :].expand(nq, n), dist),
                    torch.ones(nq, n, dtype=torch.int64), accumulate=True)
    out_s = torch.full((nq, k), float("nan"))
    out_i = torch.full((nq, k), -2, dtype=torch.int32)
    for q in range(nq):
        t, start = _threshold(hist[q], k)
        assert t >= 0
        for s in range(n_splits):
            cur = start[s].clone()
            for c0 in range(s * span, min(n, (s + 1) * span), 32):
                ids = torch.arange(c0, min(c0 + 32, n))
                d = dist[q, ids]
                keep = d <= t
                for dv in torch.unique(d[keep]).tolist():
                    grp = ids[keep & (d == dv)]          # lane order
                    slot = cur[dv] + torch.arange(grp.numel())
                    ok = slot < k
                    out_s[q, slot[ok]] = -float(dv)
                    out_i[q, slot[ok]] = grp[ok].to(torch.int32)
                    cur[dv] += grp.numel()
    assert not bool(torch.isnan(out_s).any())      # every slot written
    return out_s, out_i


def _codes(q, n, w, seed, kind):
    rng = np.random.default_rng(seed)
    if kind == "random":
        cc = rng.integers(-2 ** 31, 2 ** 31, (n, w), dtype=np.int64)
        cc[n // 2:] = cc[:n - n // 2]           # duplicate rows besides
    elif kind == "equal":
        cc = np.full((n, w), 77, dtype=np.int64)
    else:                                       # few live bits: heavy ties
        cc = rng.integers(0, 8, (n, w)) << 3
    qc = rng.integers(-2 ** 31, 2 ** 31, (q, w), dtype=np.int64)
    if kind != "random":
        qc = cc[rng.integers(0, n, q)].copy()
        qc[::2, 0] ^= 1
    return (torch.from_numpy(qc.astype(np.int32)),
            torch.from_numpy(cc.astype(np.int32)))


@pytest.mark.parametrize("w", [1, 3, 4, 8])
@pytest.mark.parametrize("q,n,k", [(5, 300, 1), (33, 300, 64), (3, 300, 300),
                                   (2, 700, 701), (40, 2000, 64)])
@pytest.mark.parametrize("kind", ["random", "equal", "ties"])
def test_hamming_select_emulation_matches_plain(w, q, n, k, kind):
    qc, cc = _codes(q, n, w, q * n + w + k, kind)
    k_eff = min(k, n)
    got = pad_topk(*emulate_hamming(qc, cc, k_eff), k)
    want = pad_topk(*hamming_topk_ref(qc, cc, k=k_eff, block=128), k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    js, ji = jhamming(jnp.asarray(qc.numpy()), jnp.asarray(cc.numpy()), k=k)
    assert np.array_equal(got[0].numpy(), np.asarray(js))
    assert np.array_equal(got[1].numpy(), np.asarray(ji))


def test_hamming_threshold_and_starts():
    """Hand-made histogram of 2 splits and 40 bins (two chunks of 32): the
    start of each (split, bin) is the rows below the bin plus the same
    bin's rows in earlier splits; t is the first bin reaching k."""
    hist = torch.zeros((2, 40), dtype=torch.int64)
    hist[0, 3], hist[1, 3] = 2, 1
    hist[0, 35], hist[1, 35], hist[1, 36] = 4, 5, 7
    t, start = _threshold(hist, 3)
    assert t == 3 and start[0, 3] == 0 and start[1, 3] == 2
    t, start = _threshold(hist, 4)
    assert t == 35
    assert start[0, 35] == 3 and start[1, 35] == 7 and start[0, 36] == 12
    t, _ = _threshold(hist, 19)
    assert t == 36


def test_hamming_split_plan_walks_every_row_once():
    for nq, n in [(1, 1), (33, 300), (512, 524_288), (256, 39_780),
                  (4099, 3000)]:
        per_split, n_splits = split_plan(nq, n, hops.HAMMING_QUERIES,
                                         hops.HAMMING_ROWS,
                                         hops.HAMMING_BLOCKS)
        span = per_split * hops.HAMMING_ROWS
        assert (n_splits - 1) * span < n <= n_splits * span


# -- LP: the valid-slot loop ---------------------------------------------------

def _order_key(x):
    """The kernel's int key of an f32 score: order-preserving, -0.0 aside."""
    b = x.view(torch.int32)
    return b ^ ((b >> 31) & 0x7FFFFFFF)


def emulate_lp_round(labels, nbr, wgt):
    """What ``lp_round`` computes: per candidate slot j the f32 sum over
    the valid slots k only, in slot order, then the argmax by int key and
    the smallest label among the maxima; no neighbour keeps its label."""
    n, kk = nbr.shape
    if kk == 0:
        return labels.clone()
    valid = nbr >= 0
    lab = torch.where(valid, labels[nbr.clamp(min=0).long()], -1)
    acc = torch.zeros((n, kk), dtype=torch.float32)
    for k in range(kk):
        term = torch.where(lab == lab[:, k:k + 1], wgt[:, k:k + 1], 0.0)
        acc = torch.where(valid[:, k:k + 1], acc + term, acc)   # skip pads
    key = torch.where(valid, _order_key(acc), torch.iinfo(torch.int32).min)
    top = key.amax(dim=1, keepdim=True)
    cand = torch.where(valid & (key == top), lab,
                       torch.iinfo(torch.int32).max)
    best = cand.amin(dim=1)
    return torch.where(valid.any(dim=1), best, labels).to(torch.int32)


def _ell(n, k, seed, *, quarter, scatter):
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, k + 1, n)
    deg[rng.random(n) < 0.3] = 0
    nbr = rng.integers(0, n, (n, k)).astype(np.int32)
    nbr[np.arange(k)[None, :] >= deg[:, None]] = -1
    wgt = (rng.integers(1, 8, (n, k)) * 0.25 if quarter
           else rng.random((n, k))).astype(np.float32)
    wgt[nbr < 0] = 0.0
    if scatter:
        perm = np.argsort(rng.random((n, k)), axis=1)
        nbr = np.take_along_axis(nbr, perm, axis=1)
        wgt = np.take_along_axis(wgt, perm, axis=1)
    labels = rng.integers(0, max(n // 5, 1), n).astype(np.int32)
    return labels, nbr, wgt


@pytest.mark.parametrize("n,k", [(1, 1), (37, 5), (300, 32), (200, 33),
                                 (150, 70), (64, 0)])
@pytest.mark.parametrize("quarter", [True, False])
@pytest.mark.parametrize("scatter", [False, True])
def test_lp_valid_slot_emulation_bit_equal(n, k, quarter, scatter):
    labels, nbr, wgt = _ell(n, k, n * 3 + k, quarter=quarter,
                            scatter=scatter)
    lt, nt, wt = (torch.from_numpy(x) for x in (labels, nbr, wgt))
    got = emulate_lp_round(lt, nt, wt)
    assert torch.equal(got, ell_round(lt, nt, wt))
    if k:
        want = jlp.ell_round(jnp.asarray(labels), jnp.asarray(nbr),
                             jnp.asarray(wgt))
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_lp_order_key_orders_f32():
    x = torch.tensor([-3.5, -1.0, -1e-30, 0.0, 1e-30, 0.25, 1.0, 7.0,
                      float("inf")], dtype=torch.float32)
    assert bool((torch.diff(_order_key(x).long()) > 0).all())
