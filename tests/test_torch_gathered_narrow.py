"""The gathered top-k for few queries and the merge's segment plan, on the
CPU.

On the card, ``gathered_topk`` with Q at or below
``GATHERED_NARROW_QUERIES`` launches ``gathered_runs`` (a block a query's
run of ``RUN_SLOTS`` consecutive slots: its valid rows scored with f32
FMAs, its top min(k, RUN_SLOTS) (score, position) list written to fixed
columns of a (Q, runs x kk) buffer) and then ``topk_merge`` with the
query's ``cand_ids``, which maps the winning positions to ids. The merge
cuts each row into segments over the card (``merge_plan``), a warp each,
and the row's last segment merges their lists. Neither kernel runs here:
these tests hold the plain versions (``gathered_runs_plain``, then
``merge_plain``) to ``gathered_topk_ref`` and to the JAX package's jnp
``gathered_topk``, an emulation of the merge's two levels to
``merge_plain``, the plan to its contract, and the constants to the
kernel source. Vectors are small integers, so every score is exact and
ids must match exactly, ties to the earlier position included.
"""
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.retrieval.backends import get_backend as jget_backend
from repro_torch.core import prng
from repro_torch.kernels.topk_scoring import ops
from repro_torch.kernels.topk_scoring.ref import gathered_topk_ref, pad_topk
from repro_torch.retrieval.ivfflat import build_ivfflat, probe_candidates

CUTOFF, RUN = ops.GATHERED_NARROW_QUERIES, ops.RUN_SLOTS
SRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
       / "topk_scores.cu").read_text()


def _inputs(kind: str, q: int, seed: int):
    """(queries f32[Q, D], table f32[R, D], cand_rows i32[Q, C], cand_ids
    i32[Q, C]) of small integers. Query 0 has no valid slot; C is not a
    multiple of RUN_SLOTS; the second run of every query has no valid
    slot; a quarter of the rest are invalid."""
    rng = np.random.default_rng(seed)
    d = 5
    if kind == "ivfflat":                   # a real index and its probe
        vecs = torch.from_numpy(
            rng.integers(-3, 4, (900, d)).astype(np.float32))
        index = build_ivfflat(prng.prng_key(seed), vecs, n_lists=6)
        qs = torch.from_numpy(rng.integers(-3, 4, (q, d)).astype(np.float32))
        rows, ids = probe_candidates(index, qs, nprobe=3)
        ids = ids.clone()
        ids[0] = -1
        return qs, index.vecs.reshape(-1, d), rows, ids
    c, r = 3 * RUN + 37, 1000
    if kind == "repeats":                   # each row at two positions
        rows = np.repeat(rng.integers(0, r, (q, -(-c // 2))), 2, axis=1)
        rows = rows[:, :c]
    else:                                   # runs of consecutive rows
        rows = rng.integers(0, r - c, (q, 1)) + np.arange(c)[None, :]
    ids = rng.integers(0, 10 ** 6, (q, c))
    ids[rng.random((q, c)) < 0.25] = -1
    ids[:, RUN:2 * RUN] = -1
    ids[0] = -1
    qs = rng.integers(-3, 4, (q, d)).astype(np.float32)
    if kind == "zeros":                     # a padded bucket: every score 0
        qs[:] = 0.0
    table = rng.integers(-3, 4, (r, d)).astype(np.float32)
    return (torch.from_numpy(qs), torch.from_numpy(table),
            torch.from_numpy(rows.astype(np.int32)),
            torch.from_numpy(ids.astype(np.int32)))


def _plain_path(qs, table, rows, ids, k):
    part_s, part_p = ops.gathered_runs_plain(qs, table, rows, ids, k)
    assert part_s.shape == (qs.shape[0], ops.runs_width(ids.shape[1], k))
    return ops.merge_plain(part_s, part_p, k, cand_ids=ids)


@pytest.mark.parametrize("kind,q", [
    ("runs", 1), ("runs", 2), ("runs", 3), ("runs", CUTOFF),
    ("runs", CUTOFF + 1), ("repeats", 3), ("zeros", 2), ("ivfflat", 1),
    ("ivfflat", CUTOFF)])
def test_runs_then_merge_equal_the_references(kind, q):
    """k of 1, 3 and 16, above RUN_SLOTS and above a query's valid count:
    the runs' lists merged through cand_ids equal the plain version and
    the JAX package's jnp ``gathered_topk`` (on ``table[rows]``), misses
    as -inf / -1, ties to the earlier position."""
    qs, table, rows, ids = _inputs(kind, q, seed=q + len(kind))
    c = ids.shape[1]
    valid = int((ids >= 0).sum(1).max())
    for k in (1, 3, 16, RUN + 5, valid + 3):
        s, i = _plain_path(qs, table, rows, ids, k)
        want = pad_topk(*gathered_topk_ref(qs, table, rows, ids,
                                           k=min(k, c)), k)
        assert torch.equal(s, want[0]) and torch.equal(i, want[1]), k
    assert bool((i[0] == -1).all()) and bool(torch.isneginf(s[0]).all())
    k = 16
    s, i = _plain_path(qs, table, rows, ids, k)
    cand_vecs = table[rows.clamp(min=0).long()]
    js, ji = jget_backend("jnp").gathered_topk(
        jnp.asarray(qs.numpy()), jnp.asarray(cand_vecs.numpy()),
        jnp.asarray(ids.numpy()), k=k)
    assert np.array_equal(s.numpy(), np.asarray(js))
    assert np.array_equal(i.numpy(), np.asarray(ji))


def test_runs_lists_are_per_run():
    """Each run's list holds its own slots only, best first by (score,
    position), padded with (-inf, -1): a run with no valid slot is all
    padding, and an earlier position wins a tie."""
    qs, table, rows, ids = _inputs("zeros", 2, seed=3)
    k = 4
    part_s, part_p = ops.gathered_runs_plain(qs, table, rows, ids, k)
    lists_p = part_p.view(2, -1, k)
    assert bool((lists_p[:, 1] == -1).all())            # the empty run
    assert bool(torch.isneginf(part_s.view(2, -1, k)[:, 1]).all())
    for j in range(lists_p.shape[1]):
        got = lists_p[1, j]
        slots = torch.arange(j * RUN, min((j + 1) * RUN, ids.shape[1]))
        want = slots[ids[1, slots] >= 0][:k]           # all tie at 0
        assert got[:len(want)].tolist() == want.tolist()
        assert bool((got[len(want):] == -1).all())


def test_stray_row_raises_on_the_plain_runs():
    """A valid slot whose row lies outside the table raises the wrapper's
    error; an invalid slot's row is never read."""
    qs = torch.ones(1, 3)
    table = torch.ones(9, 3)
    rows = torch.tensor([[0, 1, 9]], dtype=torch.int32)
    with pytest.raises(ValueError, match="outside the table's 9 rows"):
        ops.gathered_runs_plain(qs, table, rows,
                                torch.tensor([[4, -1, 2]], dtype=torch.int32),
                                2)
    s, p = ops.gathered_runs_plain(
        qs, table, rows, torch.tensor([[4, 5, -1]], dtype=torch.int32), 2)
    assert p.tolist() == [[0, 1]] and s.tolist() == [[3.0, 3.0]]


WIDTHS = sorted({1, 2, 31, 32, 127, 128, 129, 255, 256, 257, 258, 385,
                 1000, 1280, 4096, 4097, 16672, 32784, 65536, 100_003,
                 2 ** 20 - 1, 2 ** 20})


@pytest.mark.parametrize("nq", [1, 2, 7, 32, 128, 129, 1024])
def test_merge_plan_covers_every_entry_once(nq):
    """For widths from 1 to 2**20 and k from 1 to past the width: the
    segments [sg seg, min((sg + 1) seg, width)) tile each row's entries
    exactly once, none empty; a row is cut only where k < seg (so the
    second level merges fewer entries than a row holds) and then at
    multiples of 32 MERGE_VEC (each lane's loads whole); the cut aims
    at MERGE_TARGET warps and never past it by more than a segment a row;
    the scratch fits int32 offsets."""
    for width in WIDTHS:
        for k in (1, 3, 10, 16, 100, 1000, width - 2, width - 1, width,
                  width + 7):
            if k < 1:
                continue
            seg, n_seg = ops.merge_plan(nq, width, k)
            assert n_seg >= 1 and seg >= 1
            starts = [sg * seg for sg in range(n_seg)]
            ends = [min(s + seg, width) for s in starts]
            covered = sum(e - s for s, e in zip(starts, ends))
            assert covered == width and starts[0] == 0
            assert all(s < e for s, e in zip(starts, ends)) or width == 0
            assert ends[-1] == width or (width == 0 and seg == 1)
            if n_seg > 1:
                assert k < seg and seg % (32 * ops.MERGE_VEC) == 0
                assert seg >= ops.MERGE_MIN_SEG
                assert seg >= math.isqrt(width * k)
                assert nq * (n_seg - 1) < max(ops.MERGE_TARGET, nq)
                assert 2 * nq * n_seg * k + nq < 2 ** 31


def _emulate_merge(part_s, part_i, k, row_len=None, cand_ids=None):
    """The merge kernel's two levels over the plan: each segment's top k
    by (score desc, id asc), -inf entries dropped, padded with (-inf, -1);
    then each row's segment lists merged the same way; ids through
    cand_ids (-1 where the score is not finite)."""
    nq, width = part_s.shape
    seg, n_seg = ops.merge_plan(nq, width, k)
    # the entry point's own check of the plan (topk_merge refuses it else)
    assert seg * n_seg >= width and (n_seg == 1 or k < seg)

    def top(entries):
        kept = sorted((e for e in entries if e[0] != -np.inf),
                      key=lambda e: (-e[0], e[1]))[:k]
        return kept + [(-np.inf, -1)] * (k - len(kept))

    out_s = np.full((nq, k), -np.inf, np.float32)
    out_i = np.full((nq, k), -1, np.int32)
    for q in range(nq):
        n = width if row_len is None else min(int(row_len[q]), width)
        row = list(zip(part_s[q, :n].tolist(), part_i[q, :n].tolist()))
        lists = [top(row[sg * seg:(sg + 1) * seg]) for sg in range(n_seg)]
        best = top([e for lst in lists for e in lst]) if n_seg > 1 \
            else lists[0]
        for j, (s, i) in enumerate(best):
            out_s[q, j] = s
            out_i[q, j] = (i if cand_ids is None else
                           (int(cand_ids[q, i]) if np.isfinite(s) else -1))
    return torch.from_numpy(out_s), torch.from_numpy(out_i)


@pytest.mark.parametrize("nq,width,k", [(1, 1000, 3), (1, 16672, 16),
                                        (3, 2000, 40), (40, 1280, 10),
                                        (2, 700, 100), (1, 5, 9),
                                        (1, 257, 256), (13, 258, 256)])
def test_merge_levels_equal_the_plain_merge(nq, width, k):
    """Ties of score (small integers) between distinct ids, -inf entries
    and a row length: the two levels give the plain merge's lists, with
    and without the position-to-id map."""
    rng = np.random.default_rng(nq * width + k)
    part_s = rng.integers(-4, 5, (nq, width)).astype(np.float32)
    part_s[rng.random((nq, width)) < 0.1] = -np.inf
    part_i = np.stack([rng.permutation(width) for _ in range(nq)]).astype(
        np.int32)
    row_len = rng.integers(0, width + 1, nq).astype(np.int32)
    cand = rng.integers(0, 10 ** 6, (nq, width)).astype(np.int32)
    ts, ti = torch.from_numpy(part_s), torch.from_numpy(part_i)
    for rl in (None, row_len):
        for cm in (None, cand):
            got = _emulate_merge(part_s, part_i, k, rl, cm)
            want = ops.merge_plain(
                ts, ti, k, None if rl is None else torch.from_numpy(rl),
                None if cm is None else torch.from_numpy(cm))
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])


def test_constants_match_the_kernel():
    """RUN_SLOTS, the cutoff and the merge's block and load constants are
    the kernel's: the wrapper sizes the runs' buffer and the merge's grid
    and scratch by them."""
    consts = dict(re.findall(r"constexpr int (kRunSlots|kGNQMax|kMergeWarps|"
                             r"kMergeVec) = (\d+);", SRC))
    assert {name: int(v) for name, v in consts.items()} == {
        "kRunSlots": ops.RUN_SLOTS, "kGNQMax": ops.GATHERED_NARROW_QUERIES,
        "kMergeWarps": ops.MERGE_WARPS, "kMergeVec": ops.MERGE_VEC}
    # the C entries' argument lists, as the wrappers bind them
    sig = re.search(r'extern "C" int gathered_runs\(([^)]*)\)', SRC).group(1)
    assert sig.count("void*") == len(ops.GATHERED_RUNS.argtypes) - 6 + 1
    sig = re.search(r'extern "C" int topk_merge\(([^)]*)\)', SRC).group(1)
    assert sig.count("int ") == 6 and sig.count("void*") == 10


def test_wrapper_takes_the_runs_path_at_or_below_the_cutoff(monkeypatch):
    """On a CUDA tensor the wrapper picks the path by Q alone: the runs
    path at Q <= GATHERED_NARROW_QUERIES, the pieces path above it
    (checked by standing in for each path's entry; nothing launches)."""
    taken = []
    monkeypatch.setattr(ops, "gathered_runs_cuda",
                        lambda *a, **kw: taken.append("runs"))
    monkeypatch.setattr(ops, "gathered_pieces",
                        lambda *a, **kw: taken.append("pieces") or (
                            _ for _ in ()).throw(StopIteration))

    class Fake(torch.Tensor):
        pass

    for q in (1, CUTOFF, CUTOFF + 1):
        qs, table, rows, ids = _inputs("runs", q, seed=q)
        dev = torch.device("cuda")
        args = [t.as_subclass(Fake) for t in (qs, table, rows, ids)]
        monkeypatch.setattr(Fake, "device", property(lambda self: dev),
                            raising=False)
        try:
            ops.gathered_topk_cuda(*args, 3)
        except StopIteration:
            pass
    assert taken == ["runs", "runs", "pieces"]


def _beats(s, i, t, ti):
    return s > t or (s == t and i < ti)


def _warp_sort(s, i):
    """warp_sort of csrc/topk_scores.cu over 32 lanes (lists of values)."""
    s, i = list(s), list(i)
    size = 2
    while size <= 32:
        stride = size >> 1
        while stride:
            ps = [s[lane ^ stride] for lane in range(32)]
            pi = [i[lane ^ stride] for lane in range(32)]
            for lane in range(32):
                here = ((lane & stride) == 0) == ((lane & size) == 0)
                if (_beats(ps[lane], pi[lane], s[lane], i[lane]) if here
                        else _beats(s[lane], i[lane], ps[lane], pi[lane])):
                    s[lane], i[lane] = ps[lane], pi[lane]
            stride >>= 1
        size <<= 1
    return s, i


def _offer_many(ls, li, s, i, k):
    """reg_offer's sort-and-merge branch: the chunk's winners sorted,
    the list's entry j against candidate 31 - j, five bitonic steps, lanes
    past k emptied."""
    kth = (ls[k - 1], li[k - 1])
    win = [x != -np.inf and _beats(x, y, *kth) for x, y in zip(s, i)]
    cs, ci = _warp_sort([x if w else -np.inf for x, w in zip(s, win)],
                        [y if w else -1 for y, w in zip(i, win)])
    ls, li = list(ls), list(li)
    for lane in range(32):
        rs, ri = cs[31 - lane], ci[31 - lane]
        if _beats(rs, ri, ls[lane], li[lane]):
            ls[lane], li[lane] = rs, ri
    stride = 16
    while stride:
        ps = [ls[lane ^ stride] for lane in range(32)]
        pi = [li[lane ^ stride] for lane in range(32)]
        for lane in range(32):
            if (_beats(ps[lane], pi[lane], ls[lane], li[lane])
                    if lane & stride == 0
                    else _beats(ls[lane], li[lane], ps[lane], pi[lane])):
                ls[lane], li[lane] = ps[lane], pi[lane]
        stride >>= 1
    return ([x if lane < k else -np.inf for lane, x in enumerate(ls)],
            [y if lane < k else -1 for lane, y in enumerate(li)])


@pytest.mark.parametrize("k", [1, 5, 16, 32])
def test_batch_offer_keeps_the_best_k(k):
    """The lane lists' batch offer (the merge's and the runs kernel's):
    chunks of 32 with score ties between distinct ids and -inf entries,
    offered in turn, leave the k best of all by (score desc, id asc), as
    inserting each winner would."""
    rng = np.random.default_rng(k)
    ls, li = [-np.inf] * 32, [-1] * 32
    seen = []
    for chunk in range(6):
        s = rng.integers(-3, 4, 32).astype(float)
        s[rng.random(32) < 0.2] = -np.inf
        i = list(rng.permutation(32) + 32 * chunk)
        seen += [(x, y) for x, y in zip(s, i) if x != -np.inf]
        ls, li = _offer_many(ls, li, list(s), i, k)
        best = sorted(seen, key=lambda e: (-e[0], e[1]))[:k]
        best += [(-np.inf, -1)] * (32 - len(best))
        assert list(zip(ls, li)) == best
