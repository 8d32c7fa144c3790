"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips itself when no CUDA card is
present, so on a CPU-only machine none of them is evidence that a kernel is
right; ``chip_smoke.py`` and a run of this file on the card are. Torch only:
the card's machine has no JAX.

    python -m pytest -q -m gpu tests/test_torch_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.label_prop import ell_round
from repro_torch.kernels.label_prop.ops import lp_round_cuda
from repro_torch.kernels.lsh_hamming.ops import HAMMING_PARTIAL, hamming_topk
from repro_torch.kernels.lsh_hamming.ref import hamming_topk_ref
from repro_torch.kernels.topk_scoring.ops import (GATHERED_PARTIAL,
                                                  TOPK_INT8_PARTIAL,
                                                  TOPK_MERGE, TOPK_PARTIAL,
                                                  gathered_topk, topk_scores,
                                                  topk_scores_int8)
from repro_torch.kernels.topk_scoring.ref import (gathered_topk_ref,
                                                  topk_scores_int8_ref,
                                                  topk_scores_ref)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only on the card")
    return torch.device("cuda")


def _ell(rng, n, k, *, quarter_weights, isolated_frac=0.1):
    deg = rng.integers(0, k + 1, size=n)
    deg[rng.random(n) < isolated_frac] = 0
    nbr = rng.integers(0, n, size=(n, k)).astype(np.int32)
    nbr[np.arange(k)[None, :] >= deg[:, None]] = -1
    if quarter_weights:
        wgt = rng.integers(1, 8, size=(n, k)).astype(np.float32) * 0.25
    else:
        wgt = rng.random((n, k)).astype(np.float32)
    wgt[nbr < 0] = 0.0
    labels = rng.integers(0, max(n // 7, 1), size=n).astype(np.int32)
    return labels, nbr, wgt


@pytest.mark.parametrize("n,k", [(1, 1), (37, 5), (1000, 32), (513, 33),
                                 (300, 70), (4096, 0)])
@pytest.mark.parametrize("quarter", [True, False])
def test_lp_round_kernel_matches_plain(cuda, n, k, quarter):
    rng = np.random.default_rng(n * 131 + k)
    labels, nbr, wgt = _ell(rng, n, k, quarter_weights=quarter)
    lt, nt, wt = (torch.from_numpy(x).to(cuda) for x in (labels, nbr, wgt))
    got = lp_round_cuda(lt, nt, wt)
    torch.cuda.synchronize()
    want = ell_round(lt, nt, wt)
    assert torch.equal(got, want)


@pytest.mark.parametrize("q,n,d,k", [
    (1, 1, 4, 1), (7, 513, 16, 5), (33, 1000, 37, 8), (128, 4096, 128, 32),
    (5, 40, 8, 60), (3, 5, 8, 9), (64, 129, 2048, 3), (3, 33, 16, 32),
    (9, 1000, 24, 100), (40, 300, 8, 300)])
@pytest.mark.parametrize("negative", [False, True])
def test_topk_kernel_matches_plain(cuda, q, n, d, k, negative):
    g = torch.Generator().manual_seed(q * n + d)
    qs = torch.randn(q, d, generator=g)
    cs = torch.randn(n, d, generator=g)
    if negative:            # every score negative: padding must never win
        qs, cs = qs.abs(), -cs.abs()
    qs, cs = qs.to(cuda), cs.to(cuda)
    s, i = topk_scores(qs, cs, k=k)
    torch.cuda.synchronize()
    s_ref, i_ref = topk_scores_ref(qs, cs, k=min(k, n))
    k_eff = min(k, n)
    assert s.shape == (q, k) and i.shape == (q, k)
    tol = 1e-4 * float(d) ** 0.5
    torch.testing.assert_close(s[:, :k_eff], s_ref, rtol=1e-5, atol=tol)
    # ids agree except where two neighbouring scores lie within the
    # summation-order tolerance
    diff = i[:, :k_eff] != i_ref
    if diff.any():
        srt = torch.sort(s_ref, dim=1, descending=True).values
        gaps = (srt[:, :-1] - srt[:, 1:]).abs().min(dim=1).values
        assert bool((gaps[diff.any(dim=1)] <= 2 * tol).all())
    assert bool((i[:, k_eff:] == -1).all())
    assert bool(torch.isneginf(s[:, k_eff:]).all())


def test_topk_kernel_ties_go_to_lowest_id(cuda):
    cs = torch.zeros(700, 8, device=cuda)
    cs[::3, 0] = 1.0                       # many exact ties
    qs = torch.ones(5, 8, device=cuda)
    s, i = topk_scores(qs, cs, k=10)
    torch.cuda.synchronize()
    assert torch.equal(i[0].cpu(), torch.arange(0, 30, 3, dtype=torch.int32))


@pytest.mark.parametrize("q,n,d,k", [
    (1, 1, 4, 1), (7, 513, 16, 5), (33, 1000, 37, 8), (128, 4096, 128, 40),
    (5, 40, 8, 60), (3, 5, 20, 9), (64, 129, 2048, 10), (9, 1000, 64, 100)])
@pytest.mark.parametrize("negative", [False, True])
def test_topk_int8_kernel_matches_plain(cuda, q, n, d, k, negative):
    """Exact integer dots ranked as f32 on both sides: scores and ids are
    equal, ties included (duplicate rows make many)."""
    g = torch.Generator().manual_seed(q * n + d)
    qc = torch.randint(-127, 128, (q, d), generator=g, dtype=torch.int8)
    cc = torch.randint(-127, 128, (n, d), generator=g, dtype=torch.int8)
    if negative:            # every score negative: padding must never win
        qc, cc = qc.abs(), -cc.abs()
    cc[n // 2:] = cc[:n - n // 2].clone()
    qc, cc = qc.to(cuda), cc.to(cuda)
    s, i = topk_scores_int8(qc, cc, k=k)
    torch.cuda.synchronize()
    s_ref, i_ref = topk_scores_int8_ref(qc, cc, k=min(k, n))
    k_eff = min(k, n)
    assert s.shape == (q, k) and i.shape == (q, k)
    assert torch.equal(s[:, :k_eff], s_ref)
    assert torch.equal(i[:, :k_eff], i_ref)
    assert bool((i[:, k_eff:] == -1).all())
    assert bool(torch.isneginf(s[:, k_eff:]).all())


def _gathered_inputs(q, c, d, r, *, seed, integer, dead_rows=()):
    """Candidates drawn from an (r, d) table with repeats (so exact ties
    between positions occur), about a fifth of the slots invalid, and the
    queries in ``dead_rows`` with no valid slot at all."""
    g = torch.Generator().manual_seed(seed)
    if integer:             # small integers: every score exact
        table = torch.randint(-3, 4, (r, d), generator=g).float()
        qs = torch.randint(-3, 4, (q, d), generator=g).float()
    else:
        table = torch.randn(r, d, generator=g)
        qs = torch.randn(q, d, generator=g)
    rows = torch.randint(0, r, (q, c), generator=g, dtype=torch.int32)
    ids = torch.randint(0, 10 ** 6, (q, c), generator=g, dtype=torch.int32)
    ids[torch.rand(q, c, generator=g) < 0.2] = -1
    for x in dead_rows:
        ids[x] = -1
    return qs, table, rows, ids


@pytest.mark.parametrize("q,c,d,r,k", [
    (1, 1, 4, 1, 1), (3, 5, 8, 4, 9), (7, 300, 37, 50, 5),
    (16, 1000, 64, 200, 32), (5, 2000, 16, 100, 64), (4, 700, 128, 90, 100),
    (2, 40, 2048, 40, 3), (33, 5000, 24, 3000, 10)])
@pytest.mark.parametrize("integer", [True, False])
def test_gathered_kernel_matches_plain(cuda, q, c, d, r, k, integer):
    """Integer vectors: scores exact, so scores and ids are equal, ties to
    the earlier position included. Float vectors: scores within the f32
    summation bound, ids equal except at near-ties. Query 0 has no valid
    slot; C < k pads with -inf / -1."""
    qs, table, rows, ids = _gathered_inputs(q, c, d, r, seed=q * c + d,
                                            integer=integer, dead_rows=(0,))
    qs, table, rows, ids = (t.to(cuda) for t in (qs, table, rows, ids))
    s, i = gathered_topk(qs, table, rows, ids, k=k)
    torch.cuda.synchronize()
    k_eff = min(k, c)
    s_ref, i_ref = gathered_topk_ref(qs, table, rows, ids, k=k_eff)
    assert s.shape == (q, k) and i.shape == (q, k)
    assert bool((i[0] == -1).all()) and bool(torch.isneginf(s[0]).all())
    assert bool((i[:, k_eff:] == -1).all())
    assert bool(torch.isneginf(s[:, k_eff:]).all())
    s, i = s[:, :k_eff], i[:, :k_eff]
    if integer:
        assert torch.equal(s, s_ref) and torch.equal(i, i_ref)
        return
    tol = 1e-4 * float(d) ** 0.5
    torch.testing.assert_close(s, s_ref, rtol=1e-5, atol=tol)
    diff = i != i_ref
    if diff.any():
        fin = torch.where(torch.isfinite(s_ref), s_ref, 0.0)
        gaps = (fin[:, :-1] - fin[:, 1:]).abs().min(dim=1).values
        assert bool((gaps[diff.any(dim=1)] <= 2 * tol).all())


@pytest.mark.parametrize("q,n,w,k", [
    (1, 1, 4, 1), (3, 5, 4, 9), (7, 513, 4, 5), (33, 1000, 4, 32),
    (40, 4096, 4, 64), (9, 1000, 3, 100), (5, 300, 1, 300),
    (64, 20000, 4, 10), (2, 129, 8, 33)])
def test_hamming_kernel_matches_plain(cuda, q, n, w, k):
    """Distances are small integers, so ties are the rule: scores and ids
    are equal, ties to the lowest id, with duplicate rows besides."""
    g = torch.Generator().manual_seed(q * n + w)
    qc = torch.randint(-2 ** 31, 2 ** 31 - 1, (q, w), generator=g,
                       dtype=torch.int32)
    cc = torch.randint(-2 ** 31, 2 ** 31 - 1, (n, w), generator=g,
                       dtype=torch.int32)
    cc[n // 2:] = cc[:n - n // 2].clone()
    qc, cc = qc.to(cuda), cc.to(cuda)
    s, i = hamming_topk(qc, cc, k=k)
    torch.cuda.synchronize()
    k_eff = min(k, n)
    s_ref, i_ref = hamming_topk_ref(qc, cc, k=k_eff)
    assert s.shape == (q, k) and i.shape == (q, k)
    assert torch.equal(s[:, :k_eff], s_ref)
    assert torch.equal(i[:, :k_eff], i_ref)
    assert bool((i[:, k_eff:] == -1).all())
    assert bool(torch.isneginf(s[:, k_eff:]).all())


@pytest.mark.parametrize("k", [1, 32, 33, 200])
def test_topk_kernels_launch_at_any_k(cuda, k):
    """No cap: every k reaches the kernels on the card."""
    qs = torch.randn(4, 16, device=cuda)
    cs = torch.randn(500, 16, device=cuda)
    rows = torch.randint(0, 500, (4, 400), device=cuda, dtype=torch.int32)
    kernels = (TOPK_PARTIAL, TOPK_INT8_PARTIAL, HAMMING_PARTIAL,
               GATHERED_PARTIAL, TOPK_MERGE)
    before = [kern.launches for kern in kernels]
    topk_scores(qs, cs, k=k)
    topk_scores_int8(qs.to(torch.int8), cs.to(torch.int8), k=k)
    hamming_topk(qs.to(torch.int32), cs.to(torch.int32), k=k)
    gathered_topk(qs, cs, rows, rows, k=k)
    after = [kern.launches for kern in kernels]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1, 1, 4]


def test_sort_engine_on_the_card_matches_the_cpu(cuda):
    """Not a kernel: the sort engine's float run sums avoid atomics on the
    card (segment_reduce), so its labels equal the CPU's."""
    from repro_torch.core import engines
    rng = np.random.default_rng(0)
    n, m = 500, 3000
    u = rng.integers(0, n, m).astype(np.int32)
    v = rng.integers(0, n, m).astype(np.int32)
    w = (rng.integers(1, 9, m) * 0.25).astype(np.float32)
    src = np.concatenate([u, v])
    dst = np.concatenate([v, u])
    ww = np.concatenate([w, w])
    valid = np.concatenate([u != v, u != v])
    out = {}
    for dev in ("cpu", "cuda"):
        t = [torch.from_numpy(x).to(dev) for x in (src, dst, ww, valid)]
        res = engines.run_engine(engines.get_engine("sort"), *t, num_nodes=n,
                                 max_degree=32, rounds=5)
        out[dev] = (res.labels.cpu(), res.changes_per_round.cpu())
    assert torch.equal(out["cpu"][0], out["cuda"][0])
    assert torch.equal(out["cpu"][1], out["cuda"][1])


def test_ivfflat_build_on_the_card_is_deterministic(cuda):
    """Not a kernel: the k-means sums avoid atomics on the card (sorted
    segments), so two builds give the same centroids and lists."""
    from repro_torch.core import prng
    from repro_torch.retrieval.ivfflat import build_ivfflat
    g = torch.Generator().manual_seed(0)
    vecs = torch.rand(3000, 64, generator=g)
    a = build_ivfflat(prng.prng_key(1), vecs.to(cuda), n_lists=16)
    b = build_ivfflat(prng.prng_key(1), vecs.to(cuda), n_lists=16)
    assert torch.equal(a.centroids, b.centroids)
    assert torch.equal(a.ids, b.ids)
