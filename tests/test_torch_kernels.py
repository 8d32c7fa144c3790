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
from repro_torch.kernels.topk_scoring.ops import (TOPK_INT8_PARTIAL,
                                                  TOPK_MERGE, TOPK_PARTIAL,
                                                  topk_scores,
                                                  topk_scores_int8)
from repro_torch.kernels.topk_scoring.ref import (topk_scores_int8_ref,
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


@pytest.mark.parametrize("k", [1, 32, 33, 200])
def test_topk_kernels_launch_at_any_k(cuda, k):
    """No cap: every k reaches the kernels on the card."""
    qs = torch.randn(4, 16, device=cuda)
    cs = torch.randn(500, 16, device=cuda)
    before = (TOPK_PARTIAL.launches, TOPK_INT8_PARTIAL.launches,
              TOPK_MERGE.launches)
    topk_scores(qs, cs, k=k)
    topk_scores_int8(qs.to(torch.int8), cs.to(torch.int8), k=k)
    after = (TOPK_PARTIAL.launches, TOPK_INT8_PARTIAL.launches,
             TOPK_MERGE.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 2]


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
