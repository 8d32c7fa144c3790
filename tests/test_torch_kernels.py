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
from repro_torch.kernels.flash_attention.ops import (FLASH_ATTENTION,
                                                     HEAD_DIMS,
                                                     flash_attention,
                                                     kernel_name)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels import tuning
from repro_torch.kernels.label_prop.ops import lp_round_cuda
from repro_torch.kernels.lsh_hamming.ops import HAMMING_TOPK, hamming_topk
from repro_torch.kernels.lsh_hamming.ref import hamming_topk_ref
from repro_torch.kernels.topk_scoring.ops import (GATHERED_NARROW_QUERIES,
                                                  GATHERED_PIECE_COUNT,
                                                  GATHERED_PIECE_EMIT,
                                                  GATHERED_RUNS,
                                                  GATHERED_TILES,
                                                  INT8_NARROW_QUERIES,
                                                  NARROW_QUERIES,
                                                  TILE_PIECES, TILE_ROWS,
                                                  TOPK_INT8_PARTIAL,
                                                  TOPK_MERGE,
                                                  TOPK_NARROW_SCORES,
                                                  TOPK_NARROW_SCORES_INT8,
                                                  TOPK_NARROW_SELECT,
                                                  TOPK_PARTIAL, _runs_lists,
                                                  gathered_runs_cuda,
                                                  gathered_runs_plain,
                                                  gathered_topk, launch_merge,
                                                  merge_plain, topk_scores,
                                                  topk_scores_cuda,
                                                  topk_scores_int8,
                                                  topk_scores_int8_cuda)
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


@pytest.mark.parametrize("n,k", [(1, 1), (37, 5), (1000, 32), (513, 33),
                                 (300, 70), (4096, 0), (100_003, 32)])
@pytest.mark.parametrize("quarter", [True, False])
def test_lp_round_kernel_scattered_padding(cuda, n, k, quarter):
    """The kernel walks the valid slots wherever they lie: -1 scattered in
    any slot, not packed first as ``edges_to_ell`` packs them."""
    rng = np.random.default_rng(n * 7 + k)
    labels, nbr, wgt = _ell(rng, n, k, quarter_weights=quarter)
    perm = np.argsort(rng.random((n, k)), axis=1)
    nbr = np.take_along_axis(nbr, perm, axis=1)
    wgt = np.take_along_axis(wgt, perm, axis=1)
    assert k < 2 or np.any(np.diff((nbr < 0).astype(int), axis=1) < 0)
    lt, nt, wt = (torch.from_numpy(x).to(cuda) for x in (labels, nbr, wgt))
    got = lp_round_cuda(lt, nt, wt)
    torch.cuda.synchronize()
    assert torch.equal(got, ell_round(lt, nt, wt))


@pytest.mark.parametrize("n,k,row0", [(37, 5, 0), (1000, 32, 400),
                                      (513, 33, 256), (300, 70, 150),
                                      (4096, 0, 2048), (100_003, 32, 50_001)])
def test_lp_round_kernel_row_block(cuda, n, k, row0):
    """A block of rows of a larger graph (the sharded pipeline's rounds):
    rows row0 .. row0 + rows of the table with -1 padding in any slot, the
    replicated labels, against ``ell_round`` on the same block."""
    rng = np.random.default_rng(n + k + row0)
    labels, nbr, wgt = _ell(rng, n, k, quarter_weights=bool(row0 % 2))
    perm = np.argsort(rng.random((n, k)), axis=1)
    nbr = np.take_along_axis(nbr, perm, axis=1)
    wgt = np.take_along_axis(wgt, perm, axis=1)
    rows = (n - row0 + 1) // 2
    lt = torch.from_numpy(labels).to(cuda)
    nt, wt = (torch.from_numpy(x[row0:row0 + rows].copy()).to(cuda)
              for x in (nbr, wgt))
    got = lp_round_cuda(lt, nt, wt, row0)
    torch.cuda.synchronize()
    assert got.shape == (rows,)
    assert torch.equal(got, ell_round(lt, nt, wt, row0))


# the dense kernels' tile edges: Q around the 128-query tile, N off the
# 128-row tile, D off the MMA depth (8 floats, 32 int8 codes) and the
# 16-byte copy, k across the lists of one, two and three registers a lane
# (32, 64, 96) and those kept in shared memory (80)
_DENSE_EDGES = [(1, 300, 64, 1), (127, 1000, 64, 32), (129, 777, 64, 33),
                (257, 300, 16, 80), (130, 1000, 64, 100), (129, 777, 37, 1),
                (33, 300, 2050, 10), (1, 5000, 2048, 80), (129, 1000, 64, 90)]


@pytest.mark.parametrize("q,n,d,k", [
    (1, 1, 4, 1), (7, 513, 16, 5), (33, 1000, 37, 8), (128, 4096, 128, 32),
    (5, 40, 8, 60), (3, 5, 8, 9), (64, 129, 2048, 3), (3, 33, 16, 32),
    (9, 1000, 24, 100), (40, 300, 8, 300)] + _DENSE_EDGES)
@pytest.mark.parametrize("negative", [False, True])
def test_topk_kernel_matches_plain(cuda, q, n, d, k, negative):
    g = torch.Generator().manual_seed(q * n + d)
    qs = torch.randn(q, d, generator=g)
    cs = torch.randn(n, d, generator=g)
    if negative:            # every score negative: padding must never win
        qs, cs = qs.abs(), -cs.abs()
    _check_topk(qs.to(cuda), cs.to(cuda), k)


@pytest.mark.parametrize("d", [64, 2048])
def test_topk_kernel_wide_magnitudes(cuda, d):
    """Rows and queries scaled by powers of two from 2**-20 to 2**20, so
    the split products meet every exponent range: the same tolerances."""
    rng = np.random.default_rng(d)
    qs = rng.standard_normal((130, d)) * 2.0 ** rng.integers(-20, 21,
                                                              (130, 1))
    cs = rng.standard_normal((1000, d)) * 2.0 ** rng.integers(-20, 21,
                                                               (1000, 1))
    _check_topk(torch.from_numpy(qs.astype(np.float32)).to(cuda),
                torch.from_numpy(cs.astype(np.float32)).to(cuda), 10)


@pytest.mark.parametrize("d", [64, 2048])
@pytest.mark.parametrize("tiny", ["queries", "corpus"])
def test_topk_kernel_tiny_magnitudes(cuda, d, tiny):
    """One operand's rows near 2**-120, the other's large enough that the
    products are normal f32 (near 2**-20): the same tolerances, where TF32
    pieces below their denormal step would lose the bits."""
    rng = np.random.default_rng(d + len(tiny))
    qs = rng.standard_normal((130, d))
    cs = rng.standard_normal((1000, d))
    small, big = (qs, cs) if tiny == "queries" else (cs, qs)
    small *= 2.0 ** -120 * 2.0 ** rng.integers(-3, 4, (small.shape[0], 1))
    big *= 2.0 ** 100
    _check_topk(torch.from_numpy(qs.astype(np.float32)).to(cuda),
                torch.from_numpy(cs.astype(np.float32)).to(cuda), 10)


def _check_topk(qs, cs, k):
    q, d = qs.shape
    n = cs.shape[0]
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


@pytest.mark.parametrize("d", [16, 36, 128])
def test_topk_kernel_at_the_retrieval_cells_shapes(cuda, d):
    """The recsys retrieval cells' top-k: one user vector over 1,000,000
    candidate rows of an embedding table (D 16 for DCN-v2 and AutoInt, 36
    for DIEN's item matrix, whose upper half is zero, 128 for DLRM), k
    100. D 16 and 36 fill part of the kernel's 128-byte staged chunk."""
    g = torch.Generator().manual_seed(d)
    half = d // 2 if d == 36 else d
    cs = torch.zeros(1_000_000, d)
    cs[:, :half] = torch.randn(1_000_000, half, generator=g) / half ** 0.5
    qs = cs[torch.randint(0, 1_000_000, (26,), generator=g)].mean(
        0, keepdim=True)
    _check_topk(qs.to(cuda), cs.to(cuda), 100)


@pytest.mark.parametrize("arch", ["dcn-v2", "dien"])
def test_recsys_retrieval_cell_on_the_card_matches_the_cpu(cuda, arch):
    """The reduced retrieval cell's step on the card (the dense kernel)
    against the same step on the CPU (the plain path), one draw."""
    from repro_torch.configs import get_arch
    from repro_torch.core import prng
    from repro_torch.launch.cells import build_recsys_cell
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import recsys as rs
    from repro_torch.train.optimizer import tree_map
    cell = build_recsys_cell(arch, "retrieval_cand", make_host_mesh(
        device="cpu"), reduced=True)
    cfg = get_arch(arch).make_reduced()
    params = rs.init_recsys(prng.prng_key(0), cfg, device="cpu")
    rng = np.random.default_rng(1)
    batch = {name: torch.from_numpy(
        rng.integers(0, 16, s.shape).astype(np.int32) if s.dtype
        == torch.int32 else rng.random(s.shape).astype(np.float32))
        for name, s in cell.args[1].items()}
    rows = rs.item_matrix(params, cfg).shape[0]
    cand = torch.from_numpy(rng.permutation(rows).astype(np.int32))
    s_ref, i_ref = cell.fn(params, batch, cand)
    s, i = cell.fn(tree_map(lambda t: t.to(cuda), params),
                   {k: v.to(cuda) for k, v in batch.items()}, cand.to(cuda))
    torch.cuda.synchronize()
    torch.testing.assert_close(s.cpu(), s_ref, rtol=1e-5, atol=1e-5)
    # ids agree except between neighbours within the tolerance
    gaps = (s_ref[0, :-1] - s_ref[0, 1:]).abs()
    near = torch.cat([gaps <= 2e-5, torch.tensor([False])])
    near = near | torch.cat([torch.tensor([False]), gaps <= 2e-5])
    assert bool(((i.cpu() == i_ref)[0] | near).all())


@pytest.mark.parametrize("q", [1, 2, 7, 8, 9, 16, 31, 33, 64])
@pytest.mark.parametrize("k", [1, 16, 100, 1000])
def test_topk_narrow_path_matches_plain(cuda, q, k):
    """Q at or below NARROW_QUERIES: the narrow scorer and the radix
    select, at each query tile (8, 16, 32, 64) and k up to 1000."""
    g = torch.Generator().manual_seed(q * 1000 + k)
    qs = torch.randn(q, 48, generator=g)
    cs = torch.randn(5000, 48, generator=g)
    _check_topk(qs.to(cuda), cs.to(cuda), k)


@pytest.mark.parametrize("q,n,d,k", [(1, 3000, 4, 1000), (16, 5000, 8, 100),
                                     (33, 2000, 16, 16), (64, 1500, 24, 1500),
                                     (8, 20000, 1, 100), (2, 9000, 2, 5000),
                                     (64, 300, 33, 64)])
def test_topk_narrow_path_tie_inputs_equal_plain(cuda, q, n, d, k):
    """Integer inputs, so every score is exact and ties are many: the
    narrow path's lists equal the plain version's, ties to the lowest id,
    k above a tile's rows, k = N and more ties at the k-th key than the
    list has room for."""
    g = torch.Generator().manual_seed(q + n + d + k)
    qs = torch.randint(-2, 3, (q, d), generator=g).float().to(cuda)
    cs = torch.randint(-2, 3, (n, d), generator=g).float().to(cuda)
    s, i = topk_scores(qs, cs, k=k)
    torch.cuda.synchronize()
    s_ref, i_ref = topk_scores_ref(qs, cs, k=min(k, n))
    assert torch.equal(s, s_ref) and torch.equal(i, i_ref)


@pytest.mark.parametrize("q", [1, NARROW_QUERIES, NARROW_QUERIES + 1])
def test_topk_path_by_query_count(cuda, q):
    """Q at or below the cutoff launches the narrow pair and nothing of the
    128-query path; above it, the partial kernel and the merge."""
    kernels = (TOPK_NARROW_SCORES, TOPK_NARROW_SELECT, TOPK_PARTIAL,
               TOPK_MERGE)
    before = [kern.launches for kern in kernels]
    g = torch.Generator().manual_seed(q)
    topk_scores(torch.randn(q, 32, generator=g).to(cuda),
                torch.randn(3000, 32, generator=g).to(cuda), k=10)
    torch.cuda.synchronize()
    ran = [kern.launches - b for kern, b in zip(kernels, before)]
    narrow = q <= NARROW_QUERIES
    assert ran == ([1, 1, 0, 0] if narrow else [0, 0, 1, 1])


def test_topk_kernel_ties_go_to_lowest_id(cuda):
    cs = torch.zeros(700, 8, device=cuda)
    cs[::3, 0] = 1.0                       # many exact ties
    qs = torch.ones(5, 8, device=cuda)
    s, i = topk_scores(qs, cs, k=10)
    torch.cuda.synchronize()
    assert torch.equal(i[0].cpu(), torch.arange(0, 30, 3, dtype=torch.int32))


@pytest.mark.parametrize("q,n,d,k", [
    (1, 1, 4, 1), (7, 513, 16, 5), (33, 1000, 37, 8), (128, 4096, 128, 40),
    (5, 40, 8, 60), (3, 5, 20, 9), (64, 129, 2048, 10), (9, 1000, 64, 100),
    # the tile edges of the dense kernel, D 20 and 2047 off the MMA depth
    (1, 777, 2047, 80), (127, 1000, 20, 32), (129, 300, 64, 33),
    (257, 2000, 128, 80), (130, 777, 48, 1), (3, 1000, 2047, 100),
    (129, 1000, 64, 90)])
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


@pytest.mark.parametrize("q", [1, 2, 7, 8, 9, 16, 31, 33, 64])
@pytest.mark.parametrize("k", [1, 16, 64, 1000])
def test_topk_int8_narrow_path_matches_plain(cuda, q, k):
    """Q at or below INT8_NARROW_QUERIES: the s8 scorer and the radix
    select, at each query tile (8, 16, 32, 64), k up to 1000 (the serving
    tick's pool is 64), half the rows duplicates: equal lists."""
    g = torch.Generator().manual_seed(q * 1000 + k)
    qc = torch.randint(-127, 128, (q, 48), generator=g, dtype=torch.int8)
    cc = torch.randint(-127, 128, (5000, 48), generator=g, dtype=torch.int8)
    cc[2500:] = cc[:2500].clone()
    qc, cc = qc.to(cuda), cc.to(cuda)
    s, i = topk_scores_int8(qc, cc, k=k)
    torch.cuda.synchronize()
    s_ref, i_ref = topk_scores_int8_ref(qc, cc, k=k)
    assert torch.equal(s, s_ref) and torch.equal(i, i_ref)


@pytest.mark.parametrize("q,n,k", [(1, 5000, 300), (3, 2000, 40),
                                   (32, 3000, 64)])
def test_topk_int8_narrow_f32_rounding_ties(cuda, q, n, k):
    """D 2048, codes at +-127 but two columns: dots past 2**24 a unit
    apart, so distinct dots round to one f32; the lists equal the plain
    version's, those ties to the lowest id."""
    g = torch.Generator().manual_seed(q + n)
    d = 2048
    qc = torch.full((q, d), 127, dtype=torch.int8)
    qc[:, -2:] = torch.randint(1, 3, (q, 2), generator=g, dtype=torch.int8)
    cc = torch.full((n, d), 127, dtype=torch.int8)
    flips = torch.randint(0, 4, (n, 1), generator=g)
    cc[torch.arange(d)[None, :] < flips] = -127
    cc[:, -2:] = torch.randint(-127, 128, (n, 2), generator=g,
                               dtype=torch.int8)
    qc, cc = qc.to(cuda), cc.to(cuda)
    s, i = topk_scores_int8(qc, cc, k=k)
    torch.cuda.synchronize()
    s_ref, i_ref = topk_scores_int8_ref(qc, cc, k=k)
    assert torch.equal(s, s_ref) and torch.equal(i, i_ref)


@pytest.mark.parametrize("q", [1, INT8_NARROW_QUERIES,
                               INT8_NARROW_QUERIES + 1])
def test_topk_int8_path_by_query_count(cuda, q):
    """Q at or below the int8 cutoff launches the s8 scorer and the select
    and nothing of the 128-query int8 path; above it, the int8 partial
    kernel and the merge."""
    kernels = (TOPK_NARROW_SCORES_INT8, TOPK_NARROW_SELECT,
               TOPK_INT8_PARTIAL, TOPK_MERGE)
    before = [kern.launches for kern in kernels]
    g = torch.Generator().manual_seed(q)
    topk_scores_int8(
        torch.randint(-127, 128, (q, 32), generator=g,
                      dtype=torch.int8).to(cuda),
        torch.randint(-127, 128, (3000, 32), generator=g,
                      dtype=torch.int8).to(cuda), k=10)
    torch.cuda.synchronize()
    ran = [kern.launches - b for kern, b in zip(kernels, before)]
    narrow = q <= INT8_NARROW_QUERIES
    assert ran == ([1, 1, 0, 0] if narrow else [0, 0, 1, 1])


# ---- the 128-query dense kernels (dense_topk.cu), called directly ----------
# Q past the query tile (65, 128, 129, 256, 300); N below one 128-row tile
# and off it; D 1, 8 (the exact split), 9, 768, 2048 and 2050 (rows TMA
# cannot take: the staging path; for int8 every D off 16); k across the
# lists in one, two and three registers a lane (32, 33, 80, 81, 96, 97),
# in place (300) and 1, 3 (f32 k 96 keeps its lists in the output: they
# and a ring of four stages pass the shared memory); `off`: the corpus
# starts `off` elements into its storage, so its base is off 16 bytes
_DENSE_KERNEL_CASES = [(65, 100, 2048, 3, 0), (128, 1000, 768, 32, 0),
                       (129, 777, 9, 33, 0), (256, 3000, 8, 80, 0),
                       (300, 2000, 2050, 81, 0), (65, 513, 1, 96, 0),
                       (129, 3000, 64, 96, 0), (128, 4096, 2048, 97, 0),
                       (129, 2000, 64, 300, 1), (256, 1500, 768, 1, 3)]


def _offset_rows(x, off):
    """x [N, D] copied into storage that starts `off` elements earlier: a
    contiguous view whose base is not 16-byte aligned when off % 4 (f32)
    or off % 16 (int8) is not 0."""
    if off == 0:
        return x
    flat = torch.zeros(x.numel() + off, dtype=x.dtype, device=x.device)
    view = flat[off:].view(x.shape)
    view.copy_(x)
    return view


def _hold_dense_f32(qs, cs, s, i, k):
    """The kernel pair's lists against the plain version's: scores within
    the summation bound D * 2**-24 * sum |q_d c_d|, ids equal but where
    the two ids' exact scores lie within twice it (a near-tie)."""
    s_ref, i_ref = topk_scores_ref(qs, cs, k=k)
    d = cs.shape[1]
    mag = torch.einsum("qd,qkd->qk", qs.abs().double(),
                       cs[i_ref.long()].abs().double())
    tol = d * 2.0 ** -24 * mag + 1e-30
    assert bool(((s.double() - s_ref.double()).abs() <= tol).all())
    diff = i != i_ref
    if bool(diff.any()):
        exact = lambda ids: torch.einsum(
            "qd,qkd->qk", qs.double(), cs[ids.long().clamp(min=0)].double())
        gap = (exact(i) - exact(i_ref)).abs()
        assert bool((gap[diff] <= 2 * tol[diff]).all())


@pytest.mark.parametrize("q,n,d,k,off", _DENSE_KERNEL_CASES)
def test_dense_f32_kernel_edges(cuda, q, n, d, k, off):
    g = torch.Generator().manual_seed(q * n + d + k)
    qs = torch.randn(q, d, generator=g).to(cuda)
    cs = _offset_rows(torch.randn(n, d, generator=g).to(cuda), off)
    s, i = topk_scores_cuda(qs, cs, k)
    torch.cuda.synchronize()
    _hold_dense_f32(qs, cs, s, i, k)


@pytest.mark.parametrize("q,n,d,k,off", _DENSE_KERNEL_CASES)
def test_dense_int8_kernel_edges(cuda, q, n, d, k, off):
    """Exact int32 dots ranked as f32: the lists equal the plain
    version's to the bit (duplicate rows make exact ties)."""
    g = torch.Generator().manual_seed(q * n + d + k)
    qc = torch.randint(-127, 128, (q, d), generator=g, dtype=torch.int8)
    cc = torch.randint(-127, 128, (n, d), generator=g, dtype=torch.int8)
    cc[n // 2:] = cc[:n - n // 2].clone()
    qc, cc = qc.to(cuda), _offset_rows(cc.to(cuda), off)
    s, i = topk_scores_int8_cuda(qc, cc, k)
    torch.cuda.synchronize()
    s_ref, i_ref = topk_scores_int8_ref(qc, cc, k=k)
    assert torch.equal(s, s_ref) and torch.equal(i, i_ref)


@pytest.mark.parametrize("q,n,d,k", [(129, 3000, 16, 40),
                                     (256, 2000, 2048, 33),
                                     (300, 5000, 24, 300)])
def test_dense_f32_kernel_tie_inputs(cuda, q, n, d, k):
    """Small integers (chip_smoke.tie_inputs): every score exact, many
    ties: the lists equal the plain version's, ties to the lowest id."""
    g = torch.Generator().manual_seed(q + n + d)
    qs = torch.randint(-2, 3, (q, d), generator=g).float().to(cuda)
    cs = torch.randint(-2, 3, (n, d), generator=g).float().to(cuda)
    s, i = topk_scores_cuda(qs, cs, k)
    torch.cuda.synchronize()
    s_ref, i_ref = topk_scores_ref(qs, cs, k=k)
    assert torch.equal(s, s_ref) and torch.equal(i, i_ref)


@pytest.mark.parametrize("q,n,k", [(128, 2000, 40), (300, 1000, 97)])
def test_dense_int8_kernel_f32_rounding_ties(cuda, q, n, k):
    """chip_smoke.int8_tie_inputs: dots past 2**24 a unit apart round to
    one f32, and those ties go to the lowest id."""
    g = torch.Generator().manual_seed(q + n)
    d = 2048
    qc = torch.full((q, d), 127, dtype=torch.int8)
    qc[:, -2:] = torch.randint(1, 3, (q, 2), generator=g, dtype=torch.int8)
    cc = torch.full((n, d), 127, dtype=torch.int8)
    cc[torch.arange(d)[None, :]
       < torch.randint(0, 4, (n, 1), generator=g)] = -127
    cc[:, -2:] = torch.randint(-127, 128, (n, 2), generator=g,
                               dtype=torch.int8)
    qc, cc = qc.to(cuda), cc.to(cuda)
    s, i = topk_scores_int8_cuda(qc, cc, k)
    torch.cuda.synchronize()
    s_ref, i_ref = topk_scores_int8_ref(qc, cc, k=k)
    assert torch.equal(s, s_ref) and torch.equal(i, i_ref)


@pytest.mark.parametrize("blocks", tuning.SPACES["topk"].axes["split_blocks"])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_dense_kernels_every_split_candidate(cuda, blocks, dtype):
    """Each split target the tuner may pick: a split only decides which
    block scans which tiles, so the lists equal the default plan's to the
    bit, and the plain version's (f32 within the summation bound)."""
    g = torch.Generator().manual_seed(blocks)
    q, n, d, k = 200, 20_000, 256, 10
    if dtype == "int8":
        qs = torch.randint(-127, 128, (q, d), generator=g,
                           dtype=torch.int8).to(cuda)
        cs = torch.randint(-127, 128, (n, d), generator=g,
                           dtype=torch.int8).to(cuda)
        run = topk_scores_int8_cuda
    else:
        qs = torch.randn(q, d, generator=g).to(cuda)
        cs = torch.randn(n, d, generator=g).to(cuda)
        run = topk_scores_cuda
    s, i = run(qs, cs, k, blocks)
    s0, i0 = run(qs, cs, k)
    torch.cuda.synchronize()
    assert torch.equal(s, s0) and torch.equal(i, i0)
    if dtype == "int8":
        s_ref, i_ref = topk_scores_int8_ref(qs, cs, k=k)
        assert torch.equal(s, s_ref) and torch.equal(i, i_ref)
    else:
        _hold_dense_f32(qs, cs, s, i, k)


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


def _piece_inputs(kind, d, seed):
    """Small-integer candidates shaped to exercise the kernel's pieces
    (runs of consecutive rows inside one 128-row tile): none of length > 1,
    a row repeated within a query, runs across tile boundaries, one tile
    probed by more queries than a block takes, and an ivfflat probe. Query
    0 has no valid slot and query 1 two, below every k tested."""
    rng = np.random.default_rng(seed)
    q, c, r = 2 * TILE_PIECES + 8, 400, 3000
    if kind == "no_runs":
        rows = 2 * rng.integers(0, r // 2, (q, c))
    elif kind == "repeats":
        rows = np.repeat(rng.integers(0, r, (q, c // 4)), 4, axis=1)
    elif kind == "straddle":
        rows = rng.integers(0, r - c, (q, 1)) + np.arange(c)[None, :]
    elif kind == "crowded":
        rows = np.broadcast_to(np.arange(c) % TILE_ROWS, (q, c)).copy()
    else:
        raise ValueError(kind)
    ids = rng.integers(0, 10 ** 6, (q, c))
    ids[rng.random((q, c)) < 0.2] = -1
    ids[0] = -1
    ids[1, 2:] = -1
    qs = rng.integers(-3, 4, (q, d)).astype(np.float32)
    table = rng.integers(-3, 4, (r, d)).astype(np.float32)
    return (torch.from_numpy(qs), torch.from_numpy(table),
            torch.from_numpy(rows.astype(np.int32)),
            torch.from_numpy(ids.astype(np.int32)))


@pytest.mark.parametrize("kind", ["no_runs", "repeats", "straddle",
                                  "crowded"])
@pytest.mark.parametrize("d", [5, 64])
@pytest.mark.parametrize("k", [1, 3, 40])
def test_gathered_kernel_pieces(cuda, kind, d, k):
    """Integer vectors, so every score is exact: scores and ids equal the
    plain version's, ties to the earlier position included, whatever the
    pieces look like; D = 5 takes the scalar staging path."""
    qs, table, rows, ids = (t.to(cuda) for t in _piece_inputs(kind, d, k))
    s, i = gathered_topk(qs, table, rows, ids, k=k)
    torch.cuda.synchronize()
    s_ref, i_ref = gathered_topk_ref(qs, table, rows, ids, k=k)
    assert torch.equal(s, s_ref) and torch.equal(i, i_ref)
    assert bool((i[0] == -1).all()) and bool((i[1, 2:] == -1).all())


def test_gathered_kernel_ivfflat_probe(cuda):
    """An ivfflat index and probe on the card: lists are runs that cross
    tiles, probed by many queries."""
    from repro_torch.core import prng
    from repro_torch.retrieval.ivfflat import build_ivfflat, probe_candidates
    g = torch.Generator().manual_seed(4)
    vecs = torch.randint(-3, 4, (6000, 24), generator=g).float().to(cuda)
    qs = torch.randint(-3, 4, (300, 24), generator=g).float().to(cuda)
    index = build_ivfflat(prng.prng_key(4), vecs, n_lists=16)
    rows, ids = probe_candidates(index, qs, nprobe=4)
    table = index.vecs.reshape(-1, 24)
    for k in (3, 10, 50):
        s, i = gathered_topk(qs, table, rows, ids, k=k)
        s_ref, i_ref = gathered_topk_ref(qs, table, rows, ids, k=k)
        assert torch.equal(s, s_ref) and torch.equal(i, i_ref)


@pytest.mark.parametrize("q", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("integer", [True, False])
def test_gathered_kernel_serving_buckets(cuda, q, integer):
    """The serving tier's ivfflat ticks (buckets 1-32 at k_max 16, D 768)
    and the RAG stack's one-query calls: blocks of 1-32 pieces, so one to
    four n8 tiles of the tensor-core tile. Integer vectors: equal lists;
    normal vectors: scores within D * 2**-24 * sum |q c| of the plain
    version's and ids equal away from near-ties."""
    from repro_torch.core import prng
    from repro_torch.retrieval.ivfflat import build_ivfflat, probe_candidates
    g = torch.Generator().manual_seed(q + integer)
    d = 768
    if integer:
        vecs = torch.randint(-3, 4, (20000, d), generator=g).float()
        qs = torch.randint(-3, 4, (q, d), generator=g).float()
    else:
        vecs = torch.randn(20000, d, generator=g)
        qs = torch.randn(q, d, generator=g)
    vecs, qs = vecs.to(cuda), qs.to(cuda)
    index = build_ivfflat(prng.prng_key(q), vecs, n_lists=64)
    rows, ids = probe_candidates(index, qs, nprobe=8)
    table = index.vecs.reshape(-1, d)
    s, i = gathered_topk(qs, table, rows, ids, k=16)
    torch.cuda.synchronize()
    s_ref, i_ref = gathered_topk_ref(qs, table, rows, ids, k=16)
    if integer:
        assert torch.equal(s, s_ref) and torch.equal(i, i_ref)
        return
    assert torch.equal(i < 0, i_ref < 0)
    v64, q64 = vecs.double(), qs.double()
    tol = d * 2.0 ** -24 * torch.einsum("qd,qkd->qk", q64.abs(),
                                        v64[i_ref.long()].abs())
    assert bool(((s.double() - s_ref.double()).abs() <= tol).all())
    diff = i != i_ref
    if bool(diff.any()):
        gap = (torch.einsum("qd,qkd->qk", q64, v64[i.long()])
               - torch.einsum("qd,qkd->qk", q64, v64[i_ref.long()])).abs()
        assert bool((gap[diff] <= 2 * tol[diff]).all())


def test_gathered_kernel_tie_goes_to_the_earlier_position(cuda):
    """Equal scores at two positions, in other pieces and tiles: the
    earlier position wins, whichever row comes first in the table."""
    table = torch.zeros(300, 8, device=cuda)
    table[0] = table[200] = 1.0
    table[100] = 0.5
    qs = torch.ones(2, 8, device=cuda)
    rows = torch.tensor([[200, 100, 0], [0, 100, 200]], dtype=torch.int32,
                        device=cuda)
    ids = torch.tensor([[7, 8, 9], [9, 8, 7]], dtype=torch.int32,
                       device=cuda)
    s, i = gathered_topk(qs, table, rows, ids, k=3)
    assert i.tolist() == [[7, 9, 8], [9, 7, 8]]
    assert s.tolist() == [[8.0, 8.0, 4.0], [8.0, 8.0, 4.0]]


@pytest.mark.parametrize("q,c,d,r,k", [
    (1, 1, 4, 1, 1), (2, 300, 37, 50, 5), (1, 1000, 768, 900, 16),
    (3, 700, 5, 90, 100), (8, 4999, 2048, 3000, 3), (1, 129, 64, 40, 200),
    (9, 2000, 16, 100, 32)])
@pytest.mark.parametrize("integer", [True, False])
def test_gathered_runs_kernel_matches_plain(cuda, q, c, d, r, k, integer):
    """The runs kernel's lists against ``gathered_runs_plain`` (integer
    vectors: equal; normal ones: scores within D * 2**-24 * sum |q c|,
    positions equal away from near-ties), and the whole runs path against
    ``gathered_topk_ref``; any Q (the kernel takes Q above the cutoff
    too), C off the run length, k above it."""
    qs, table, rows, ids = (t.to(cuda) for t in _gathered_inputs(
        q, c, d, r, seed=q * c + d, integer=integer, dead_rows=(0,)))
    k = min(k, c)
    part_s, part_p, stray = _runs_lists(qs, table, rows, ids, k)
    want_s, want_p = gathered_runs_plain(qs, table, rows, ids, k)
    assert stray.item() == 0
    s, i = gathered_runs_cuda(qs, table, rows, ids, k)
    s_ref, i_ref = gathered_topk_ref(qs, table, rows, ids, k=k)
    if integer:
        assert torch.equal(part_s, want_s) and torch.equal(part_p, want_p)
        assert torch.equal(s, s_ref) and torch.equal(i, i_ref)
        return
    assert torch.equal(part_p < 0, want_p < 0)
    q64, t64 = qs.double(), table.double()
    rows_of = lambda p: torch.gather(rows, 1, p.clamp(min=0).long()).long()
    tol = d * 2.0 ** -24 * torch.einsum("qd,qkd->qk", q64.abs(),
                                        t64[rows_of(want_p)].abs())
    ok = want_p >= 0
    assert bool(((part_s.double() - want_s.double()).abs()[ok]
                 <= tol[ok]).all())
    diff = part_p != want_p
    if bool(diff.any()):
        exact = lambda p: torch.einsum("qd,qkd->qk", q64, t64[rows_of(p)])
        gap = (exact(part_p) - exact(want_p)).abs()
        assert bool((gap[diff] <= 2 * tol[diff]).all())
    assert torch.equal(i < 0, i_ref < 0)


@pytest.mark.parametrize("nq,width,k", [
    (1, 16672, 16), (1, 32784, 16), (128, 1280, 10), (1, 117, 3),
    (3, 4000, 40), (2, 20000, 100), (40, 700, 1), (5, 3, 9),
    (1, 257, 256), (13, 258, 256), (1, 385, 384)])
def test_merge_kernel_equals_its_plain_version(cuda, nq, width, k):
    """Partial lists with score ties between distinct ids and -inf
    entries, whole rows, a row length and a position-to-id map: the
    merge's lists are bit-equal to ``merge_plain``'s whatever its plan
    cuts."""
    g = torch.Generator().manual_seed(nq * width + k)
    part_s = torch.randint(-4, 5, (nq, width), generator=g).float()
    part_s[torch.rand(nq, width, generator=g) < 0.1] = -torch.inf
    part_i = torch.stack([torch.randperm(width, generator=g)
                          for _ in range(nq)]).to(torch.int32)
    row_len = torch.randint(0, width + 1, (nq,), generator=g,
                            dtype=torch.int32)
    cand = torch.randint(0, 10 ** 6, (nq, width), generator=g,
                         dtype=torch.int32)
    part_s, part_i, row_len, cand = (t.to(cuda) for t in (part_s, part_i,
                                                          row_len, cand))
    for rl in (None, row_len):
        for cm in (None, cand):
            got = launch_merge(part_s, part_i, k, rl, cm)
            want = merge_plain(part_s, part_i, k, rl, cm)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                want[1])


def test_gathered_narrow_path_reads_once_after_its_launches(cuda):
    """At Q <= GATHERED_NARROW_QUERIES the wrapper launches the runs
    kernel and the merge, nothing of the pieces path, and synchronizes
    once, after both launches (the stray-row flag): under
    ``set_sync_debug_mode("error")`` the call raises at that read with
    both kernels launched. A stray row raises the wrapper's error."""
    qs, table, rows, ids = (t.to(cuda) for t in _gathered_inputs(
        GATHERED_NARROW_QUERIES, 500, 64, 300, seed=5, integer=True,
        dead_rows=()))
    kernels = (GATHERED_RUNS, TOPK_MERGE, GATHERED_TILES,
               GATHERED_PIECE_COUNT, GATHERED_PIECE_EMIT)
    gathered_topk(qs, table, rows, ids, k=10)           # built and warm
    torch.cuda.synchronize()
    before = [kern.launches for kern in kernels]
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError, match="synchroniz"):
            gathered_topk(qs, table, rows, ids, k=10)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    launched = [kern.launches - b for kern, b in zip(kernels, before)]
    assert launched == [1, 1, 0, 0, 0]
    s, i = gathered_topk(qs, table, rows, ids, k=10)
    assert torch.equal(i, gathered_topk_ref(qs, table, rows, ids, k=10)[1])
    bad = rows.clone()
    bad[1, 7] = table.shape[0]
    ids[1, 7] = 3
    with pytest.raises(ValueError, match="outside the table's 300 rows"):
        gathered_topk(qs, table, bad, ids, k=10)


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


def _check_hamming(qc, cc, k):
    q, n = qc.shape[0], cc.shape[0]
    s, i = hamming_topk(qc, cc, k=k)
    torch.cuda.synchronize()
    k_eff = min(k, n)
    s_ref, i_ref = hamming_topk_ref(qc, cc, k=k_eff)
    assert s.shape == (q, k) and i.shape == (q, k)
    assert torch.equal(s[:, :k_eff], s_ref)
    assert torch.equal(i[:, :k_eff], i_ref)
    assert bool((i[:, k_eff:] == -1).all())
    assert bool(torch.isneginf(s[:, k_eff:]).all())


@pytest.mark.parametrize("q,n,w,k", [
    (1, 300, 4, 300), (33, 300, 1, 300), (5, 300, 3, 301), (65, 5000, 8, 64),
    (31, 1000, 12, 40), (3, 200, 40, 7), (100, 2000, 4, 1)])
@pytest.mark.parametrize("codes", ["equal", "few", "bits"])
def test_hamming_kernel_heavy_ties(cuda, q, n, w, k, codes):
    """Ties at the threshold distance: every code equal (one bin holds all
    N rows), codes from a set of 5 (a few bins hold everything), or codes
    that differ in their low bits only; W 1, 3, 4, 8, 12 (past the shared
    histograms' limit) and 40; Q off the 32-query tile; k = N and k > N."""
    g = torch.Generator().manual_seed(q + n + w + k)
    if codes == "equal":
        cc = torch.full((n, w), 12345, dtype=torch.int32)
    elif codes == "few":
        pool = torch.randint(-2 ** 31, 2 ** 31 - 1, (5, w), generator=g,
                             dtype=torch.int32)
        cc = pool[torch.randint(0, 5, (n,), generator=g)]
    else:
        cc = torch.randint(0, 4, (n, w), generator=g, dtype=torch.int32)
    qc = cc[torch.randint(0, n, (q,), generator=g)].clone()
    qc[::2, 0] ^= 1
    _check_hamming(qc.to(cuda), cc.contiguous().to(cuda), k)


def test_hamming_kernel_many_queries(cuda):
    """More queries than the split plan gives blocks to (one split)."""
    g = torch.Generator().manual_seed(5)
    qc = torch.randint(-2 ** 31, 2 ** 31 - 1, (4099, 4), generator=g,
                       dtype=torch.int32)
    cc = torch.randint(-2 ** 31, 2 ** 31 - 1, (3000, 4), generator=g,
                       dtype=torch.int32)
    _check_hamming(qc.to(cuda), cc.to(cuda), 64)


@pytest.mark.parametrize("k", [1, 32, 33, 200])
def test_topk_kernels_launch_at_any_k(cuda, k):
    """No cap: every k reaches the kernels on the card."""
    qs = torch.randn(4, 16, device=cuda)
    cs = torch.randn(500, 16, device=cuda)
    rows = torch.randint(0, 500, (4, 400), device=cuda, dtype=torch.int32)
    q_wide = GATHERED_NARROW_QUERIES + 1
    qs_wide = torch.randn(q_wide, 16, device=cuda)
    rows_wide = torch.randint(0, 500, (q_wide, 400), device=cuda,
                              dtype=torch.int32)
    kernels = (TOPK_NARROW_SCORES, TOPK_NARROW_SELECT, TOPK_PARTIAL,
               TOPK_INT8_PARTIAL, HAMMING_TOPK, GATHERED_TILES, TOPK_MERGE,
               TOPK_NARROW_SCORES_INT8, GATHERED_RUNS)
    before = [kern.launches for kern in kernels]
    topk_scores(qs, cs, k=k)
    topk_scores_int8(qs.to(torch.int8), cs.to(torch.int8), k=k)
    hamming_topk(qs.to(torch.int32), cs.to(torch.int32), k=k)
    gathered_topk(qs, cs, rows, rows, k=k)
    gathered_topk(qs_wide, cs, rows_wide, rows_wide, k=k)
    after = [kern.launches for kern in kernels]
    # 4 queries take the narrow pair of each type (the select twice); the
    # Hamming kernel selects by counting: no merge follows it; the merge
    # follows each gathered path, the runs kernel at 4 queries and the
    # tile kernel above the gathered cutoff
    assert [a - b for a, b in zip(after, before)] == [1, 2, 0, 0, 1, 1, 2, 1,
                                                      1]


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


def _attn_inputs(b, sq, skv, h, hkv, d, dtype, seed, device):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, sq, h, d, generator=g)
    k = torch.randn(b, skv, hkv, d, generator=g)
    v = torch.randn(b, skv, hkv, d, generator=g)
    return (t.to(device=device, dtype=dtype) for t in (q, k, v))


def _flash_vs_plain(q, k, v, causal, window):
    """Kernel vs plain on the card. f32: rtol 1e-5, atol 2e-5, the
    reference's own kernel tolerance (sums in another order). bf16: 2e-2,
    the reference's: the plain version rounds scores and probabilities to
    bf16 where the kernel keeps f32."""
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    assert out.shape == want.shape and out.dtype == want.dtype
    tol = 2e-2 if q.dtype == torch.bfloat16 else None
    torch.testing.assert_close(out.float(), want.float(),
                               rtol=tol or 1e-5, atol=tol or 2e-5)


_MODES = [(True, None), (True, 40), (False, None)]


@pytest.mark.parametrize("b,sq,skv,h,hkv,d", [
    (2, 64, 64, 4, 2, 32), (1, 128, 128, 8, 8, 64), (2, 96, 96, 4, 1, 32),
    (1, 200, 200, 4, 2, 16),                       # the reference's grid
    (256, 64, 64, 4, 4, 32), (256, 24, 24, 4, 4, 32),   # the encoder's
    (3, 1, 1, 2, 1, 16), (2, 1, 77, 4, 2, 128),          # S = 1
    (2, 37, 37, 4, 2, 128), (1, 33, 100, 2, 2, 64),      # ragged tiles
    (1, 100, 33, 4, 4, 32)]
    # at most 32 query rows a kv head (8 heads over one, 4 rows): the
    # short-row kernel's 32-row blocks at up to 32, 64 and 128 keys
    + [(2, 4, skv, 8, 1, d) for skv in (20, 50, 100) for d in HEAD_DIMS])
@pytest.mark.parametrize("causal,window", _MODES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda, b, sq, skv, h, hkv, d, causal,
                                    window, dtype):
    q, k, v = _attn_inputs(b, sq, skv, h, hkv, d, dtype, sq * skv + d, cuda)
    _flash_vs_plain(q, k, v, causal, window)


@pytest.mark.parametrize("skv", [1, 32, 63, 64, 65, 127, 128, 129])
@pytest.mark.parametrize("group", [1, 2, 8])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("causal,window", _MODES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_short_row_limit(cuda, skv, group, d, causal, window,
                                      dtype):
    """Both sides of the short-row kernel's limit (Skv <= 128 takes one
    block per kv head and 32 or 64 query rows, exact softmax; 129 the
    tiled online-softmax loop), with 1, 2 and 8 query heads per kv head,
    at every head width; with the few-row shapes of
    test_flash_kernel_matches_plain this runs every instance of the
    short-row kernel."""
    q, k, v = _attn_inputs(2, skv, skv, 8, 8 // group, d, dtype,
                           skv * 10 + group + d, cuda)
    _flash_vs_plain(q, k, v, causal, window)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 512)])
def test_flash_kernel_long_gqa_bf16(cuda, causal, window):
    """The LM configs' head layout (yi-9b: 32 heads over 4 kv heads, D 128)
    at S 2048, one batch row."""
    q, k, v = _attn_inputs(1, 2048, 2048, 32, 4, 128, torch.bfloat16, 5,
                           cuda)
    _flash_vs_plain(q, k, v, causal, window)


@pytest.mark.parametrize("sq,skv,causal,window", [
    (40, 40, True, 0),        # no row has an allowed key
    (70, 40, False, 10),      # rows past Skv + window see no key
    (70, 40, True, 5),
    (5, 0, False, None)])     # no keys at all
def test_flash_kernel_rows_with_no_allowed_key(cuda, sq, skv, causal,
                                               window):
    """A row whose every key is masked takes the plain softmax's uniform
    average over the Skv keys (masked logits are -1e30, not -inf), and no
    key past Skv ever counts; with no keys the output is 0."""
    q, k, v = _attn_inputs(2, sq, skv, 4, 2, 32, torch.float32, sq + skv,
                           cuda)
    _flash_vs_plain(q, k, v, causal, window)


def test_flash_kernel_reads_strided_views(cuda):
    """(B, H, S, D) storage seen as (B, S, H, D): read through strides,
    equal to the contiguous copy's result."""
    q, k, v = _attn_inputs(2, 50, 50, 4, 2, 64, torch.float32, 9, cuda)
    qv, kv, vv = (t.transpose(1, 2).contiguous().transpose(1, 2)
                  for t in (q, k, v))
    assert not qv.is_contiguous()
    a = flash_attention(qv, kv, vv, causal=False)
    b = flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def _flash_kernels_run(fn):
    """The flash kernels a call launched, by name, from a profile."""
    import re
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = set()
    for ev in prof.key_averages():
        m = re.search(r"flash_(?:short|long)(?:_tc)?\b", ev.key)
        if m:
            names.add(m.group(0))
    return names


@pytest.mark.parametrize("b,sq,skv,h,hkv", [
    (256, 64, 64, 4, 4), (256, 24, 24, 4, 4),     # the encoder's
    (1, 64, 64, 4, 4), (3, 64, 64, 4, 4), (257, 64, 64, 4, 4),
    (66, 64, 64, 4, 4), (67, 24, 24, 4, 4),       # items vs the grid
    (2, 1, 64, 4, 4), (2, 64, 1, 4, 4), (3, 1, 1, 2, 1),
    (2, 65, 64, 4, 4), (2, 130, 33, 4, 2),        # query tiles
    (2, 64, 64, 8, 2), (2, 24, 24, 8, 1)] + [     # GQA groups 4 and 8
    (2, 40, skv, 4, 2) for skv in (2, 8, 24, 31, 32, 33, 50, 63)])
@pytest.mark.parametrize("causal,window", _MODES)
def test_flash_short_tc_matches_plain(cuda, b, sq, skv, h, hkv, causal,
                                      window):
    """Every instance of the tensor-core short-row kernel (up to 32 and up
    to 64 keys), at the encoder's shapes, work-item counts above, at and
    off a multiple of the persistent grid (two blocks an SM), one query
    row and one key, several query tiles, GQA: the route taken is
    flash_short_tc, and the output is within the f32 tolerance."""
    q, k, v = _attn_inputs(b, sq, skv, h, hkv, 32, torch.float32,
                           b + sq * skv + h, cuda)
    assert kernel_name(q, k, v) == "flash_short_tc"
    assert _flash_kernels_run(lambda: flash_attention(
        q, k, v, causal=causal, window=window)) == {"flash_short_tc"}
    _flash_vs_plain(q, k, v, causal, window)


def _strided(kind, cuda):
    """Encoder-width operands whose rows or strides the tensor maps may not
    take: (B, H, S, D) storage read as (B, S, H, D) (TMA takes it); rows
    one float into a wider row (not 16-byte aligned); a broadcast batch
    (stride 0)."""
    q, k, v = _attn_inputs(3, 40, 40, 4, 2, 32, torch.float32, 21, cuda)
    if kind == "transposed":
        return tuple(t.transpose(1, 2).contiguous().transpose(1, 2)
                     for t in (q, k, v))
    if kind == "misaligned":
        def off(t):
            wide = torch.zeros(*t.shape[:3], 36, device=cuda)
            wide[..., 1:33] = t
            return wide[..., 1:33]
        return tuple(map(off, (q, k, v)))
    return tuple(t[:1].expand(3, -1, -1, -1) for t in (q, k, v))


@pytest.mark.parametrize("kind,route", [("transposed", "flash_short_tc"),
                                        ("misaligned", "flash_short"),
                                        ("broadcast", "flash_short")])
def test_flash_short_tc_route_by_stride(cuda, kind, route):
    """The dispatch sends operands TMA cannot describe to flash_short, and
    either way the result is the contiguous copy's (to the bit, since the
    same kernel's arithmetic runs) and within tolerance of plain."""
    q, k, v = _strided(kind, cuda)
    assert kernel_name(q, k, v) == route
    assert _flash_kernels_run(lambda: flash_attention(
        q, k, v, causal=False)) == {route}
    got = flash_attention(q, k, v, causal=False)
    same = flash_attention(*(t.contiguous() for t in (q, k, v)),
                           causal=False)
    torch.cuda.synchronize()
    if route == "flash_short_tc":
        assert torch.equal(got, same)
    _flash_vs_plain(q, k, v, False, None)


def test_flash_kernel_counts_launches_and_raises_on_launch_error(cuda):
    q, k, v = _attn_inputs(1, 8, 8, 2, 2, 32, torch.float32, 1, cuda)
    before = FLASH_ATTENTION.launches
    flash_attention(q, k, v, causal=True)
    assert FLASH_ATTENTION.launches == before + 1
    out = torch.empty_like(q)
    with pytest.raises(RuntimeError, match="failed to launch"):
        # D = 48 has no instance: the C entry point returns an error code
        FLASH_ATTENTION(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), 1, 8, 8, 2, 2, 48, *q.stride()[:3],
                        *k.stride()[:3], *v.stride()[:3], 1, -1, 0, 0.1)
    assert FLASH_ATTENTION.launches == before + 1
    with pytest.raises(ValueError, match="D=48"):
        flash_attention(*_attn_inputs(1, 8, 8, 2, 2, 48, torch.float32, 1,
                                      cuda))
    with pytest.raises(RuntimeError, match="no gradient"):
        flash_attention(q.requires_grad_(), k, v)


@pytest.mark.parametrize("engine,backend", [("exact", "cuda"),
                                            ("exact", "int8"),
                                            ("tfidf", "cuda")])
def test_live_index_on_card_matches_cpu_plain_path(cuda, engine, backend):
    """The serving tier's live index on the card (the frozen side through
    the dense kernels, the append buffer a full-f32 matmul) against the
    same appends on the CPU's plain path, before and after a background
    compaction: scores within the summation tolerance, ids equal away from
    near-ties."""
    from repro_torch.retrieval.search_core import SearchConfig
    from repro_torch.serve import IngestConfig, LiveIndex
    rng = np.random.default_rng(11)
    rows = rng.standard_normal((3300, 64)).astype(np.float32)
    if engine == "tfidf":
        rows = np.where(rows > 0.8, rows, 0.0).astype(np.float32)
    base, extra, q = rows[:3000], rows[3000:], rows[:37] + 0.05
    ingest = IngestConfig(append_cap=64, compact_threshold=10 ** 9)
    cfg = SearchConfig(engine=engine, backend=backend)
    card = LiveIndex(base, cfg, ingest=ingest, device=cuda)
    plain = LiveIndex(base, SearchConfig(
        engine=engine, backend="int8" if backend == "int8" else "torch"),
        ingest=ingest, device="cpu")
    dense = (TOPK_NARROW_SCORES, TOPK_PARTIAL, TOPK_INT8_PARTIAL,
             TOPK_NARROW_SCORES_INT8)
    launches0 = sum(kern.launches for kern in dense)
    for li in (card, plain):
        li.append(extra[:100])
        li.append(extra[100:])
    tol = 1e-4 * 64 ** 0.5

    def check():
        (cs, ci), (ps, pi) = (li.search_scored(q, k=16)
                              for li in (card, plain))
        np.testing.assert_allclose(cs, ps, rtol=1e-5, atol=tol)
        diff = ci != pi
        if diff.any():
            gaps = np.abs(np.diff(ps, axis=1)).min(axis=1)
            assert (gaps[diff.any(axis=1)] <= 2 * tol).all()

    check()
    assert card.compact(background=True, wait=True)
    assert plain.compact(background=False)
    assert card.pending_rows == plain.pending_rows == 0
    assert card.frozen_n == plain.frozen_n == 3300
    check()
    assert sum(kern.launches for kern in dense) > launches0


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "mixtral-8x22b",
                                  "starcoder2-7b", "gemma-2b", "yi-9b"])
def test_decoder_on_card_matches_cpu_plain_path(cuda, arch):
    """The LM decoder at an arch's reduced config (f32, TF32 off) on the
    card against the CPU: the init bit for bit, prefill's logits within
    rtol 1e-4 / atol 1e-5 (other summation orders), and a ServeEngine's
    greedy tokens over 2 slots equal, its cache on the card."""
    from repro_torch.configs import get_arch
    from repro_torch.core import prng
    from repro_torch.models import transformer as tf
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.train.optimizer import tree_leaves
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = get_arch(arch).make_reduced()
        params = {d: tf.init_transformer(prng.prng_key(1), cfg, device=d)
                  for d in (cuda, "cpu")}
        for g, w in zip(tree_leaves(params[cuda]), tree_leaves(params["cpu"])):
            assert torch.equal(g.cpu(), w)
        toks = torch.from_numpy(np.random.default_rng(2).integers(
            0, cfg.vocab_size, (2, 20)).astype(np.int32))
        with torch.no_grad():
            got = tf.prefill(params[cuda], toks.to(cuda), cfg)[0]
            want = tf.prefill(params["cpu"], toks, cfg)[0]
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)
        outs = []
        for d in (cuda, "cpu"):
            eng = ServeEngine(params[d], cfg, ServeConfig(
                max_batch=2, max_seq=32, max_new_tokens=5))
            reqs = [eng.submit(toks[i, :n].numpy()) for i, n in
                    ((0, 6), (1, 3))]
            eng.drain()
            assert eng.cache["k"].device.type == torch.device(d).type
            outs.append([r.out for r in reqs])
        assert outs[0] == outs[1]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
