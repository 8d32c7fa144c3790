"""The port's ANN engines against the JAX package on the CPU: the PRNG draws
behind them (``choice`` bit for bit, ``normal`` to a stated ulp bound),
k-means and the ivfflat index, the plain gathered and Hamming top-k
against the reference's jnp paths and, at tiny sizes, its Pallas kernels
in interpret mode, ivfflat and lsh through ``SearchSession``, and both
packages' ``launch/evaluate.py --grid default``.

Tolerances: float scores rtol 1e-5 (BLAS and XLA sum inner products in
other orders); ids equal, except at a near-tie of the reference's scores,
which ``_assert_topk_close`` states. Hamming distances and integer-valued
inner products are exact, so there scores and ids are held equal, ties
included."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lsh_hamming.ops import hamming_topk as jhamming_pallas
from repro.kernels.lsh_hamming.ref import hamming_topk_ref as jhamming_ref
from repro.kernels.topk_scoring.ops import gathered_topk as jgathered_pallas
from repro.launch import evaluate as jevaluate
from repro.retrieval import ivfflat as jivf
from repro.retrieval import lsh as jlsh
from repro.retrieval import search_core as jsc
from repro.retrieval.backends import get_backend as jget_backend
from repro_torch import interop
from repro_torch.core import prng
from repro_torch.data.synthetic import generate_corpus
from repro_torch.kernels.lsh_hamming.ops import (hamming_topk,
                                                  hamming_topk_cuda)
from repro_torch.kernels.lsh_hamming.ref import hamming_topk_ref, popcount32
from repro_torch.kernels.topk_scoring.ops import (gathered_topk,
                                                  gathered_topk_cuda)
from repro_torch.kernels.topk_scoring.ref import gathered_topk_ref, pad_topk
from repro_torch.launch import evaluate as tevaluate
from repro_torch.retrieval import ivfflat as tivf
from repro_torch.retrieval import lsh as tlsh
from repro_torch.retrieval import search_core as tsc
from repro_torch.retrieval.backends import available_backends, get_backend
from repro_torch.retrieval.engines import available_retrieval_engines
from repro_torch.retrieval.tfidf import tfidf_vectors

RTOL = 1e-5
NORMAL_MAX_ULPS = 3     # measured bound of prng.normal against JAX


def _words(key) -> tuple:
    return tuple(int(x) for x in np.asarray(key))


def _assert_topk_close(ts, ti, js, ji):
    ts, ti = interop.to_numpy(ts), interop.to_numpy(ti)
    js, ji = np.asarray(js), np.asarray(ji)
    assert ts.shape == js.shape and ti.shape == ji.shape
    np.testing.assert_allclose(ts, js, rtol=RTOL, atol=RTOL)
    for r, c in zip(*np.nonzero(ti != ji)):
        # a differing id must sit at a near-tie of the reference's scores
        row = js[r]
        near = [abs(row[c] - row[x]) <= RTOL * max(1.0, abs(row[c]))
                for x in (c - 1, c + 1) if 0 <= x < row.size]
        assert any(near), (r, c, row)


def _assert_equal(ts, ti, js, ji):
    assert np.array_equal(interop.to_numpy(ts), np.asarray(js))
    assert np.array_equal(interop.to_numpy(ti), np.asarray(ji))


@pytest.fixture(scope="module")
def embedded():
    c = generate_corpus(num_queries=96, qrels_per_query=8, num_topics=6,
                        vocab_size=256, query_len=24, seed=1)
    ev, df = tfidf_vectors(c.passage_tokens, c.vocab_size)
    qv, _ = tfidf_vectors(c.query_tokens, c.vocab_size, df=df)
    return ev, qv


# --------------------------------------------------------------------------
# PRNG: split, choice / permutation, normal
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 42, -7])
def test_split_matches_jax(seed):
    want = jax.random.split(jax.random.PRNGKey(seed))
    assert prng.split(prng.prng_key(seed)) == tuple(_words(k) for k in want)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("n,size", [(1, 1), (5, 5), (100, 16), (1700, 64),
                                    (5000, 64), (70000, 64)])
def test_choice_matches_jax(seed, n, size):
    """1700 and up take two sorting rounds of ``_shuffle``."""
    want = jax.random.choice(jax.random.PRNGKey(seed), n, (size,),
                             replace=False)
    got = prng.choice(prng.prng_key(seed), n, size)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_permutation_matches_jax():
    want = jax.random.permutation(jax.random.PRNGKey(5), 3000)
    got = prng.permutation(prng.prng_key(5), 3000)
    assert np.array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        prng.choice(prng.prng_key(0), 3, 4)


@pytest.mark.parametrize("seed,shape", [(0, (256, 128)), (1, (2048, 128)),
                                        (9, (37, 5))])
def test_normal_within_ulps_of_jax(seed, shape):
    """``log1p`` and the fused Horner steps of XLA's ``erf_inv`` are not
    reproduced bit for bit: values agree within NORMAL_MAX_ULPS, and most
    are equal."""
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    got = prng.normal(prng.prng_key(seed), shape).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert int(ulps.max()) <= NORMAL_MAX_ULPS
    assert float((ulps == 0).mean()) > 0.95


# --------------------------------------------------------------------------
# the plain Hamming and gathered top-k against the reference's
# --------------------------------------------------------------------------

def _codes(q, n, w, seed, dup=True):
    rng = np.random.default_rng(seed)
    qc = rng.integers(-2 ** 31, 2 ** 31, (q, w), dtype=np.int64)
    cc = rng.integers(-2 ** 31, 2 ** 31, (n, w), dtype=np.int64)
    if dup:                 # duplicate rows: exact ties between ids
        cc[n // 2:] = cc[:n - n // 2]
    return qc.astype(np.int32), cc.astype(np.int32)


def test_popcount32_matches_reference():
    x = np.array([0, 1, -1, 2 ** 31 - 1, -2 ** 31, 0x0F0F0F0F, 12345],
                 np.int32)
    assert np.array_equal(popcount32(torch.from_numpy(x)).numpy(),
                          np.asarray(jlsh.popcount32(jnp.asarray(x))))


@pytest.mark.parametrize("q,n,w,k", [(4, 300, 4, 64), (7, 513, 4, 5),
                                     (3, 5, 4, 9), (1, 1, 4, 1),
                                     (5, 200, 1, 32), (6, 90, 3, 40)])
def test_plain_hamming_matches_reference_jnp(q, n, w, k):
    qc, cc = _codes(q, n, w, q * n + w)
    ts, ti = pad_topk(*hamming_topk_ref(torch.from_numpy(qc),
                                        torch.from_numpy(cc), k=min(k, n),
                                        block=64), k)
    js, ji = jget_backend("jnp").hamming_topk(jnp.asarray(qc),
                                              jnp.asarray(cc), k=k)
    _assert_equal(ts, ti, js, ji)


def test_hamming_ties_are_the_rule():
    """Codes with 3 live bits a word: at most 13 distinct distances among
    400 rows, so every k = 64 boundary falls inside a tie; the lowest ids
    win."""
    rng = np.random.default_rng(0)
    qc = (rng.integers(0, 8, (5, 4)) << 3).astype(np.int32)
    cc = (rng.integers(0, 8, (400, 4)) << 3).astype(np.int32)
    ts, ti = hamming_topk_ref(torch.from_numpy(qc), torch.from_numpy(cc),
                              k=64, block=100)
    js, ji = jhamming_ref(jnp.asarray(qc), jnp.asarray(cc), k=64)
    _assert_equal(ts, ti, js, ji)


@pytest.mark.parametrize("q,n,w,k", [(3, 40, 4, 5), (9, 17, 4, 32),
                                     (2, 3, 4, 7)])
def test_hamming_wrapper_matches_reference_pallas(q, n, w, k):
    """The cuda wrapper on CPU tensors (its plain version) against the
    reference's Pallas kernel in interpret mode (k <= 32 reaches it)."""
    qc, cc = _codes(q, n, w, n + k)
    ts, ti = hamming_topk(torch.from_numpy(qc), torch.from_numpy(cc), k=k)
    js, ji = jhamming_pallas(jnp.asarray(qc), jnp.asarray(cc), k=k)
    _assert_equal(ts, ti, js, ji)


def _dense(q, c, d, seed, *, integer):
    rng = np.random.default_rng(seed)
    if integer:             # small integers: exact scores, many ties
        qs = rng.integers(-2, 3, (q, d)).astype(np.float32)
        cv = rng.integers(-2, 3, (q, c, d)).astype(np.float32)
    else:
        qs = rng.standard_normal((q, d)).astype(np.float32)
        cv = rng.standard_normal((q, c, d)).astype(np.float32)
    ids = rng.integers(0, 10 ** 6, (q, c)).astype(np.int32)
    ids[rng.random((q, c)) < 0.25] = -1
    ids[0] = -1             # a query with no valid slot
    return qs, cv, ids


def _table(cand_vecs):
    qn, c, d = cand_vecs.shape
    rows = np.arange(qn * c, dtype=np.int32).reshape(qn, c)
    return torch.from_numpy(cand_vecs.reshape(qn * c, d)), \
        torch.from_numpy(rows)


@pytest.mark.parametrize("q,c,d,k", [(5, 64, 16, 10), (3, 7, 8, 9),
                                     (4, 100, 32, 64), (2, 1, 4, 1)])
@pytest.mark.parametrize("integer", [True, False])
def test_plain_gathered_matches_reference_jnp(q, c, d, k, integer):
    qs, cv, ids = _dense(q, c, d, q * c + d, integer=integer)
    table, rows = _table(cv)
    ts, ti = pad_topk(*gathered_topk_ref(torch.from_numpy(qs), table, rows,
                                         torch.from_numpy(ids),
                                         k=min(k, c), chunk_bytes=1), k)
    js, ji = jget_backend("jnp").gathered_topk(
        jnp.asarray(qs), jnp.asarray(cv), jnp.asarray(ids), k=k)
    if integer:             # ties go to the earlier position
        _assert_equal(ts, ti, js, ji)
    else:
        _assert_topk_close(ts, ti, js, ji)


@pytest.mark.parametrize("q,c,d,k", [(3, 16, 8, 5), (2, 5, 4, 8)])
def test_gathered_wrapper_matches_reference_pallas(q, c, d, k):
    qs, cv, ids = _dense(q, c, d, c + k, integer=True)
    table, rows = _table(cv)
    ts, ti = gathered_topk(torch.from_numpy(qs), table, rows,
                           torch.from_numpy(ids), k=k)
    js, ji = jgathered_pallas(jnp.asarray(qs), jnp.asarray(cv),
                              jnp.asarray(ids), k=k)
    _assert_equal(ts, ti, js, ji)


@pytest.mark.parametrize("name", ["torch", "cuda", "int8"])
def test_every_backend_has_the_ann_primitives(name):
    """Every backend answers hamming_topk and both gathered forms; on CPU
    tensors the cuda and int8 ones run the plain versions."""
    b = get_backend(name)
    qc, cc = _codes(4, 100, 4, 7)
    ts, ti = b.hamming_topk(torch.from_numpy(qc), torch.from_numpy(cc), k=40)
    js, ji = jget_backend("jnp").hamming_topk(jnp.asarray(qc),
                                              jnp.asarray(cc), k=40)
    _assert_equal(ts, ti, js, ji)
    qs, cv, ids = _dense(4, 30, 8, 3, integer=True)
    want = jget_backend("jnp").gathered_topk(
        jnp.asarray(qs), jnp.asarray(cv), jnp.asarray(ids), k=12)
    _assert_equal(*b.gathered_topk(torch.from_numpy(qs), torch.from_numpy(cv),
                                   torch.from_numpy(ids), k=12), *want)
    table, rows = _table(cv)
    _assert_equal(*b.gathered_rows_topk(torch.from_numpy(qs), table, rows,
                                        torch.from_numpy(ids), k=12), *want)


def test_ann_wrappers_take_the_plain_path_only_on_cpu_tensors():
    codes = torch.tensor([[0], [1], [3], [7]], dtype=torch.int32)
    s, i = hamming_topk(codes[:1], codes, k=5)
    assert i.tolist() == [[0, 1, 2, 3, -1]]
    assert s.tolist() == [[-0.0, -1.0, -2.0, -3.0, -float("inf")]]
    with pytest.raises(ValueError, match="CUDA"):
        hamming_topk_cuda(codes, codes, 2)
    table = torch.eye(3)
    rows = torch.tensor([[2, 1, 0]], dtype=torch.int32)
    ids = torch.tensor([[7, -1, 9]], dtype=torch.int32)
    s, i = gathered_topk(table[:1], table, rows, ids, k=4)
    assert i.tolist() == [[9, 7, -1, -1]]
    assert s.tolist() == [[1.0, 0.0, -float("inf"), -float("inf")]]
    with pytest.raises(ValueError, match="CUDA"):
        gathered_topk_cuda(table[:1], table, rows, ids, 1)


# --------------------------------------------------------------------------
# ivfflat and lsh
# --------------------------------------------------------------------------

def test_ann_engines_registered():
    assert available_retrieval_engines() == ("exact", "ivfflat", "lsh",
                                             "tfidf")
    assert set(available_backends()) == {"cuda", "int8", "torch"}


@pytest.mark.parametrize("n_clusters,iters", [(8, 3)])
def test_kmeans_matches_reference(embedded, n_clusters, iters):
    ev, _ = embedded
    want = jivf.kmeans(jax.random.PRNGKey(0), jnp.asarray(ev), n_clusters,
                       iters)
    got = tivf.kmeans(prng.prng_key(0), torch.from_numpy(ev), n_clusters,
                      iters)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n_lists,cap_factor", [(16, 2.0), (8, 0.5)])
def test_build_ivfflat_matches_reference(embedded, n_lists, cap_factor):
    """cap_factor 0.5 drops the members past each list's capacity."""
    ev, _ = embedded
    want = jivf.build_ivfflat(jax.random.PRNGKey(3), jnp.asarray(ev),
                              n_lists=n_lists, cap_factor=cap_factor)
    got = tivf.build_ivfflat(prng.prng_key(3), torch.from_numpy(ev),
                             n_lists=n_lists, cap_factor=cap_factor)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_lsh_codes_match_reference(embedded):
    ev, qv = embedded
    want = jlsh.build_lsh(jax.random.PRNGKey(0), jnp.asarray(ev))
    got = tlsh.build_lsh(prng.prng_key(0), torch.from_numpy(ev))
    assert np.array_equal(got.codes.numpy(), np.asarray(want.codes))
    assert np.array_equal(tlsh.encode(got.proj, torch.from_numpy(qv)).numpy(),
                          np.asarray(jlsh.encode(want.proj, jnp.asarray(qv))))


@pytest.mark.parametrize("rerank", [0, 64])
def test_search_lsh_on_a_shared_index(embedded, rerank):
    """Both branches: with no rerank the scores are Hamming distances."""
    ev, qv = embedded
    jidx = jlsh.build_lsh(jax.random.PRNGKey(1), jnp.asarray(ev))
    tidx = interop.lsh_index(jidx)
    js, ji = jlsh.search_lsh(jidx, jnp.asarray(qv), k=10, rerank=rerank)
    ts, ti = tlsh.search_lsh(tidx, interop.vectors(qv), k=10, rerank=rerank)
    if rerank:
        _assert_topk_close(ts, ti, js, ji)
    else:
        _assert_equal(ts, ti, js, ji)


@pytest.mark.parametrize("nprobe", [1, 4])
def test_search_ivfflat_on_a_shared_index(embedded, nprobe):
    ev, qv = embedded
    jidx = jivf.build_ivfflat(jax.random.PRNGKey(2), jnp.asarray(ev),
                              n_lists=12)
    tidx = interop.ivfflat_index(jidx)
    js, ji = jivf.search_ivfflat(jidx, jnp.asarray(qv), k=10, nprobe=nprobe)
    ts, ti = tivf.search_ivfflat(tidx, interop.vectors(qv), k=10,
                                 nprobe=nprobe)
    _assert_topk_close(ts, ti, js, ji)


@pytest.mark.parametrize("engine,k,port,ref", [
    ("ivfflat", 10, "torch", "jnp"), ("lsh", 3, "torch", "jnp"),
    ("lsh", 10, "int8", "int8")])
def test_search_session_matches_reference(embedded, engine, k, port, ref):
    """Each package builds its own index from the same seed and answers
    the same chunked queries, ids mapped through the sample's kept ids;
    then the port's session searches the reference's index (interop)."""
    ev, qv = embedded
    kept = np.nonzero(np.random.default_rng(k).random(ev.shape[0]) < 0.5)[0]
    t = tsc.SearchSession(interop.vectors(ev[kept]),
                          tsc.SearchConfig(engine=engine, backend=port,
                                           query_chunk=40),
                          key=prng.prng_key(4), ids_map=kept, device="cpu")
    j = jsc.SearchSession(jnp.asarray(ev[kept]),
                          jsc.SearchConfig(engine=engine, backend=ref,
                                           query_chunk=40),
                          key=jax.random.PRNGKey(4), ids_map=kept)
    want = j.search_scored(jnp.asarray(qv), k=k)
    _assert_topk_close(*t.search_scored(interop.vectors(qv), k=k), *want)
    shared = (interop.ivfflat_index if engine == "ivfflat"
              else interop.lsh_index)
    t.index = shared(j.index)
    _assert_topk_close(*t.search_scored(interop.vectors(qv), k=k), *want)


def test_search_session_engine_opts_shrink_and_clamp(embedded):
    """n_lists shrinks to N//8 and nprobe clamps to it; rerank clamps to
    [k, N]: a 20-row corpus still answers k = 30."""
    ev, qv = embedded
    for engine, opts in (("ivfflat", {"n_lists": 64, "nprobe": 8}),
                         ("lsh", {"rerank": 5})):
        t = tsc.SearchSession(ev[:20], tsc.SearchConfig(
            engine=engine, engine_opts=opts), device="cpu")
        j = jsc.SearchSession(jnp.asarray(ev[:20]), jsc.SearchConfig(
            engine=engine, engine_opts=opts))
        ts, ti = t.search_scored(qv[:6], k=30)
        js, ji = j.search_scored(jnp.asarray(qv[:6]), k=30)
        assert ti.shape == (6, 30) and (ti[:, 20:] == -1).all()
        _assert_topk_close(ts, ti, js, ji)


def test_evaluate_default_grid_matches_reference(tmp_path):
    """Both packages' launch/evaluate.py --grid default (the reference's
    GridSpec(): 3 samplers x 4 engines x 2 ks x 4 metrics) on the same
    corpus: equal cells, fidelity report and stage counts."""
    args = ["--grid", "default", "--queries", "128", "--vocab", "256",
            "--qrels-per-query", "8", "--topics", "12", "--quiet",
            "--no-backend-curve"]
    jevaluate.main(args + ["--json", str(tmp_path / "jax.json")])
    tevaluate.main(args + ["--device", "cpu",
                           "--json", str(tmp_path / "torch.json")])
    a = json.load(open(tmp_path / "jax.json"))
    b = json.load(open(tmp_path / "torch.json"))
    assert len(b["grid"]["cells"]) == 96
    assert {c["engine"] for c in b["grid"]["cells"]} == {
        "exact", "ivfflat", "lsh", "tfidf"}
    assert a["grid"]["cells"] == b["grid"]["cells"]
    assert a["fidelity"] == b["fidelity"]
    assert a["grid"]["stage_counts"] == b["grid"]["stage_counts"]
