"""The port's search side against the JAX package on the CPU: the plain
top-k against the reference's ``jnp`` backend and its ``pallas`` kernel
(interpret mode, tiny sizes), ``SearchSession`` over the ``exact`` and
``tfidf`` engines, and both packages' ``launch/evaluate.py --grid smoke``.

Tolerances: scores rtol 1e-5 (BLAS and XLA sum the inner products in other
orders). Ids are held equal, except where two neighbouring scores of the
reference lie within that tolerance (a near-tie), which a test states.
The int8 scan ranks exact integer dots, so its ids and scores are held
equal with no tolerance; the float rerank after it is held like the rest."""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.compression import quantize_int8 as jquantize
from repro.kernels.topk_scoring.ops import topk_scores as jtopk_pallas
from repro.kernels.topk_scoring.ops import topk_scores_int8 as jtopk_int8
from repro.launch import evaluate as jevaluate
from repro.retrieval import search_core as jsc
from repro.retrieval.backends import get_backend as jget_backend
from repro.retrieval.backends import rerank_candidates as jrerank
from repro_torch import interop
from repro_torch.eval import backend_recall_curve, kendall_tau
from repro_torch.kernels.topk_scoring.ops import (topk_scores,
                                                  topk_scores_int8)
from repro_torch.kernels.topk_scoring.ref import pad_topk, topk_scores_ref
from repro_torch.launch import evaluate as tevaluate
from repro_torch.retrieval import search_core as tsc
from repro_torch.retrieval.backends import (get_backend, quantize_int8,
                                            rerank_candidates)
from repro_torch.retrieval.tfidf import tfidf_vectors
from repro_torch.data.synthetic import generate_corpus

RTOL = 1e-5
# the port's backends and the reference backends they are held against
BACKEND_PAIRS = [("torch", "jnp"), ("cuda", "pallas"), ("int8", "int8")]


def _assert_topk_close(ts, ti, js, ji):
    ts, ti = interop.to_numpy(ts), interop.to_numpy(ti)
    js, ji = np.asarray(js), np.asarray(ji)
    assert ts.shape == js.shape and ti.shape == ji.shape
    np.testing.assert_allclose(ts, js, rtol=RTOL, atol=RTOL)
    diff = ti != ji
    for r, c in zip(*np.nonzero(diff)):
        # a differing id must sit at a near-tie of the reference's scores
        row = js[r]
        near = [abs(row[c] - row[x]) <= RTOL * max(1.0, abs(row[c]))
                for x in (c - 1, c + 1) if 0 <= x < row.size]
        assert any(near), (r, c, row)


@pytest.mark.parametrize("q,n,d,k", [
    (16, 256, 32, 3), (7, 513, 16, 5), (3, 50, 16, 7), (5, 40, 8, 60),
    (3, 5, 8, 9), (1, 1, 4, 1), (1, 300, 8, 32)])
def test_plain_topk_matches_reference_jnp(q, n, d, k):
    rng = np.random.default_rng(q * n + k)
    qs = rng.standard_normal((q, d)).astype(np.float32)
    cs = rng.standard_normal((n, d)).astype(np.float32)
    ts, ti = pad_topk(*topk_scores_ref(torch.from_numpy(qs),
                                       torch.from_numpy(cs), k=min(k, n),
                                       block=128), k)
    js, ji = jget_backend("jnp").topk(jnp.asarray(qs), jnp.asarray(cs), k=k)
    _assert_topk_close(ts, ti, js, ji)


@pytest.mark.parametrize("port,ref", BACKEND_PAIRS)
@pytest.mark.parametrize("q,n,k", [(4, 300, 5), (3, 5, 9), (2, 64, 33)])
def test_ties_go_to_the_lowest_id(port, ref, q, n, k):
    """Integer-valued vectors: every score is exact, so ids must be equal
    with no tolerance, and ties must break toward the lower id. The port's
    cuda backend on CPU tensors runs the kernel's plain version."""
    rng = np.random.default_rng(n)
    qs = rng.integers(0, 2, (q, 6)).astype(np.float32)
    cs = rng.integers(0, 2, (n, 6)).astype(np.float32)
    ts, ti = get_backend(port).topk(torch.from_numpy(qs),
                                    torch.from_numpy(cs), k=k)
    js, ji = jget_backend(ref).topk(jnp.asarray(qs), jnp.asarray(cs), k=k)
    assert np.array_equal(interop.to_numpy(ti), np.asarray(ji))
    assert np.array_equal(interop.to_numpy(ts), np.asarray(js))
    srt = interop.to_numpy(ti)
    vals = interop.to_numpy(ts)
    for r in range(q):
        for c in range(min(k, n) - 1):
            if vals[r, c] == vals[r, c + 1]:
                assert srt[r, c] < srt[r, c + 1]


@pytest.mark.parametrize("q,n,d,k", [(3, 50, 16, 7), (5, 40, 8, 60),
                                     (3, 5, 8, 9)])
def test_cuda_backend_plain_path_matches_reference_pallas(q, n, d, k):
    rng = np.random.default_rng(q + n + d)
    qs = rng.standard_normal((q, d)).astype(np.float32)
    cs = rng.standard_normal((n, d)).astype(np.float32)
    ts, ti = topk_scores(torch.from_numpy(qs), torch.from_numpy(cs), k=k)
    js, ji = jtopk_pallas(jnp.asarray(qs), jnp.asarray(cs), k=k)
    _assert_topk_close(ts, ti, js, ji)


@pytest.fixture(scope="module")
def embedded():
    c = generate_corpus(num_queries=96, qrels_per_query=8, num_topics=6,
                        vocab_size=256, query_len=24, seed=1)
    ev, df = tfidf_vectors(c.passage_tokens, c.vocab_size)
    qv, _ = tfidf_vectors(c.query_tokens, c.vocab_size, df=df)
    return ev, qv


@pytest.mark.parametrize("engine", ["exact", "tfidf"])
@pytest.mark.parametrize("k", [3, 10])
def test_search_session_matches_reference(embedded, engine, k):
    ev, qv = embedded
    kept = np.nonzero(np.random.default_rng(k).random(ev.shape[0]) < 0.4)[0]
    t = tsc.SearchSession(interop.vectors(ev[kept]),
                          tsc.SearchConfig(engine=engine, query_chunk=40),
                          ids_map=kept, device="cpu")
    j = jsc.SearchSession(jnp.asarray(ev[kept]),
                          jsc.SearchConfig(engine=engine, query_chunk=40),
                          ids_map=kept)
    ts, ti = t.search_scored(interop.vectors(qv), k=k)
    js, ji = j.search_scored(jnp.asarray(qv), k=k)
    _assert_topk_close(ts, ti, js, ji)


def test_search_session_clamps_k_and_pads():
    vecs = np.eye(3, dtype=np.float32)
    t = tsc.SearchSession(vecs, ids_map=np.array([10, 20, 30]), device="cpu")
    s, i = t.search_scored(vecs, k=5)
    assert i.tolist() == [[10, 20, 30, -1, -1], [20, 10, 30, -1, -1],
                          [30, 10, 20, -1, -1]]
    assert np.isneginf(s[:, 3:]).all()
    with pytest.raises(ValueError, match="ids_map"):
        tsc.SearchSession(vecs, ids_map=np.array([1]), device="cpu")
    with pytest.raises(ValueError, match="registered engines"):
        tsc.SearchSession(vecs, tsc.SearchConfig(engine="hnsw"),
                          device="cpu")


def test_backend_recall_curve_on_cpu(embedded):
    ev, qv = embedded
    rows = backend_recall_curve(ev, qv[:16], k=10, device="cpu")
    assert [(r["backend"], r["rerank_factor"]) for r in rows] == [
        ("int8", 1), ("int8", 2), ("int8", 4), ("int8", 8), ("torch", None)]
    assert rows[-1]["recall_at_k"] == 1.0
    recall = [r["recall_at_k"] for r in rows[:4]]
    assert recall == sorted(recall) and 0.0 < recall[0] <= 1.0


@pytest.mark.parametrize("shape", [(40, 16), (7, 37), (300, 2048)])
def test_quantize_int8_matches_reference(shape):
    x = np.random.default_rng(shape[1]).standard_normal(shape).astype(
        np.float32)
    tc, ts = quantize_int8(torch.from_numpy(x))
    jc, js = jquantize(jnp.asarray(x))
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    assert tc.dtype == torch.int8 and float(ts) == float(js)


@pytest.mark.parametrize("q,n,d,k", [(7, 300, 37, 10), (5, 40, 16, 60),
                                     (16, 513, 32, 40), (3, 200, 20, 80),
                                     (1, 1, 4, 1)])
def test_int8_topk_plain_matches_reference(q, n, d, k):
    """The int8 wrapper's plain version against the reference's int8 kernel
    (interpret mode; k = 80 is past its cap of 64 and takes its oracle):
    exact integer dots, so scores and ids are equal."""
    rng = np.random.default_rng(q * n + d)
    qc = rng.integers(-127, 128, (q, d)).astype(np.int8)
    cc = rng.integers(-127, 128, (n, d)).astype(np.int8)
    cc[n // 2:] = cc[:n - n // 2]         # duplicate rows: exact ties
    ts, ti = topk_scores_int8(torch.from_numpy(qc), torch.from_numpy(cc), k=k)
    js, ji = jtopk_int8(jnp.asarray(qc), jnp.asarray(cc), k=k)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(ts.numpy(), np.asarray(js))


def test_rerank_candidates_matches_reference():
    rng = np.random.default_rng(5)
    vecs = rng.standard_normal((50, 12)).astype(np.float32)
    qs = rng.standard_normal((4, 12)).astype(np.float32)
    cand = rng.integers(0, 50, (4, 9)).astype(np.int32)
    cand[:, 6:] = -1                       # misses in the pool
    for k in (3, 6, 12):
        ts, ti = rerank_candidates(torch.from_numpy(vecs),
                                   torch.from_numpy(qs),
                                   torch.from_numpy(cand), k=k)
        js, ji = jrerank(jnp.asarray(vecs), jnp.asarray(qs),
                         jnp.asarray(cand), k=k)
        _assert_topk_close(ts, ti, js, ji)


@pytest.mark.parametrize("rf", [1, 2, 4, 8])
def test_int8_backend_matches_reference(embedded, rf):
    ev, qv = embedded
    tb = dataclasses.replace(get_backend("int8"), rerank_factor=rf)
    jb = dataclasses.replace(jget_backend("int8"), rerank_factor=rf)
    ts, ti = tb.topk(interop.vectors(qv),
                     tb.prepare_corpus(interop.vectors(ev)), k=10)
    js, ji = jb.topk(jnp.asarray(qv), jb.prepare_corpus(jnp.asarray(ev)),
                     k=10)
    _assert_topk_close(ts, ti, js, ji)


@pytest.mark.parametrize("engine", ["exact", "tfidf"])
@pytest.mark.parametrize("k", [3, 10])
def test_search_session_int8_matches_reference(embedded, engine, k):
    ev, qv = embedded
    cfg = dict(engine=engine, backend="int8", query_chunk=40)
    t = tsc.SearchSession(interop.vectors(ev), tsc.SearchConfig(**cfg),
                          device="cpu")
    j = jsc.SearchSession(jnp.asarray(ev), jsc.SearchConfig(**cfg))
    ts, ti = t.search_scored(interop.vectors(qv), k=k)
    js, ji = j.search_scored(jnp.asarray(qv), k=k)
    _assert_topk_close(ts, ti, js, ji)


def test_kendall_tau_copy():
    assert kendall_tau([1, 2, 3], [1, 2, 3]) == 1.0
    assert kendall_tau([1, 2, 3], [3, 2, 1]) == -1.0


def test_evaluate_smoke_grid_matches_reference(tmp_path):
    """Both packages' launch/evaluate.py --grid smoke on the same corpus:
    equal cells, equal fidelity report, equal sampler statistics."""
    args = ["--grid", "smoke", "--queries", "256", "--vocab", "256",
            "--qrels-per-query", "8", "--topics", "12", "--quiet",
            "--no-backend-curve"]
    jevaluate.main(args + ["--json", str(tmp_path / "jax.json")])
    tevaluate.main(args + ["--device", "cpu",
                           "--json", str(tmp_path / "torch.json")])
    a = json.load(open(tmp_path / "jax.json"))
    b = json.load(open(tmp_path / "torch.json"))
    assert a["grid"]["cells"] == b["grid"]["cells"]
    assert a["fidelity"] == b["fidelity"]
    assert a["grid"]["stage_counts"] == b["grid"]["stage_counts"]
    for name, stats in a["grid"]["sampler_stats"].items():
        other = b["grid"]["sampler_stats"][name]
        assert stats["n_entities"] == other["n_entities"]
        assert stats["n_queries"] == other["n_queries"]
        np.testing.assert_allclose(stats["rho_q"], other["rho_q"], rtol=1e-6)


def test_evaluate_smoke_grid_with_curve_matches_reference(tmp_path):
    """Both CLIs with their default backend recall curve: the int8 rows
    (rerank factors 1, 2, 4, 8) give the same recall, and the plain
    backend's recall equals the reference oracle's."""
    args = ["--grid", "smoke", "--queries", "128", "--vocab", "256",
            "--qrels-per-query", "8", "--topics", "12", "--quiet"]
    jevaluate.main(args + ["--json", str(tmp_path / "jax.json")])
    tevaluate.main(args + ["--device", "cpu",
                           "--json", str(tmp_path / "torch.json")])
    a = json.load(open(tmp_path / "jax.json"))
    b = json.load(open(tmp_path / "torch.json"))
    assert a["grid"]["cells"] == b["grid"]["cells"]
    pick = lambda rows, name: [(r["rerank_factor"], r["recall_at_k"])
                               for r in rows if r["backend"] == name]
    assert pick(a["backend_curve"], "int8") == pick(b["backend_curve"],
                                                    "int8")
    assert len(pick(b["backend_curve"], "int8")) == 4
    assert pick(a["backend_curve"], "jnp") == pick(b["backend_curve"],
                                                   "torch")
