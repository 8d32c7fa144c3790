"""The port's Alg. 1 / Alg. 2 core against the JAX package on the CPU:
segment utilities, tau, the affinity EdgeList and degrees, and label
propagation for every engine. Inputs come from numpy seeds and go through
both packages; the reference's ``pallas`` engine runs in interpret mode, at
tiny sizes only."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.core import engines as jeng
from repro.core import graph_builder as jgb
from repro.core import label_prop as jlp
from repro.core import segment_utils as jsu
from repro.data.synthetic import generate_corpus as jgen
from repro_torch import interop
from repro_torch.core import engines as teng
from repro_torch.core import graph_builder as tgb
from repro_torch.core import label_prop as tlp
from repro_torch.core import segment_utils as tsu
from repro_torch.data.synthetic import generate_corpus as tgen

# the port's engine names and the reference engines they are held against
ENGINE_PAIRS = [("sort", "sort"), ("ell", "ell"), ("cuda", "pallas")]


def _np(x):
    return interop.to_numpy(x)


def _jq(table):
    return jgb.QRelTable(*(jnp.asarray(x) for x in table))


def _random_qrels(seed, n=64, nq=10, ne=20):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, nq, n).astype(np.int32)
    e = rng.integers(0, ne, n).astype(np.int32)
    s = rng.random(n).astype(np.float32)
    valid = rng.random(n) < 0.9
    return (q, e, s, valid), nq, ne


# -- segment utilities -------------------------------------------------------

def test_synthetic_corpus_is_identical_in_both_packages():
    a = jgen(num_queries=128, qrels_per_query=8, num_topics=8, seed=5)
    b = tgen(num_queries=128, qrels_per_query=8, num_topics=8, seed=5)
    for x, y in zip(a.qrels, b.qrels):
        assert np.array_equal(x, y)
    assert np.array_equal(a.passage_tokens, b.passage_tokens)
    assert np.array_equal(a.query_tokens, b.query_tokens)
    assert (a.num_entities, a.num_primary) == (b.num_entities, b.num_primary)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_segment_max_min_identity_on_empty_segments(dtype):
    data = np.array([3, -2, 7, 1], dtype)
    ids = np.array([0, 0, 3, 3], np.int32)
    for tfn, jfn in [(tsu.segment_max, jsu.segment_max),
                     (tsu.segment_min, jsu.segment_min),
                     (tsu.segment_sum, jsu.segment_sum)]:
        got = _np(tfn(torch.from_numpy(data), torch.from_numpy(ids), 5))
        want = np.asarray(jfn(jnp.asarray(data), jnp.asarray(ids), 5))
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_sort_by_orders_floats_totally_like_lax_sort():
    keys = np.array([0.0, -0.0, np.nan, 1.0, -np.inf, -0.0, 0.0, np.inf,
                     -1.0, np.nan], np.float32)
    pay = np.arange(keys.size, dtype=np.int32)
    (_,), (got,) = tsu.sort_by((torch.from_numpy(keys),),
                               (torch.from_numpy(pay),))
    want = lax.sort((jnp.asarray(keys), jnp.asarray(pay)), num_keys=1,
                    is_stable=True)[1]
    assert np.array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("seed", range(4))
def test_sort_by_two_keys_and_group_rank(seed):
    rng = np.random.default_rng(seed)
    k1 = rng.integers(0, 5, 200).astype(np.int32)
    k2 = rng.integers(-3, 3, 200).astype(np.float32) * 0.5
    pay = np.arange(200, dtype=np.int32)
    (a1, a2), (ap,) = tsu.sort_by(
        (torch.from_numpy(k1), torch.from_numpy(k2)), (torch.from_numpy(pay),))
    (b1, b2), (bp,) = jsu.sort_by((jnp.asarray(k1), jnp.asarray(k2)),
                                  (jnp.asarray(pay),))
    assert np.array_equal(_np(ap), np.asarray(bp))
    starts = tsu.run_starts(a1, a2)
    assert np.array_equal(_np(starts), np.asarray(jsu.run_starts(b1, b2)))
    assert np.array_equal(_np(tsu.group_rank(starts)),
                          np.asarray(jsu.group_rank(jsu.run_starts(b1, b2))))
    assert np.array_equal(_np(tsu.run_segment_ids(starts)),
                          np.asarray(jsu.run_segment_ids(
                              jsu.run_starts(b1, b2))))


# -- Alg. 1 ------------------------------------------------------------------

@pytest.mark.parametrize("q", [0.0, 0.25, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("seed", range(3))
def test_threshold_tau_bit_equal(q, seed):
    table, _, _ = _random_qrels(seed, n=257)
    table = (table[0], table[1],
             np.round(table[2] * 8) / 8 if seed == 2 else table[2], table[3])
    got = _np(tgb.threshold_tau(interop.qrel_table(table), q))
    want = np.asarray(jgb.threshold_tau(_jq(table), q))
    assert got.dtype == want.dtype and got.view(np.uint32) == \
        want.view(np.uint32)


def test_threshold_tau_all_invalid_is_nan():
    table, _, _ = _random_qrels(0)
    table = table[:3] + (np.zeros_like(table[3]),)
    assert np.isnan(_np(tgb.threshold_tau(interop.qrel_table(table), 0.5)))
    assert np.isnan(np.asarray(jgb.threshold_tau(_jq(table), 0.5)))


def _assert_edges_equal(te, je):
    for a, b, name in zip(te, je, "uvw") :
        assert np.array_equal(_np(a), np.asarray(b)), name
    assert np.array_equal(_np(te.valid), np.asarray(je.valid))


@pytest.mark.parametrize("seed", range(8))
def test_affinity_graph_bit_equal_on_random_tables(seed):
    """The inputs of test_affinity_graph_invariants (tau quantile 0,
    fanout 8)."""
    table, nq, ne = _random_qrels(seed)
    te = tgb.build_affinity_graph(interop.qrel_table(table), num_queries=nq,
                                  tau_quantile=0.0, fanout=8)
    je = jgb.build_affinity_graph(_jq(table), num_queries=nq,
                                  tau_quantile=0.0, fanout=8)
    _assert_edges_equal(te, je)
    assert np.array_equal(_np(tgb.node_degrees(te, ne)),
                          np.asarray(jgb.node_degrees(je, ne)))


@pytest.mark.parametrize("seed,fanout", [(0, 16), (1, 8)])
def test_affinity_graph_and_degrees_bit_equal_on_corpora(seed, fanout):
    c = tgen(num_queries=96, qrels_per_query=8, num_topics=6, seed=seed)
    te = tgb.build_affinity_graph(interop.qrel_table(c.qrels),
                                  num_queries=c.num_queries, fanout=fanout)
    je = jgb.build_affinity_graph(_jq(c.qrels), num_queries=c.num_queries,
                                  fanout=fanout)
    _assert_edges_equal(te, je)
    assert int(te.num_valid) == int(je.num_valid) > 0
    assert np.array_equal(_np(tgb.node_degrees(te, c.num_entities)),
                          np.asarray(jgb.node_degrees(je, c.num_entities)))


def test_interop_edge_list_round_trip():
    c = tgen(num_queries=96, qrels_per_query=8, num_topics=6, seed=2)
    je = jgb.build_affinity_graph(_jq(c.qrels), num_queries=c.num_queries)
    _assert_edges_equal(interop.edge_list(je), je)


# -- Alg. 2 ------------------------------------------------------------------

def _tie_graph(seed, n=60, m=240, isolated=8):
    """Undirected edges with weights that are multiples of 0.25 (so every
    tie is exact in both packages), plus isolated nodes."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n - isolated, m).astype(np.int32)
    v = rng.integers(0, n - isolated, m).astype(np.int32)
    w = rng.integers(1, 5, m).astype(np.float32) * 0.25
    valid = (u != v) & (rng.random(m) < 0.9)
    return (np.minimum(u, v), np.maximum(u, v), w, valid), n


def _lp_both(edges, n, port_engine, ref_engine, *, max_degree, rounds=5):
    src, dst, w, valid = tgb.symmetrize(interop.edge_list(edges))
    tres = teng.run_engine(teng.get_engine(port_engine), src, dst, w, valid,
                           num_nodes=n, max_degree=max_degree, rounds=rounds)
    jsrc, jdst, jw, jvalid = jgb.symmetrize(
        jgb.EdgeList(*(jnp.asarray(x) for x in edges)))
    jres = jeng.run_engine(jeng.get_engine(ref_engine), jsrc, jdst, jw,
                           jvalid, num_nodes=n, max_degree=max_degree,
                           rounds=rounds)
    return tres, jres


@pytest.mark.parametrize("port_engine,ref_engine", ENGINE_PAIRS)
@pytest.mark.parametrize("seed", range(2))
def test_label_prop_bit_equal_on_tie_heavy_graphs(port_engine, ref_engine,
                                                  seed):
    edges, n = _tie_graph(seed)
    tres, jres = _lp_both(edges, n, port_engine, ref_engine, max_degree=64)
    assert np.array_equal(_np(tres.labels), np.asarray(jres.labels))
    assert np.array_equal(_np(tres.changes_per_round),
                          np.asarray(jres.changes_per_round))


@pytest.mark.parametrize("port_engine,ref_engine", ENGINE_PAIRS)
def test_label_prop_bit_equal_with_degree_cap(port_engine, ref_engine):
    """max_degree below the graph's degree: ELL engines truncate (padded K
    rows and dropped edges), the sort engine does not."""
    edges, n = _tie_graph(7, n=40, m=300, isolated=3)
    tres, jres = _lp_both(edges, n, port_engine, ref_engine, max_degree=6)
    assert np.array_equal(_np(tres.labels), np.asarray(jres.labels))
    assert np.array_equal(_np(tres.changes_per_round),
                          np.asarray(jres.changes_per_round))


@pytest.mark.parametrize("port_engine,ref_engine", ENGINE_PAIRS)
def test_label_prop_bit_equal_on_a_synthetic_corpus(port_engine, ref_engine):
    c = jgen(num_queries=96, qrels_per_query=8, num_topics=6, seed=2)
    je = jgb.build_affinity_graph(_jq(c.qrels), num_queries=c.num_queries)
    edges = tuple(np.asarray(x) for x in je)
    tres, jres = _lp_both(edges, c.num_entities, port_engine, ref_engine,
                          max_degree=32)
    assert np.array_equal(_np(tres.labels), np.asarray(jres.labels))
    assert np.array_equal(_np(tres.changes_per_round),
                          np.asarray(jres.changes_per_round))


@pytest.mark.parametrize("k", [1, 5, 33])
@pytest.mark.parametrize("quarter", [True, False])
def test_ell_round_matches_reference(k, quarter):
    """The kernel's plain version against the reference ``ell_round`` on raw
    ELL inputs: padded slots, isolated nodes, and K above one warp."""
    rng = np.random.default_rng(k)
    n = 150
    deg = rng.integers(0, k + 1, n)
    nbr = rng.integers(0, n, (n, k)).astype(np.int32)
    nbr[np.arange(k)[None, :] >= deg[:, None]] = -1
    wgt = (rng.integers(1, 6, (n, k)) * 0.25 if quarter
           else rng.random((n, k))).astype(np.float32)
    wgt[nbr < 0] = 0.0
    labels = rng.integers(0, 30, n).astype(np.int32)
    got = tlp.ell_round(interop.labels(labels), torch.from_numpy(nbr),
                        torch.from_numpy(wgt))
    want = jlp.ell_round(jnp.asarray(labels), jnp.asarray(nbr),
                         jnp.asarray(wgt))
    assert np.array_equal(_np(got), np.asarray(want))


def test_edges_to_ell_bit_equal():
    edges, n = _tie_graph(3, n=50, m=400, isolated=5)
    src, dst, w, valid = tgb.symmetrize(interop.edge_list(edges))
    nbr, wgt = tlp.edges_to_ell(src, dst, w, valid, num_nodes=n,
                                max_degree=7)
    j = jgb.symmetrize(jgb.EdgeList(*(jnp.asarray(x) for x in edges)))
    jnbr, jwgt = jlp.edges_to_ell(*j, num_nodes=n, max_degree=7)
    assert np.array_equal(_np(nbr), np.asarray(jnbr))
    assert np.array_equal(_np(wgt), np.asarray(jwgt))


def test_registry_names():
    assert teng.available_engines() == ("cuda", "ell", "sort")
    assert teng.get_engine("cuda").needs_cuda
    with pytest.raises(ValueError, match="registered engines"):
        teng.get_engine("pallas")
