"""The port's sharded and streamed sampling and search (``core/
sharded_pipeline.py``, ``core/distributed.py``, ``retrieval/sharded.py``,
the sessions and both CLIs) against the JAX package and against the
port's own single-device path, on the CPU.

On a 1-rank gloo group (``make_host_mesh(device="cpu")``) every sharded
and streamed program is bit-equal to the single-device one, as the
reference's 1-device mesh is, and the graph, labels and changes equal the
reference's sharded ones on the same numpy inputs. Two ranks run in two
child processes (one script, a gloo group through a ``FileStore``): labels
bit-equal to one rank, every engine's top-k set-equal, the reference's
padding regressions, and the compressed all-reduce's mean.

Two reference tests are red (jax 0.9 raises in ``graph_builder.
node_degrees`` on the born path's row-sharded edge list:
``tests/test_streamed_build.py::test_streamed_sampler_bit_identical_one_
device`` and ``::test_streamed_sampler_accepts_prebuilt_qrels``); the port
is held to their stated invariant instead: born labels, changes and draws
equal the legacy sharded session's."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph_builder as jgb
from repro.core import sharded_pipeline as jsp
from repro.core.distributed import distributed_propagate_ell as jprop
from repro.core.pipeline import WindTunnelConfig as JConfig
from repro.distributed.sharded_corpus import ShardedQRels as JQRels
from repro.launch import mesh as jmesh
from repro.retrieval import search_core as jsc
from repro.retrieval import sharded as jsharded
from repro.retrieval.engines import get_retrieval_engine as jget_engine
from repro_torch.core import SamplerSession, SamplerSpec, WindTunnelConfig
from repro_torch.core import graph_builder as gb
from repro_torch.core import label_prop as lp
from repro_torch.core import sharded_pipeline as sp
from repro_torch.core.distributed import (distributed_propagate_ell,
                                          verify_against_single_device)
from repro_torch.core.prng import prng_key
from repro_torch.data.synthetic import generate_corpus
from repro_torch.distributed.sharded_corpus import (ShardedCorpus,
                                                    ShardedQRels,
                                                    sharded_row_buffer)
from repro_torch.kernels.label_prop.ops import label_prop_round
from repro_torch.launch import evaluate as tevaluate
from repro_torch.launch import sample as tsample
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.obs import REGISTRY
from repro_torch.obs import memory as obs_memory
from repro_torch.retrieval import search_core as tsc
from repro_torch.retrieval import sharded as tsharded
from repro_torch.retrieval.engines import get_retrieval_engine

ENGINES = ("exact", "tfidf", "lsh", "ivfflat")
RTOL = 1e-5
TWO_RANK_TIMEOUT = 120      # seconds, each child


@pytest.fixture(scope="module")
def mesh():
    return make_host_mesh(device="cpu")


@pytest.fixture(scope="module")
def jm():
    return jmesh.make_host_mesh()


@pytest.fixture(scope="module")
def corpus():
    return generate_corpus(num_queries=96, qrels_per_query=8, num_topics=8,
                           seed=2)


def _qrels(seed, nq=40, ne=120, nnz=500, invalid=0.1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, nq, nnz).astype(np.int32),
            rng.integers(0, ne, nnz).astype(np.int32),
            rng.random(nnz).astype(np.float32),
            rng.random(nnz) >= invalid), nq, ne


def _torch_table(fields):
    return gb.QRelTable(*(torch.from_numpy(np.asarray(x)) for x in fields))


def _assert_topk_close(ts, ti, js, ji):
    """Scores within RTOL; a differing id only at a near-tie."""
    js, ji = np.asarray(js), np.asarray(ji)
    assert ts.shape == js.shape and ti.shape == ji.shape
    np.testing.assert_allclose(ts, js, rtol=RTOL, atol=RTOL)
    for r, c in zip(*np.nonzero(ti != ji)):
        row = js[r]
        assert any(abs(row[c] - row[x]) <= RTOL * max(1.0, abs(row[c]))
                   for x in (c - 1, c + 1) if 0 <= x < row.size), (r, c)


# -- the LP round on a block of rows --------------------------------------------

@pytest.mark.parametrize("k", [0, 5, 70])
def test_ell_round_row_block_is_the_rows_of_the_whole(k):
    rng = np.random.default_rng(k)
    n = 200
    nbr = rng.integers(0, n, (n, k)).astype(np.int32)
    nbr[rng.random((n, k)) < 0.4] = -1          # padding in any slot
    wgt = np.where(nbr >= 0, rng.integers(1, 5, (n, k)) * 0.25,
                   0.0).astype(np.float32)
    labels = torch.from_numpy(rng.integers(0, 40, n).astype(np.int32))
    nbr_t, wgt_t = torch.from_numpy(nbr), torch.from_numpy(wgt)
    whole = lp.ell_round(labels, nbr_t, wgt_t)
    for row0, rows in ((0, 200), (37, 50), (150, 50), (199, 1)):
        blk = slice(row0, row0 + rows)
        got = lp.ell_round(labels, nbr_t[blk], wgt_t[blk], row0)
        assert torch.equal(got, whole[blk])
        assert torch.equal(label_prop_round(labels, nbr_t[blk], wgt_t[blk],
                                            row0), whole[blk])


def test_distributed_propagate_ell_equals_reference(mesh):
    rng = np.random.default_rng(5)
    n, k = 64, 6
    nbr = rng.integers(0, n, (n, k)).astype(np.int32)
    nbr[rng.random((n, k)) < 0.3] = -1
    wgt = np.where(nbr >= 0, rng.random((n, k)), 0.0).astype(np.float32)
    got = distributed_propagate_ell(mesh, torch.from_numpy(nbr),
                                    torch.from_numpy(wgt), rounds=4)
    want = jprop(jmesh.make_host_mesh(), jnp.asarray(nbr), jnp.asarray(wgt),
                 rounds=4)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert verify_against_single_device(mesh, torch.from_numpy(nbr),
                                        torch.from_numpy(wgt))


# -- the sharded graph + LP -------------------------------------------------------

@pytest.mark.parametrize("d", [1, 3])
def test_route_by_query_equals_reference(d):
    fields, nq, _ = _qrels(9, invalid=0.3)
    qps = -(-nq // d)
    got = sp._route_by_query(_torch_table(fields), num_shards=d,
                             queries_per_shard=qps)
    want = jsp._route_by_query(jgb.QRelTable(*map(jnp.asarray, fields)),
                               num_shards=d, queries_per_shard=qps)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("born", [False, True], ids=["legacy", "born"])
def test_sharded_graph_and_labels_equals_reference(mesh, jm, corpus, born):
    kw = dict(num_queries=corpus.num_queries,
              num_entities=corpus.num_entities)
    if born:
        port_in = ShardedQRels.from_host(corpus.qrels, mesh=mesh,
                                         device="cpu", **kw)
        ref_in = JQRels.from_host(corpus.qrels, mesh=jm, **kw)
    else:
        port_in = _torch_table(corpus.qrels)
        ref_in = jgb.QRelTable(*map(jnp.asarray, corpus.qrels))
    edges, labels, changes = sp.sharded_graph_and_labels(
        port_in, config=WindTunnelConfig(engine="ell"), mesh=mesh, **kw)
    jedges, jlabels, jchanges = jsp.sharded_graph_and_labels(
        ref_in, config=JConfig(engine="ell"), mesh=jm, **kw)
    for a, b in zip(edges, jedges):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert np.array_equal(labels.numpy(), np.asarray(jlabels))
    assert np.array_equal(changes.numpy(), np.asarray(jchanges))


def test_born_sampler_equals_legacy_and_single_device(mesh, corpus):
    """The stated invariant of the two red reference tests: born labels,
    changes and draws equal the legacy sharded session's, and both equal
    the single-device session's (a prebuilt ShardedQRels too)."""
    kw = dict(num_queries=corpus.num_queries,
              num_entities=corpus.num_entities, device="cpu")
    single = SamplerSession(corpus.qrels, spec=SamplerSpec(engine="ell"),
                            **kw)
    legacy = SamplerSession(corpus.qrels, spec=SamplerSpec(
        engine="ell", sharded=True, mesh=mesh), **kw)
    born = SamplerSession(corpus.qrels, spec=SamplerSpec(
        engine="ell", streamed=True, mesh=mesh, stream_chunk=100), **kw)
    prebuilt = SamplerSession(ShardedQRels.from_host(
        corpus.qrels, num_queries=corpus.num_queries,
        num_entities=corpus.num_entities, mesh=mesh, device="cpu"),
        spec=SamplerSpec(engine="ell"), **kw)
    assert born.spec.sharded and born.spec.streamed and prebuilt.spec.sharded
    for s in (legacy, born, prebuilt):
        for a, b in zip(s.labels(), single.labels()):
            assert torch.equal(a, b)
        assert torch.equal(s.graph()[1], single.graph()[1])
        for strategy in ("windtunnel", "uniform", "degree_stratified"):
            for seed in (0, 3):
                got = s.draw(seed=seed, strategy=strategy, target_size=0.2)
                want = single.draw(seed=seed, strategy=strategy,
                                   target_size=0.2)
                assert torch.equal(got.entity_mask, want.entity_mask)
                assert int(got.reconstructed.num_queries) == \
                    int(want.reconstructed.num_queries)
    assert born.stage_counts()["graph"][0] == 1
    with pytest.raises(ValueError, match="routed for"):
        SamplerSession(prebuilt._born, num_queries=corpus.num_queries + 7,
                       num_entities=corpus.num_entities, device="cpu",
                       spec=SamplerSpec(engine="ell"))


def test_run_windtunnel_sharded_equals_run_windtunnel(mesh, corpus):
    """The legacy wrapper on a 1-rank mesh is ``run_windtunnel`` bit for
    bit (the reference's sharded pipeline is held above)."""
    from repro_torch.core import run_windtunnel
    kw = dict(num_queries=corpus.num_queries,
              num_entities=corpus.num_entities, device="cpu",
              config=WindTunnelConfig(engine="ell", seed=1))
    got = sp.run_windtunnel_sharded(corpus.qrels, mesh=mesh, **kw)
    want = run_windtunnel(corpus.qrels, **kw)
    for f in ("labels", "changes_per_round", "degrees"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert torch.equal(got.sample.entity_mask, want.sample.entity_mask)
    for a, b in zip(got.edges, want.edges):
        assert torch.equal(a, b)


# -- sharded search ---------------------------------------------------------------

@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((300, 16)).astype(np.float32),
            rng.standard_normal((9, 16)).astype(np.float32))


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("backend", ["torch", "int8"])
def test_streamed_search_bit_equal_single_device(mesh, data, engine,
                                                 backend):
    vecs, queries = data
    ref = tsc.SearchSession(vecs, tsc.SearchConfig(
        engine=engine, backend=backend), device="cpu")
    got = tsc.SearchSession(vecs, tsc.SearchConfig(
        engine=engine, backend=backend, streamed=True, mesh=mesh,
        stream_chunk=64), device="cpu")
    assert got.config.sharded and got.config.streamed
    for k in (5, 400):                  # k > corpus pads with -1
        a, b = ref.search_scored(queries, k=k), got.search_scored(queries,
                                                                   k=k)
        assert np.array_equal(a[1], b[1]) and np.array_equal(a[0], b[0])
    if backend == "torch":              # the legacy plans as well
        leg = tsc.SearchSession(vecs, tsc.SearchConfig(
            engine=engine, backend=backend, sharded=True, mesh=mesh),
            device="cpu")
        a, b = ref.search_scored(queries, k=5), leg.search_scored(queries,
                                                                   k=5)
        assert np.array_equal(a[1], b[1]) and np.array_equal(a[0], b[0])


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("backends", [("torch", "jnp"), ("int8", "int8")])
def test_streamed_search_matches_reference(mesh, jm, data, engine,
                                           backends):
    vecs, queries = data
    got = tsc.SearchSession(vecs, tsc.SearchConfig(
        engine=engine, backend=backends[0], streamed=True, mesh=mesh),
        device="cpu")
    want = jsc.SearchSession(vecs, jsc.SearchConfig(
        engine=engine, backend=backends[1], streamed=True, mesh=jm))
    _assert_topk_close(*got.search_scored(queries, k=5),
                       *want.search_scored(queries, k=5))


def test_legacy_sharded_search_direct(mesh, jm, data):
    """``sharded_search`` on pre-built global indexes, k past the corpus:
    the reference's -1 / -inf padding."""
    vecs, queries = data
    eng = get_retrieval_engine("exact")
    jeng = jget_engine("exact")
    small = vecs[:5]
    s, i = tsharded.sharded_search(
        eng.__class__(backend="torch"), torch.from_numpy(small),
        torch.from_numpy(queries), k=7, mesh=mesh)
    js, ji = jsharded.sharded_search(jeng, jnp.asarray(small),
                                     jnp.asarray(queries), k=7, mesh=jm)
    assert np.array_equal(i.numpy(), np.asarray(ji))
    assert (i[:, 5:] == -1).all() and torch.isinf(s[:, 5:]).all()
    _assert_topk_close(s.numpy(), i.numpy(), js, ji)


def test_sharded_buffer_topk_equals_reference(mesh, jm, data):
    vecs, queries = data
    from repro.distributed.sharded_corpus import sharded_row_buffer as jbuf
    got = tsharded.sharded_buffer_topk(
        sharded_row_buffer(vecs[:40], capacity=64, dim=16, mesh=mesh,
                           device="cpu"), 40, torch.from_numpy(queries),
        k=6, mesh=mesh, id_base=1000)
    want = jsharded.sharded_buffer_topk(
        jbuf(vecs[:40], capacity=64, dim=16, mesh=jm), 40,
        jnp.asarray(queries), k=6, mesh=jm, id_base=1000)
    _assert_topk_close(got[0].numpy(), got[1].numpy(), *want)


def test_sharded_search_errors_pinned(mesh, data):
    vecs, queries = data
    with pytest.raises(ValueError, match="padding sentinel would destroy"):
        tsc.SearchSession(vecs, tsc.SearchConfig(
            sharded=True, backend="int8", mesh=mesh), device="cpu")
    eng = get_retrieval_engine("exact").__class__(backend="int8")
    index = eng.build(prng_key(0), torch.from_numpy(vecs))
    with pytest.raises(ValueError,
                       match="use backend='torch' or 'cuda' for sharded"):
        tsharded.sharded_search(eng, index, torch.from_numpy(queries), k=3,
                                mesh=mesh)

    class FaissEngine:
        name = "faiss"
        backend = "torch"

    with pytest.raises(ValueError, match="sharded search plan"):
        tsharded.sharded_search(FaissEngine(), torch.from_numpy(vecs),
                                torch.from_numpy(queries), k=3, mesh=mesh)
    corpus = ShardedCorpus.from_host(vecs, mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="shard-local build plan"):
        tsharded.sharded_build(FaissEngine(), corpus)
    # the born path takes int8 (per-shard scales + float rerank)
    session = tsc.SearchSession(vecs, tsc.SearchConfig(
        backend="int8", streamed=True, mesh=mesh), device="cpu")
    assert session.search(queries, k=3).shape == (queries.shape[0], 3)
    via_corpus = tsc.SearchSession(corpus, tsc.SearchConfig(), device="cpu")
    assert via_corpus.corpus_size == vecs.shape[0]
    assert np.array_equal(via_corpus.search(queries, k=4),
                          session.__class__(vecs, tsc.SearchConfig(
                              streamed=True, mesh=mesh),
                              device="cpu").search(queries, k=4))


def test_sharded_paths_need_a_mesh_and_an_ell_engine(data, corpus, mesh):
    vecs, _ = data
    with pytest.raises(ValueError, match="streamed build needs a mesh"):
        tsc.SearchSession(vecs, tsc.SearchConfig(streamed=True),
                          device="cpu")
    kw = dict(num_queries=corpus.num_queries,
              num_entities=corpus.num_entities, device="cpu")
    with pytest.raises(ValueError, match="streamed sampling needs a mesh"):
        SamplerSession(corpus.qrels, spec=SamplerSpec(engine="ell",
                                                      streamed=True), **kw)
    with pytest.raises(ValueError, match="ELL-family engine"):
        SamplerSession(corpus.qrels, spec=SamplerSpec(
            engine="sort", sharded=True, mesh=mesh), **kw)
    with pytest.raises(ValueError, match="ELL-family engine"):
        sp.sharded_graph_and_labels(
            _torch_table(corpus.qrels), num_queries=corpus.num_queries,
            num_entities=corpus.num_entities,
            config=WindTunnelConfig(engine="sort"), mesh=mesh)


def test_build_peak_gauge_recorded_on_sharded_builds(monkeypatch, mesh,
                                                     data, corpus):
    """Both sharded builds publish ``build.peak_bytes_per_device`` (the
    CPU has no reading, so the card's is stood in for)."""
    vecs, _ = data
    monkeypatch.setattr(obs_memory, "bytes_per_device",
                        lambda: {"cuda:0": 12345})
    gauge = REGISTRY.gauge(obs_memory.PEAK_GAUGE)
    gauge.set(0)
    tsc.SearchSession(vecs, tsc.SearchConfig(streamed=True, mesh=mesh),
                      device="cpu")
    assert gauge.value == 12345
    gauge.set(0)
    SamplerSession(corpus.qrels, num_queries=corpus.num_queries,
                   num_entities=corpus.num_entities, device="cpu",
                   spec=SamplerSpec(engine="ell", streamed=True,
                                    mesh=mesh)).labels()
    assert gauge.value == 12345


# -- the CLIs ---------------------------------------------------------------------

@pytest.mark.parametrize("flag", ["--sharded", "--streamed"])
def test_sharded_sample_clis_write_equal_npz(tmp_path, flag):
    args = ["--queries", "128", "--qrels-per-query", "8", "--topics", "12",
            "--quiet"]
    single = tsample.main(args + ["--engine", "ell", "--device", "cpu",
                                  "--out", str(tmp_path / "single")])
    stats = tsample.main(args + ["--engine", "ell", "--device", "cpu", flag,
                                 "--mesh", "host", "--stream-chunk", "300",
                                 "--out", str(tmp_path / "sharded")])
    a = np.load(tmp_path / "single" / "sample.npz")
    b = np.load(tmp_path / "sharded" / "sample.npz")
    for key in ("entity_mask", "labels", "qrel_valid"):
        assert np.array_equal(a[key], b[key]), key
    assert stats == single and stats["edges"] > 0
    with pytest.raises(SystemExit):
        tsample.main(args + ["--device", "cpu", flag])   # sort on the CPU


@pytest.mark.parametrize("flag", ["--sharded", "--streamed"])
def test_sharded_evaluate_cli_equal_grid(tmp_path, flag):
    args = ["--grid", "smoke", "--device", "cpu", "--queries", "128",
            "--vocab", "256", "--quiet", "--no-backend-curve"]
    single = tevaluate.main(args)
    sharded = tevaluate.main(args + [flag, "--mesh", "host",
                                     "--json", str(tmp_path / "e.json")])
    assert sharded["grid"] == single["grid"]
    assert sharded["fidelity"] == single["fidelity"]
    assert (tmp_path / "e.json").exists()


# -- two ranks --------------------------------------------------------------------

_TWO_RANK_SCRIPT = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

rank, store = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank,
                        world_size=2)
mesh = DeviceMesh("cpu", torch.arange(2).reshape(2, 1),
                  mesh_dim_names=("data", "model"))

from repro_torch.core import SamplerSession, SamplerSpec
from repro_torch.core.distributed import verify_against_single_device
from repro_torch.core.graph_builder import QRelTable
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.compression import compressed_grad_allreduce
from repro_torch.retrieval.search_core import SearchConfig, SearchSession

assert coll.flat_axis_index(mesh, ("data", "model")) == rank
rng = np.random.default_rng(0)
cpu = dict(device="cpu")

def same_sets(vecs, queries, k, **cfg):
    for backend in ("torch", "int8"):
        ref = SearchSession(vecs, SearchConfig(backend=backend, **cfg), **cpu)
        for extra in ({"streamed": True},) + (
                ({"sharded": True},) if backend == "torch" else ()):
            got = SearchSession(vecs, SearchConfig(backend=backend, mesh=mesh,
                                                   **extra, **cfg), **cpu)
            a = np.sort(ref.search(queries, k=k), 1)
            b = np.sort(got.search(queries, k=k), 1)
            assert np.array_equal(a, b), (cfg, backend, extra, a, b)

# every engine, uneven shards (N=97), ivfflat with every list probed
vecs = rng.standard_normal((97, 16)).astype(np.float32)
queries = rng.standard_normal((7, 16)).astype(np.float32)
for engine in ("exact", "tfidf", "lsh", "ivfflat"):
    opts = {"n_lists": 4, "nprobe": 4} if engine == "ivfflat" else None
    same_sets(vecs, queries, 5, engine=engine, engine_opts=opts)
# tiny corpus: the shard pad dominates (N=5 over 2 shards)
same_sets(rng.standard_normal((5, 8)).astype(np.float32),
          rng.standard_normal((3, 8)).astype(np.float32), 5)
# all-negative scores: pad sentinels must not displace real rows
same_sets(-np.abs(rng.standard_normal((9, 8))).astype(np.float32) - 1.0,
          np.abs(rng.standard_normal((3, 8))).astype(np.float32), 4)

# sampler: labels and draws bit-equal to one rank, born and legacy
nq, ne, nnz = 40, 121, 500
qrels = QRelTable(*(torch.from_numpy(x) for x in (
    rng.integers(0, nq, nnz).astype(np.int32),
    rng.integers(0, ne, nnz).astype(np.int32),
    rng.random(nnz).astype(np.float32), rng.random(nnz) < 0.9)))
kw = dict(num_queries=nq, num_entities=ne, **cpu)
single = SamplerSession(qrels, spec=SamplerSpec(engine="ell"), **kw)
for spec in (SamplerSpec(engine="ell", sharded=True, mesh=mesh),
             SamplerSpec(engine="ell", streamed=True, mesh=mesh)):
    s = SamplerSession(qrels, spec=spec, **kw)
    for a, b in zip(s.labels(), single.labels()):
        assert torch.equal(a, b)
    assert torch.equal(s.graph()[1], single.graph()[1])
    for seed in (0, 5):
        assert torch.equal(s.draw(seed=seed).entity_mask,
                           single.draw(seed=seed).entity_mask)

# distributed LP on node blocks
n, k = 64, 6
nbr = torch.from_numpy(rng.integers(-1, n, (n, k)).astype(np.int32))
wgt = torch.where(nbr >= 0, torch.from_numpy(
    rng.random((n, k)).astype(np.float32)), 0.0)
assert verify_against_single_device(mesh, nbr, wgt, rounds=4)

# compressed all-reduce over a 2-rank pod axis: the mean of the ranks'
# dequantized leaves; collectives' shard order
pod = DeviceMesh("cpu", torch.arange(2).reshape(2, 1, 1),
                 mesh_dim_names=("pod", "data", "model"))
g = torch.full((4,), float(rank + 1))
mean, err = compressed_grad_allreduce({"g": g}, {"g": torch.zeros(4)}, pod)
assert torch.equal(mean["g"], torch.full((4,), 1.5)), mean
got = coll.all_gather(torch.tensor([rank, rank]), mesh, ("data", "model"))
assert got.tolist() == [0, 0, 1, 1]
piece = coll.psum_scatter_then_gather(torch.arange(4.0), mesh, "data")
assert piece.tolist() == ([0.0, 2.0] if rank == 0 else [4.0, 6.0])

# live ingest: a streamed LiveIndex with appends and background compactions
# (their collectives on the index's own group, each landed once both ranks
# built it) answers set-equal to a single-device one after every append
from repro_torch.obs.metrics import Registry
from repro_torch.serve import IngestConfig, LiveIndex
for engine in ("exact", "tfidf"):
    rows = np.abs(rng.standard_normal((97 + 60, 16))).astype(np.float32)
    if engine == "tfidf":
        rows[rows < 0.8] = 0.0
    else:
        rows -= 0.7
    base, extra, q = rows[:97], rows[97:], rows[:5] + 0.01
    reg = Registry()
    born = LiveIndex(base, SearchConfig(engine=engine, streamed=True,
                                        mesh=mesh),
                     ingest=IngestConfig(append_cap=8, compact_threshold=18),
                     registry=reg, **cpu)
    one = LiveIndex(base, SearchConfig(engine=engine),
                    ingest=IngestConfig(append_cap=8, compact_threshold=18,
                                        background=False), **cpu)
    for i in range(0, 60, 6):
        for li in (born, one):
            li.append(extra[i:i + 6])
        for _ in range(2):
            a = np.sort(born.search(q, k=7), 1)
            b = np.sort(one.search(q, k=7), 1)
            assert np.array_equal(a, b), (engine, i, a, b)
    born.flush()
    assert born.n == one.n == 157
    assert reg.counter("serve.ingest.compactions").value >= 1
    assert np.array_equal(np.sort(born.search(q, k=7), 1),
                          np.sort(one.search(q, k=7), 1))

# on several ranks a finished build lands at a call point, never from the
# worker: joined, it waits in _built until the next call lands it on both
born = LiveIndex(base, SearchConfig(streamed=True, mesh=mesh),
                 ingest=IngestConfig(append_cap=8, compact_threshold=6),
                 **cpu)
born.append(extra[:6])
born._compactor.join(timeout=60)
assert born._built is not None and born.frozen_n == 97
born.flush()
assert born._built is None and born.frozen_n == 103
born.close()

# tenant churn: each eviction closes its streamed index, whose compaction
# groups the next build takes (the same on both ranks, so no new groups
# past the second build), and each index's compaction lands on both ranks
from repro_torch.serve import TenantCache
cfg = SearchConfig(streamed=True, mesh=mesh)
cache = TenantCache(
    lambda t: LiveIndex(base + t, cfg, registry=reg, ingest=IngestConfig(
        append_cap=8, compact_threshold=6), **cpu), capacity=1,
    registry=reg)
n_groups = []
for t in (0, 1, 2, 0, 1):
    born = cache.get(t)
    one = LiveIndex(base + t, SearchConfig(), **cpu)
    for li in (born, one):
        li.append(extra[:6])
    assert np.array_equal(np.sort(born.search(q, k=7), 1),
                          np.sort(one.search(q, k=7), 1)), t
    n_groups.append(len(dist.distributed_c10d._world.pg_map))
cache.flush()
assert born.frozen_n == 103 and born.config.mesh is mesh
assert len(set(n_groups[1:])) == 1, n_groups

# the recsys and GNN cells across ranks (held to the reference on 2 x 2
# and pod meshes by tests/test_torch_recsys_ranks.py and
# tests/test_torch_mace_ranks.py): on this mesh a DCN-v2 retrieval (the
# table rows over 'data') and a MACE train step (nodes and edges over
# 'data') equal one rank's; the LM's builds (its steps across ranks:
# tests/test_torch_lm_ranks.py)
from repro_torch.distributed import sharding as sh
from repro_torch.launch.cells import build_cell
from repro_torch.launch.dryrun import MeshShape
from repro_torch.launch.train import _batch_like, initial_params, step_batch
from repro_torch.train.optimizer import adamw_init, tree_leaves, tree_map
one = MeshShape(("data", "model"), (1, 1))


def placed_like(cell, i, tree):
    return sh.place_tree(tree, mesh, tree_map(lambda s: s.placements,
                                              cell.args[i]))


ret, ret1 = (build_cell("dcn-v2", "retrieval_cand", m, reduced=True)
             for m in (mesh, one))
p = initial_params(ret1, 0, "cpu")
q = _batch_like(ret1.args[1], np.random.default_rng(3), "cpu")
cand = (torch.arange(ret1.args[2].shape[0]) % 256).to(torch.int32)
s1, i1 = ret1.fn(p, q, cand)
s2, i2 = ret.fn(placed_like(ret, 0, p), placed_like(ret, 1, q),
                sh.place(cand, mesh, ret.args[2].placements))
assert torch.equal(sh.full_tensor(i2), i1)
assert torch.allclose(sh.full_tensor(s2), s1, rtol=1e-5, atol=1e-6)
tr, tr1 = (build_cell("mace", "molecule", m, reduced=True)
           for m in (mesh, one))
p = initial_params(tr1, 0, "cpu")
o = adamw_init(p)
pp, po = placed_like(tr, 0, p), {
    "m": placed_like(tr, 0, o["m"]), "v": placed_like(tr, 0, o["v"]),
    "step": sh.place(o["step"], mesh, tr.args[1]["step"].placements)}
for step in range(2):
    b = step_batch(tr1, step, "cpu")
    p, o, l1 = tr1.fn(p, o, b)
    pp, po, l2 = tr.fn(pp, po, placed_like(tr, 2, b))
    assert torch.allclose(l2, l1, rtol=1e-4, atol=1e-5), (l2, l1)
for a, b in zip(tree_leaves(pp), tree_leaves(p)):
    assert torch.allclose(sh.full_tensor(a), b, rtol=0, atol=2e-5)
assert build_cell("gemma-2b", "train_4k", mesh, reduced=True).kind == "train"
print("TWO-RANK-OK", rank)
"""


def test_two_ranks_gloo(tmp_path):
    """Two processes in one gloo group: labels bit-equal to one rank, every
    engine's top-k set-equal at the reference's options (int8 on the born
    plan), uneven / tiny / all-negative padding, the compressed
    all-reduce's mean, and a streamed live index with appends and
    background compactions set-equal to a single-device one, also across
    tenant evictions that hand its compaction groups to the next build;
    a DCN-v2 retrieval and two MACE train steps on the two ranks equal
    one rank's, and an LM cell builds."""
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    store = str(tmp_path / "store")
    procs = [subprocess.Popen([sys.executable, "-c", _TWO_RANK_SCRIPT,
                               str(r), store], env=env, text=True,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TWO_RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out
        assert f"TWO-RANK-OK {r}" in out
