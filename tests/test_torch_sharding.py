"""The port's distributed package (``repro_torch.distributed``,
``launch/mesh.py``) against the JAX package's on the CPU.

The reference runs on its 1-device host mesh, the port on a 1-rank gloo
group (``make_host_mesh(device="cpu")``); the same numpy inputs, made from
a seed, go through both: sharding rules give the same PartitionSpec
entries, the compression functions the same bits, and the streamed
buffers the same rows. Two ranks are covered by
``tests/test_torch_sharded.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from repro.core import graph_builder as jgb
from repro.distributed import collectives as jcoll
from repro.distributed import compression as jcomp
from repro.distributed import sharding as jsh
from repro.distributed.sharded_corpus import ShardedCorpus as JCorpus
from repro.distributed.sharded_corpus import ShardedQRels as JQRels
from repro.launch import mesh as jmesh
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import compression as comp
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharded_corpus import (ShardedCorpus,
                                                    ShardedQRels,
                                                    resolve_corpus_axes,
                                                    resolve_query_axes,
                                                    sharded_row_buffer,
                                                    stream_to_sharded)
from repro_torch.launch import mesh as tmesh

RULES = ("LM_RULES", "RECSYS_RULES", "GNN_RULES", "RETRIEVAL_RULES")
AXES = {"host": ("data", "model"), "pod": ("pod", "data", "model")}


@pytest.fixture(scope="module")
def mesh():
    return tmesh.make_host_mesh(device="cpu")


@pytest.fixture(scope="module")
def meshes(mesh):
    """(port, reference) 1-device meshes with the host and pod names."""
    pod = DeviceMesh("cpu", torch.arange(1).reshape(1, 1, 1),
                     mesh_dim_names=AXES["pod"])
    return {"host": (mesh, jmesh.make_host_mesh()),
            "pod": (pod, jax.make_mesh((1, 1, 1), AXES["pod"]))}


# -- sharding rules ------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(AXES))
@pytest.mark.parametrize("rules", RULES)
def test_logical_to_spec_equals_reference(meshes, kind, rules):
    port, ref = meshes[kind]
    table = getattr(sh, rules)
    assert table == getattr(jsh, rules)
    names = tuple(table) + ("not_a_rule",)
    for name in names:
        want = tuple(jsh.logical_to_spec(ref, (name,), table))
        assert sh.logical_to_spec(port, (name,), table) == want, name
        assert sh.partition_axes(port, name, table) == \
            jsh.partition_axes(ref, name, table)
    assert sh.logical_to_spec(port, names, table) == \
        tuple(jsh.logical_to_spec(ref, names, table))
    assert sh.logical_to_spec(port, None, table) == ()


def test_tree_shardings_and_shaped(meshes):
    port, ref = meshes["pod"]
    tree = {"w": ("embed", "ffn"), "b": None, "x": ("batch", "seq")}
    got = sh.tree_shardings(port, tree, sh.LM_RULES)
    want = jsh.tree_shardings(ref, tree, jsh.LM_RULES)
    for key in tree:
        spec = tuple(want[key].spec)
        assert got[key] == sh.placements(port, spec)
    # embed -> data (dim 0), ffn -> model (dim 1), batch -> (pod, data)
    assert got["w"] == (Replicate(), Shard(0), Shard(1))
    assert got["b"] == (Replicate(),) * 3
    assert got["x"] == (Shard(0), Shard(0), Replicate())
    s = sh.shaped((4, 8), torch.float32, port, ("embed", "ffn"), sh.LM_RULES)
    assert s.shape == (4, 8) and s.placements == got["w"]


# -- compression ---------------------------------------------------------------

def _grads(seed, shape=(33, 17)):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(shape) * 10.0 ** rng.integers(-3, 3)).astype(
        np.float32)
    e = (rng.standard_normal(shape) * 1e-3).astype(np.float32)
    return g, e


@pytest.mark.parametrize("seed", range(3))
def test_compression_bit_equal(seed):
    g, e = _grads(seed)
    q, s = comp.quantize_int8(torch.from_numpy(g))
    jq, js = jcomp.quantize_int8(jnp.asarray(g))
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    assert np.array_equal(comp.dequantize_int8(q, s).numpy(),
                          np.asarray(jcomp.dequantize_int8(jq, js)))
    got = comp.compress_leaf(torch.from_numpy(g), torch.from_numpy(e))
    want = jcomp.compress_leaf(jnp.asarray(g), jnp.asarray(e))
    for a, b in zip(got, want):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()
    for frac in (0.01, 0.2):
        got = comp.topk_sparsify(torch.from_numpy(g), torch.from_numpy(e),
                                 frac)
        want = jcomp.topk_sparsify(jnp.asarray(g), jnp.asarray(e), frac)
        for a, b in zip(got, want):
            assert a.numpy().tobytes() == np.asarray(b).tobytes()
    z = comp.ef_init({"a": torch.ones(3, 2, dtype=torch.bfloat16)})
    assert z["a"].dtype == torch.float32 and not z["a"].any()


def test_compressed_grad_allreduce_bit_equal(meshes):
    port, _ = meshes["pod"]
    g, e = _grads(7)
    g2, e2 = _grads(8, (5,))
    jm = jax.make_mesh((1,), ("pod",))
    fn = jax.shard_map(jcomp.compressed_grad_allreduce, mesh=jm,
                       in_specs=(P(), P()), out_specs=(P(), P()))
    want_g, want_e = fn({"a": jnp.asarray(g), "b": jnp.asarray(g2)},
                        {"a": jnp.asarray(e), "b": jnp.asarray(e2)})
    got_g, got_e = comp.compressed_grad_allreduce(
        {"a": torch.from_numpy(g), "b": torch.from_numpy(g2)},
        {"a": torch.from_numpy(e), "b": torch.from_numpy(e2)}, port)
    for key in ("a", "b"):
        assert got_g[key].numpy().tobytes() == \
            np.asarray(want_g[key]).tobytes()
        assert got_e[key].numpy().tobytes() == \
            np.asarray(want_e[key]).tobytes()


# -- collectives on one rank ------------------------------------------------------

def test_collectives_one_rank(mesh):
    axes = ("data", "model")
    assert coll.flat_axis_index(mesh, axes) == 0
    assert coll.axis_size(mesh, axes) == 1
    x = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    tree = {"x": x, "m": x > 4}
    got = coll.all_concat(tree, mesh, axes)
    assert torch.equal(got["x"], x) and torch.equal(got["m"], x > 4)
    assert torch.equal(coll.all_gather(x, mesh, axes, dim=1), x)
    assert torch.equal(coll.unvary_compat(x, mesh, axes), x)
    assert coll.pvary_compat(x, axes) is x
    pieces = coll.psum_scatter_then_gather(x, mesh, "data", scatter_dim=1)
    assert torch.equal(coll.gather_after_update(pieces, mesh, "data",
                                                gather_dim=1), x)
    assert torch.equal(coll.all_reduce(x, mesh, axes, "max"), x)


def test_microbatch_grads_equal_reference():
    rng = np.random.default_rng(4)
    w = rng.standard_normal((3, 2)).astype(np.float32)
    xs = rng.standard_normal((4, 5, 3)).astype(np.float32)
    loss_t = lambda p, mb: ((mb @ p["w"]) ** 2).sum()
    loss_j = lambda p, mb: jnp.sum((mb @ p["w"]) ** 2)
    got = coll.microbatch_grads(loss_t, {"w": torch.from_numpy(w)},
                                torch.from_numpy(xs))
    want = jcoll.microbatch_grads(loss_j, {"w": jnp.asarray(w)},
                                  jnp.asarray(xs))
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]),
                               rtol=1e-6)


# -- streaming and the born containers --------------------------------------------

@pytest.mark.parametrize("chunk", [1, 2, 5, 64])
def test_stream_to_sharded_chunked_equals_host(mesh, chunk):
    host = np.arange(7 * 3, dtype=np.float32).reshape(7, 3)
    got = stream_to_sharded(host, mesh, ("data", "model"), 8, device="cpu",
                            chunk_rows=chunk, span="search.build.shard")
    assert np.array_equal(got[:7].numpy(), host)
    assert (got[7:] == 0).all()
    buf = sharded_row_buffer(host[:3], capacity=5, dim=3, mesh=mesh,
                             chunk_rows=chunk, device="cpu")
    assert buf.shape == (5, 3) and np.array_equal(buf[:3].numpy(), host[:3])
    assert (buf[3:] == 0).all()
    with pytest.raises(ValueError, match="exceed the buffer"):
        sharded_row_buffer(host, capacity=5, dim=3, mesh=mesh, device="cpu")


def test_sharded_corpus_geometry_equals_reference(mesh):
    vecs = np.random.default_rng(0).standard_normal((299, 16)).astype(
        np.float32)
    got = ShardedCorpus.from_host(vecs, mesh=mesh, chunk_rows=64,
                                  device="cpu")
    want = JCorpus.from_host(vecs, mesh=jmesh.make_host_mesh(),
                             chunk_rows=64)
    for attr in ("n", "num_shards", "rows_per_shard", "dim", "pad", "axes"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert np.array_equal(got.vecs.numpy(), np.asarray(want.vecs))
    with pytest.raises(ValueError, match="2-D"):
        ShardedCorpus.from_host(vecs[0], mesh=mesh, device="cpu")


@pytest.mark.parametrize("seed", range(3))
def test_sharded_qrels_buffers_equal_reference(mesh, seed):
    rng = np.random.default_rng(3 + seed)
    nq, ne, nnz = 17, 50, 120
    q = rng.integers(0, nq, nnz).astype(np.int32)
    e = rng.integers(0, ne, nnz).astype(np.int32)
    s = rng.random(nnz).astype(np.float32)
    v = rng.random(nnz) < 0.8
    got = ShardedQRels.from_host(jgb.QRelTable(q, e, s, v), num_queries=nq,
                                 num_entities=ne, mesh=mesh, chunk_rows=16,
                                 device="cpu")
    want = JQRels.from_host(jgb.QRelTable(q, e, s, v), num_queries=nq,
                            num_entities=ne, mesh=jmesh.make_host_mesh(),
                            chunk_rows=16)
    for f in ("query_ids", "entity_ids", "scores", "valid"):
        assert np.array_equal(getattr(got, f).numpy(),
                              np.asarray(getattr(want, f))[0]), f
    for attr in ("num_shards", "buffer_rows", "queries_per_shard", "axes"):
        assert getattr(got, attr) == getattr(want, attr), attr
    tab = got.table()
    ok = tab.valid.numpy()
    assert sorted(zip(tab.query_ids.numpy()[ok], tab.entity_ids.numpy()[ok],
                      tab.scores.numpy()[ok])) == sorted(zip(q[v], e[v],
                                                             s[v]))


# -- meshes and their errors ------------------------------------------------------

def test_mesh_helpers_and_errors(mesh):
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == (1, 1)
    assert tmesh.make_host_mesh(device="cpu").mesh_dim_names == \
        ("data", "model")
    auto = tmesh.parse_mesh("auto", device="cpu")
    assert tuple(auto.shape) == (1, 1)
    assert tmesh.batch_axes(mesh) == jmesh.batch_axes(jmesh.make_host_mesh())
    assert tmesh.is_main_rank()
    with pytest.raises(ValueError, match="unknown mesh"):
        tmesh.parse_mesh("bogus", device="cpu")
    with pytest.raises(ValueError, match="needs 2 ranks"):
        tmesh.make_host_mesh(model_axis=2, device="cpu")
    with pytest.raises(ValueError, match="needs 256 ranks"):
        tmesh.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="needs 512 ranks"):
        tmesh.make_production_mesh(multi_pod=True, device="cpu")
    pod_only = DeviceMesh("cpu", torch.arange(1), mesh_dim_names=("pod",))
    with pytest.raises(ValueError, match="retrieval corpus axes"):
        resolve_corpus_axes(pod_only, None)
    with pytest.raises(ValueError, match="GNN query axes"):
        resolve_query_axes(pod_only, None)
    assert resolve_corpus_axes(mesh, None) == ("data", "model")
