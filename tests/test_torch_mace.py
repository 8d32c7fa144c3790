"""The port's MACE (``models/mace.py``, ``models/so3.py``), its cells, the
neighbour sampler and ``prng.randint`` against the JAX package on the CPU.

The reference's ``mace_forward``, ``mace_energy_forces``, ``mace_loss`` and
``mace_node_loss`` are called directly with ``act_grid_axes=None``: its
cells set ``act_grid_axes`` and then fail on ``with_sharding_constraint``
over jax 0.9's Explicit mesh axes (the three ``test_arch_smoke[mace-*]``
cases), so the port's cells are held to their stated invariant (one step,
no NaN) instead. Tolerances, with their reasons:

* inits, graph batches, CG tensors, sampler blocks, ``randint``, flop
  counts, specs, the donated AdamW step against the functional one and
  checkpoints across the packages: equal;
* energies and forces: 1e-5 absolute, the reference's own equivariance
  tolerance (``tests/test_models.py``); losses and gradients: rtol 1e-4,
  atol 1e-5 (a second-order gradient through checkpointed layers, summed
  in another order; as ``tests/test_torch_train.py``).
"""
import contextlib
import dataclasses
import functools
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data.neighbor_sampler import NeighborSampler as JSampler
from repro.launch import cells as jcells
from repro.launch import mesh as jmesh
from repro.launch import train as jtrain
from repro.models import mace as jm
from repro.models import so3 as jso3
from repro.train import checkpoint as jck
from repro.train import optimizer as jopt
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.core import prng
from repro_torch.data import NeighborSampler
from repro_torch.distributed.sharding import placements
from repro_torch.launch import cells
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as ttrain
from repro_torch.models import mace as tm
from repro_torch.models import so3 as tso3
from repro_torch.train import checkpoint as ck
from repro_torch.train import optimizer as topt

EF_ATOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
_DTYPES = {jnp.dtype(jnp.float32): torch.float32,
           jnp.dtype(jnp.int32): torch.int32,
           jnp.dtype(jnp.bool_): torch.bool}

jadamw = jax.jit(jopt.adamw_update, static_argnums=3)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's ops on one thread: these tensors are small (see
    ``tests/test_torch_decoder.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def mesh():
    return tmesh.make_host_mesh(device="cpu")


def _cfgs(**kw):
    """The reduced config in both packages, with ``kw`` replaced."""
    jcfg = dataclasses.replace(jconfigs.get_arch("mace").make_reduced(), **kw)
    tcfg = dataclasses.replace(tconfigs.get_arch("mace").make_reduced(),
                               **kw)
    return jcfg, tcfg


def _pair(seed=0, n_nodes=24, n_edges=80, n_graphs=3, **kw):
    jcfg, tcfg = _cfgs(**kw)
    jp = jm.init_mace(jax.random.PRNGKey(seed), jcfg)
    jb = jm.random_graph_batch(jax.random.PRNGKey(seed + 1), n_nodes=n_nodes,
                               n_edges=n_edges, d_feat=jcfg.d_feat,
                               n_graphs=n_graphs)
    tb = {k: (v if k == "n_graphs" else torch.from_numpy(np.array(v)))
          for k, v in jb.items()}
    return jcfg, tcfg, jp, interop.model_params(jp), jb, tb


def _close_trees(got, want, **tol):
    g_leaves, w_leaves = topt.tree_leaves(got), jax.tree.leaves(want)
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        np.testing.assert_allclose(interop.to_numpy(g), np.asarray(w), **tol)


# --------------------------------------------------------------------------
# draws: randint, init, graph batches
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape,lo,hi", [
    ((1000,), 0, 30), ((7, 5), -5, 100_000), ((4096,), 0, 2 ** 31 - 1),
    ((100,), 5, 5), ((300,), -2 ** 31, 2 ** 31 - 1), ((64,), 10, 3),
    ((513,), 0, 65_537)])
def test_randint_is_jaxs_bit_for_bit(shape, lo, hi):
    """Spans below and above 2**16 (where the uint32 multiplier wraps to
    0), the whole int32 range and empty ranges."""
    for seed in (0, 7):
        want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape,
                                             lo, hi))
        got = prng.randint(prng.prng_key(seed), shape, lo, hi)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("which", ["reduced", "published"])
def test_init_is_the_references_bit_for_bit(which):
    spec_j, spec_t = jconfigs.get_arch("mace"), tconfigs.get_arch("mace")
    make = "make_reduced" if which == "reduced" else "make_config"
    want = jm.init_mace(jax.random.PRNGKey(4), getattr(spec_j, make)())
    got = tm.init_mace(prng.prng_key(4), getattr(spec_t, make)(),
                       device="cpu")
    assert jax.tree.structure(interop.model_params(want)) == \
        jax.tree.structure(got)
    assert sorted(got["layers_list"][0]["mix"]) == [0, 1, 2]
    for g, w in zip(topt.tree_leaves(got), jax.tree.leaves(want)):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_random_graph_batch_is_the_references_bit_for_bit():
    want = jm.random_graph_batch(jax.random.PRNGKey(5), n_nodes=50,
                                 n_edges=300, d_feat=6, n_graphs=4)
    got = tm.random_graph_batch(prng.prng_key(5), n_nodes=50, n_edges=300,
                                d_feat=6, n_graphs=4, device="cpu")
    assert got["n_graphs"] == want["n_graphs"] == 4
    for key in want:
        if key != "n_graphs":
            assert np.array_equal(got[key].numpy(), np.asarray(want[key])), key


def test_so3_tables_are_the_references():
    assert tso3.valid_paths() == jso3.valid_paths() and \
        len(tso3.valid_paths()) == 15
    for path in tso3.valid_paths():
        assert np.array_equal(tso3.real_clebsch_gordan(*path),
                              jso3.real_clebsch_gordan(*path))
    v = np.random.default_rng(0).normal(size=(40, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    want = jso3.spherical_harmonics(jnp.asarray(v), jnp)
    for got in (tso3.spherical_harmonics(torch.from_numpy(v), torch),
                tso3.spherical_harmonics(v, np)):
        for l in want:
            np.testing.assert_allclose(interop.to_numpy(got[l]),
                                       np.asarray(want[l]), rtol=0,
                                       atol=1e-6)


# --------------------------------------------------------------------------
# energies, forces, losses
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_energy_forces(**kw):
    """The reference's energies and forces of ``_pair(**kw)`` (jitted
    once a config)."""
    jcfg, _, jp, _, jb, _ = _pair(**kw)
    g = jb.pop("n_graphs")
    fn = jax.jit(lambda p, b: jm.mace_energy_forces(p, dict(b, n_graphs=g),
                                                    jcfg))
    return tuple(np.asarray(x) for x in fn(jp, jb))


@pytest.mark.parametrize("variant", [
    {}, {"remat": False}, {"fused_scatter": True}, {"correlation": 2}],
    ids=["default", "no-remat", "fused", "correlation-2"])
def test_energy_and_forces_match_reference(variant):
    """The port's remat, scatter and correlation variants against the
    reference (remat and the fused scatter change no value there)."""
    _, tcfg, _, tp, _, tb = _pair(**variant)
    je, jf = _ref_energy_forces(correlation=tcfg.correlation)
    with torch.no_grad():
        te, tf_ = tm.mace_energy_forces(tp, tb, tcfg)
    assert te.shape == (3,) and tf_.shape == (24, 3)
    np.testing.assert_allclose(te.numpy(), je, rtol=0, atol=EF_ATOL)
    np.testing.assert_allclose(tf_.numpy(), jf, rtol=0, atol=EF_ATOL)


def _targets(jb, tb, keys_shapes, seed):
    rng = np.random.default_rng(seed)
    for key, shape in keys_shapes:
        x = rng.normal(size=shape).astype(np.float32)
        if key == "node_mask":
            x = (x > 0).astype(np.float32)
        jb[key], tb[key] = jnp.asarray(x), torch.from_numpy(x)


def test_energy_loss_gradient_is_second_order_and_matches_reference():
    """The train objective: forces in the loss, the parameters' gradient
    through them (second order, through the layer's checkpoint; one layer
    keeps the reference's compile short)."""
    jcfg, tcfg, jp, tp, jb, tb = _pair(seed=2, n_layers=1)
    _targets(jb, tb, [("energy_target", (3,)), ("force_target", (24, 3))], 3)
    g = jb.pop("n_graphs")
    jl, jg = jax.jit(lambda p, b: jax.value_and_grad(jm.mace_loss)(
        p, dict(b, n_graphs=g), jcfg))(jp, jb)
    loss, grads = cells.value_and_grad(tm.mace_loss, tp, tb, tcfg)
    np.testing.assert_allclose(loss.item(), float(jl), **GRAD_TOL)
    _close_trees(grads, jg, **GRAD_TOL)


def test_node_loss_and_gradient_match_reference():
    jcfg, tcfg, jp, tp, jb, tb = _pair(seed=3)
    _targets(jb, tb, [("node_target", (24,)), ("node_mask", (24,))], 4)
    g = jb.pop("n_graphs")
    jl, jg = jax.jit(lambda p, b: jax.value_and_grad(jm.mace_node_loss)(
        p, dict(b, n_graphs=g), jcfg))(jp, jb)
    loss, grads = cells.value_and_grad(tm.mace_node_loss, tp, tb, tcfg)
    np.testing.assert_allclose(loss.item(), float(jl), **GRAD_TOL)
    _close_trees(grads, jg, **GRAD_TOL)


def _rand_rot(seed):
    q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return torch.from_numpy(q.astype(np.float32))


def test_energy_invariant_and_forces_equivariant_under_rotation():
    """The port alone: E(R x) = E(x), F(R x) = F(x) R^T."""
    _, tcfg = _cfgs(channels=8, d_feat=8, n_rbf=4)
    params = tm.init_mace(prng.prng_key(0), tcfg, device="cpu")
    batch = tm.random_graph_batch(prng.prng_key(0), n_nodes=20, n_edges=60,
                                  d_feat=8, n_graphs=2, device="cpu")
    r = _rand_rot(2)
    with torch.no_grad():
        e, f = tm.mace_energy_forces(params, batch, tcfg)
        er, fr = tm.mace_energy_forces(
            params, {**batch, "positions": batch["positions"] @ r.T}, tcfg)
    np.testing.assert_allclose(er.numpy(), e.numpy(), rtol=0, atol=EF_ATOL)
    np.testing.assert_allclose(fr.numpy(), (f @ r.T).numpy(), rtol=0,
                               atol=EF_ATOL)


# --------------------------------------------------------------------------
# the neighbour sampler
# --------------------------------------------------------------------------

def _graph(seed, n=3000, m=40_000, tail=0):
    """Edges into every node but some in the middle (ids 5 mod 97) and the
    last ``tail`` (no in-edge)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n - tail, m).astype(np.int32)
    dst = dst[dst % 97 != 5]
    return src[:dst.shape[0]], dst, n


def test_neighbor_sampler_blocks_are_the_references_bit_for_bit():
    """Two draws in a row (the generator's state carries over), degree-0
    nodes in the middle of the id range included."""
    src, dst, n = _graph(6)
    got, want = NeighborSampler(src, dst, n, seed=3), JSampler(src, dst, n,
                                                               seed=3)
    rng = np.random.default_rng(7)
    for draw in range(2):
        nodes = rng.choice(n, 64, replace=False).astype(np.int32)
        nodes[0] = 5                          # no in-edge: masked
        gb, wb = got.sample(nodes, (15, 10)), want.sample(nodes, (15, 10))
        assert len(gb) == len(wb) == 2
        for g, w in zip(gb, wb):
            assert g.n_dst == w.n_dst
            for field in ("src_nodes", "edge_src", "edge_dst", "edge_mask"):
                a, b = getattr(g, field), getattr(w, field)
                assert a.dtype == b.dtype and np.array_equal(a, b), field
        assert gb[-1].n_dst == 64 and not gb[-1].edge_mask[:15].any()
        assert gb[-1].edge_mask[15:].any()


def test_neighbor_sampler_masks_a_last_node_with_no_edge():
    """One of the graph's last nodes, with no in-edge, in the batch: the
    reference's index runs past the edge list; the port masks its slots
    and samples the rest as the reference samples a batch without it."""
    src, dst, n = _graph(8, tail=200)
    nodes = np.array([n - 1, 10, 20], np.int32)
    with pytest.raises(IndexError):
        JSampler(src, dst, n, seed=1).sample(nodes, (4,))
    blk, = NeighborSampler(src, dst, n, seed=1).sample(nodes, (4,))
    assert not blk.edge_mask[:4].any() and blk.edge_mask[4:].all()
    assert blk.src_nodes[0] == n - 1 and blk.n_dst == 3


# --------------------------------------------------------------------------
# cells
# --------------------------------------------------------------------------

def test_mace_flops_equal_the_references():
    spec_j, spec_t = jconfigs.get_arch("mace"), tconfigs.get_arch("mace")
    for make in ("make_config", "make_reduced"):
        jcfg, tcfg = getattr(spec_j, make)(), getattr(spec_t, make)()
        for n_edges, n_nodes in ((64 * 128, 30 * 128), (179_200, 180_224),
                                 (61_859_140, 2_449_029), (256, 64)):
            assert cells.mace_flops(tcfg, n_edges, n_nodes) == \
                jcells.mace_flops(jcfg, n_edges, n_nodes)


def _spec_entries(sds):
    return tuple(sds.shape), _DTYPES[jnp.dtype(sds.dtype)], \
        tuple(sds.sharding.spec)


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_gnn_cell_specs_equal_the_references(mesh, reduced):
    """Every GNN shape: each argument's shape, dtype and placements, the
    kind, the donated arguments and the model flops."""
    jmesh_ = jmesh.make_host_mesh()
    for shape in tconfigs.GNN_SHAPES:
        got = cells.build_cell("mace", shape, mesh, reduced=reduced)
        want = jcells.build_cell("mace", shape, jmesh_, reduced=reduced)
        assert got.kind == want.kind == "train"
        assert got.donate == want.donate
        assert got.model_flops_per_step == want.model_flops_per_step
        for g_arg, w_arg in zip(got.args, want.args):
            g_leaves, w_leaves = topt.tree_leaves(g_arg), \
                jax.tree.leaves(w_arg)
            assert len(g_leaves) == len(w_leaves)
            for g, w in zip(g_leaves, w_leaves):
                shape_, dtype, spec = _spec_entries(w)
                assert (g.shape, g.dtype) == (shape_, dtype)
                assert g.placements == placements(mesh, spec)


@pytest.mark.parametrize("shape", list(tconfigs.GNN_SHAPES))
def test_gnn_cells_take_a_step_with_no_nan(mesh, shape):
    """The stated invariant of the reference's ``test_arch_smoke``: one
    train step of the reduced cell, a finite loss and finite parameters,
    every leaf updated in place."""
    cell = cells.build_cell("mace", shape, mesh, reduced=True)
    params = ttrain.initial_params(cell, 0, "cpu")
    opt = topt.adamw_init(params)
    ptrs = [t.data_ptr() for t in topt.tree_leaves(params)]
    params, opt, loss = cell.fn(params, opt, ttrain.step_batch(cell, 0,
                                                               "cpu"))
    assert np.isfinite(loss.item())
    assert all(torch.isfinite(t).all() for t in topt.tree_leaves(params))
    assert ptrs == [t.data_ptr() for t in topt.tree_leaves(params)]
    assert int(opt["step"]) == 1


def test_launcher_matches_reference_draw_and_steps(mesh):
    """``launch/train --arch mace``'s initial parameters are the reference
    launcher's draw bit for bit; 3 steps' losses match the reference's
    ``mace_node_loss`` and ``adamw_update`` composed directly on the same
    parameters and batches (its default shape, full_graph_sm)."""
    jcell = jcells.build_cell("mace", "full_graph_sm",
                              jmesh.make_host_mesh(), reduced=True)
    cell = cells.build_cell("mace", "full_graph_sm", mesh, reduced=True)
    want = jax.tree.map(lambda x: x * 0.02, jtrain._batch_like(
        jcell.args[0], 0, np.random.default_rng(0)))
    got = ttrain.initial_params(cell, 0, "cpu")
    for g, w in zip(topt.tree_leaves(got), jax.tree.leaves(want)):
        assert np.array_equal(g.numpy(), np.asarray(w))
    jcfg, _ = _cfgs(act_grid_axes=None)
    jloss_grad = jax.jit(lambda p, b: jax.value_and_grad(jm.mace_node_loss)(
        p, dict(b, n_graphs=1), jcfg))
    jparams, jstate = want, jopt.adamw_init(want)
    wlosses = []
    for step in range(3):
        batch = jtrain._batch_like(jcell.args[2], step,
                                   np.random.default_rng(step))
        for g, w in zip(topt.tree_leaves(ttrain.step_batch(cell, step,
                                                           "cpu")),
                        jax.tree.leaves(batch)):
            assert np.array_equal(g.numpy(), np.asarray(w))
        loss, g = jloss_grad(jparams, batch)
        jparams, jstate, _ = jadamw(g, jstate, jparams, jopt.AdamWConfig())
        wlosses.append(float(loss))
    with contextlib.redirect_stdout(io.StringIO()):
        losses = ttrain.main(["--arch", "mace", "--steps", "3", "--device",
                              "cpu"])
    np.testing.assert_allclose(losses, wlosses, **GRAD_TOL)


def test_launcher_resumes_mace_bit_equal(tmp_path):
    run = lambda steps, d: ttrain.main(
        ["--arch", "mace", "--steps", str(steps), "--device", "cpu",
         "--checkpoint-dir", str(tmp_path / d)])
    with contextlib.redirect_stdout(io.StringIO()) as out:
        first, second, whole = run(4, "a"), run(7, "a"), run(7, "b")
    assert "resumed from step 4" in out.getvalue()
    assert first + second == whole and np.isfinite(whole).all()


@pytest.mark.parametrize("scale", [1.0, 1e-4], ids=["clipped", "unclipped"])
def test_donated_update_on_a_mace_tree_is_the_functional_one(scale):
    """``layers_list`` and int-keyed ``mix``: ``adamw_update_`` writes
    ``adamw_update``'s values bit for bit, no leaf moved."""
    _, tcfg = _cfgs()
    shapes = tm.init_mace(prng.prng_key(0), tcfg, device="meta")
    rng = np.random.default_rng(12)

    def draw(positive=False):
        return topt.tree_map(lambda s: torch.from_numpy(
            (np.abs if positive else np.asarray)(rng.standard_normal(
                tuple(s.shape))).astype(np.float32)), shapes)
    params, grads = draw(), topt.tree_map(lambda g: g * scale, draw())
    state = {"m": draw(), "v": topt.tree_map(lambda v: v * 1e-3,
                                            draw(positive=True)),
             "step": torch.tensor(3, dtype=torch.int32)}
    ocfg = topt.AdamWConfig(warmup_steps=10, total_steps=100)
    want_p, want_s, want_info = topt.adamw_update(grads, state, params, ocfg)
    got_p, got_s = (topt.tree_map(torch.clone, params),
                    topt.tree_map(torch.clone, state))
    leaves = lambda: topt.tree_leaves(got_p) + topt.tree_leaves(got_s)
    ptrs = [t.data_ptr() for t in leaves()]
    info = topt.adamw_update_(topt.tree_map(torch.clone, grads), got_s,
                              got_p, ocfg)
    assert ptrs == [t.data_ptr() for t in leaves()]
    for got, want in zip(leaves(), topt.tree_leaves(want_p)
                         + topt.tree_leaves(want_s)):
        assert torch.equal(got, want)
    assert torch.equal(info["grad_norm"], want_info["grad_norm"])
    assert (want_info["grad_norm"] > ocfg.grad_clip) == (scale == 1.0)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_mace_checkpoints_cross_between_the_packages(tmp_path, writer):
    """A (params, AdamW state) tree with lists and int keys: the paths are
    the reference's (``layers_list/0/mix/2/a``), and either package
    restores the other's bit for bit."""
    jcfg, tcfg = _cfgs()
    jp = jm.init_mace(jax.random.PRNGKey(1), jcfg)
    ref = (jp, jopt.adamw_init(jp))
    port = (interop.model_params(jp), interop.adamw_state(
        jax.tree.map(np.asarray, ref[1])))
    if writer == "port":
        ck.save_checkpoint(str(tmp_path), 2, port)
        got, step = jck.restore_checkpoint(str(tmp_path), ref)
        leaves = [np.asarray(x) for x in jax.tree.leaves(got)]
    else:
        jck.save_checkpoint(str(tmp_path), 2, ref)
        got, step = ck.restore_checkpoint(str(tmp_path), port)
        leaves = [x.numpy() for _, x in ck._flatten(got)]
    assert step == 2
    for g, w in zip(leaves, jax.tree.leaves(ref)):
        assert g.dtype == np.asarray(w).dtype
        assert np.array_equal(g, np.asarray(w))
    with open(os.path.join(str(tmp_path), "step_0000000002",
                           "manifest.json")) as f:
        paths = json.load(f)["paths"]
    assert paths == [p for p, _ in ck._flatten(port)]
    assert "0/layers_list/0/mix/2/a" in paths


def test_cells_on_more_than_one_rank_raise_naming_15d():
    """A mesh of 256 ranks (its axis names and sizes): the GNN, recsys and
    LM builders all build. MACE's node and edge arguments lie over the
    grid (``Shard(0)`` on ``data`` and ``model``) and its parameters are
    replicated; a recsys table's rows lie over the grid; the steps across
    ranks are held to the reference in ``tests/test_torch_mace_ranks.py``
    and ``tests/test_torch_recsys_ranks.py``."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch.dryrun import PRODUCTION
    _, big = PRODUCTION["single"]
    grid = (Shard(0), Shard(0))
    mace = cells.build_cell("mace", "molecule", big)
    assert mace.kind == "train"
    for name in ("positions", "edge_src", "graph_ids", "force_target"):
        assert mace.args[2][name].placements == grid
    assert mace.args[2]["positions"].shape[0] % 256 == 0
    assert mace.args[2]["edge_src"].shape[0] % 256 == 0
    assert all(s.placements == (Replicate(), Replicate())
               for s in topt.tree_leaves(mace.args[0]))
    for arch, shape in (("dcn-v2", "train_batch"),
                        ("dlrm-mlperf", "retrieval_cand")):
        cell = cells.build_cell(arch, shape, big)
        assert cell.args[0]["tables"]["table_0"].placements == grid
    assert cells.build_cell("gemma-2b", "train_4k", big).kind == "train"
