"""MACE's cells across ranks on the CPU (``launch/cells.build_gnn_cell`` on a
mesh of more than one rank: nodes and edges over the grid,
``distributed/sharding.GridRanks``), held to the reference's
``mace_energy_forces``, ``mace_loss`` and ``mace_node_loss`` called
directly on one device with ``act_grid_axes=None`` (its own GNN cells fail
on every mesh: ROADMAP.md, "Reference caveats"), and the autograd
collectives' second-order gradients held to one process.

One child script runs as 4 gloo processes on a (data 2, model 2) mesh and
as 2 on a (pod 2, data 1, model 1) mesh, once each for the whole file, at
the reduced config's three cells: ``molecule`` (energy and force loss: a
second-order gradient), ``full_graph_sm`` and ``minibatch_lg`` (node
loss). The inputs are numpy draws made here (the reference's
``init_mace`` and ``random_graph_batch``, a tenth of the edges masked,
random targets); each rank places them by the cell's specs. Tolerances,
with their reasons:

* energies and forces: 1e-5 absolute (``EF_ATOL``, as
  ``tests/test_torch_mace.py``): the reference's own equivariance
  tolerance;
* losses and gradients: rtol 1e-4, atol 1e-5 (``GRAD_TOL``): the
  messages' sums, the energies and the losses' shares are added over the
  ranks in another order than one device adds them, and the second-order
  gradient runs through the checkpointed layers' recomputed collectives;
* parameters after 2 steps: atol 2 lr(step) summed over the steps
  (``adam_atol``: AdamW turns a small gradient error into a full-size
  update of either sign), rtol 0;
* each autograd collective's first- and second-order gradients on two
  ranks against the same function on one process, in f64: rtol 1e-12
  (sums of two terms in another order);
* checkpoints across meshes: equal.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import mace as jm
from repro.train import optimizer as jopt
from repro_torch import interop
from repro_torch.launch import cells
from repro_torch.launch.dryrun import MeshShape
from repro_torch.train import checkpoint as ck
from repro_torch.train import optimizer as topt

EF_ATOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
F64_TOL = dict(rtol=1e-12, atol=1e-12)
SHAPES = ["molecule", "full_graph_sm", "minibatch_lg"]
COLLECTIVES = ["all_gather", "reduce_scatter", "all_reduce", "all_to_all"]
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "pod2": ((2, 1, 1), ("pod", "data", "model"))}
STEPS = 2
ROWS, COLS = 4, 3                  # each rank's rows of the collective tests
TIMEOUT = 240
ONE = MeshShape(("data", "model"), (1, 1))

jadamw = jax.jit(jopt.adamw_update, static_argnums=3)

_CHILD = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

rank, world, store, out, inputs = (int(sys.argv[1]), int(sys.argv[2]),
                                   sys.argv[3], sys.argv[4], sys.argv[5])
shape, names = json.loads(sys.argv[6])
shapes, collectives, steps, rows, cols = json.loads(sys.argv[7])
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
mesh = DeviceMesh("cpu", torch.arange(world).reshape(shape),
                  mesh_dim_names=tuple(names))
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as sh
from repro_torch.launch import cells
from repro_torch.models import mace as mc
from repro_torch.train import checkpoint as ck
from repro_torch.train import optimizer as topt

data = np.load(inputs)
got = {}


def tree(specs, prefix):
    n = len([k for k in data.files if k.startswith(prefix + "/")])
    return topt.tree_unflatten(specs, [
        torch.from_numpy(data[f"{prefix}/{i}"]) for i in range(n)])


def placed(specs, prefix):
    return sh.place_tree(tree(specs, prefix), mesh,
                         topt.tree_map(lambda s: s.placements, specs))


def keep(name, leaves):
    for i, x in enumerate(leaves):     # a copy: a replicated leaf's
        got[f"{name}/{i}"] = np.array(sh.full_tensor(x).numpy())


for name in shapes:
    cell = cells.build_cell("mace", name, mesh, reduced=True)
    n_graphs = int(data[f"{name}/n_graphs"])
    params = placed(cell.args[0], f"{name}/params")
    pl = topt.tree_map(lambda s: s.placements, cell.args[0])
    opt = topt.adamw_init(tree(cell.args[0], f"{name}/params"))
    opt = {"m": sh.place_tree(opt["m"], mesh, pl),
           "v": sh.place_tree(opt["v"], mesh, pl),
           "step": sh.place(opt["step"], mesh,
                            cell.args[1]["step"].placements)}
    batch = dict(placed(cell.args[2], f"{name}/batch0"), n_graphs=n_graphs)
    ranks = cell.ranks()
    node_loss = "node_target" in cell.args[2]
    if not node_loss:
        with torch.no_grad():
            e, f = mc.mace_energy_forces(topt.tree_map(sh.to_local, params),
                                         topt.tree_map(sh.to_local, batch),
                                         cell.cfg, ranks)
        spec = cell.args[2]["force_target"]
        got[f"{name}/energies"] = e.numpy().copy()
        got[f"{name}/forces"] = sh.full_tensor(sh.as_placed(
            f, mesh, spec.placements, spec.shape)).numpy().copy()
    loss_fn = mc.mace_node_loss if node_loss else mc.mace_loss
    loss, grads = cells.grads_ranks(loss_fn, params, batch, cell.cfg, ranks)
    got[f"{name}/loss0"] = np.float32(loss)
    keep(f"{name}/grads", topt.tree_leaves(grads))
    losses = []
    for step in range(steps):
        b = placed(cell.args[2], f"{name}/batch{step}")
        params, opt, loss = cell.fn(params, opt, b)
        losses.append(float(loss))
    got[f"{name}/losses"] = np.array(losses, np.float32)
    keep(f"{name}/params", topt.tree_leaves(params))
    if name == "molecule":
        keep("ckpt/m", topt.tree_leaves(opt["m"]))
        keep("ckpt/v", topt.tree_leaves(opt["v"]))
        ck.save_checkpoint(os.path.join(out, "mesh_ckpt"), steps,
                           (params, opt))

# each autograd collective over 'pod': a rank's share of an f64 function,
# its gradient kept in the graph, then the gradient of a loss of that
# gradient; the function's inputs are the same on every rank
if "pod" in names:
    for kind in collectives:
        gen = torch.Generator().manual_seed(7)
        xs = torch.randn(world, rows, cols, generator=gen, dtype=torch.float64)
        w = torch.randn(world, 2 * rows if kind == "all_gather" else rows,
                        cols, generator=gen, dtype=torch.float64)
        v = torch.randn(world, rows, cols, generator=gen, dtype=torch.float64)
        x = xs[rank].clone().requires_grad_()
        if kind == "all_gather":
            z = coll.grad_all_gather(x, mesh, "pod")
        elif kind == "reduce_scatter":
            z = coll.grad_reduce_scatter(torch.cat([x, x * x]), mesh, "pod")
        elif kind == "all_reduce":
            z = coll.grad_all_reduce(x * x, mesh, "pod")
        else:
            z = coll.grad_all_to_all(x * x, mesh, "pod")
        share = (w[rank] * z ** 3).sum()
        (g,) = torch.autograd.grad(share, x, create_graph=True)
        (h,) = torch.autograd.grad((v[rank] * g * g).sum(), x)
        got[f"coll/{kind}/g"] = g.detach().numpy().copy()
        got[f"coll/{kind}/h"] = h.numpy().copy()
if rank == 0:
    np.savez(os.path.join(out, "got.npz"), **got)
else:
    np.savez(os.path.join(out, f"coll{rank}.npz"),
             **{k: v for k, v in got.items() if k.startswith("coll/")})
dist.destroy_process_group()
print("MACE-RANKS-OK", rank, flush=True)
"""


def _adam_atol(steps: int) -> float:
    """2 lr(step) summed over steps 1..``steps``."""
    return sum(2 * topt._schedule(torch.tensor(s), topt.AdamWConfig()).item()
               for s in range(1, steps + 1))


def _inputs(path):
    """The reference's parameters and batches of each cell, by name for
    the children, and as the reference takes them."""
    flat, ref = {}, {}
    for n, name in enumerate(SHAPES):
        cell = cells.build_cell("mace", name, ONE, reduced=True)
        specs = cell.args[2]
        jcfg = dataclasses.replace(jconfigs.get_arch("mace").make_reduced(),
                                   d_feat=cell.cfg.d_feat)
        jp = jm.init_mace(jax.random.PRNGKey(40 + n), jcfg)
        for i, x in enumerate(topt.tree_leaves(interop.model_params(jp))):
            flat[f"{name}/params/{i}"] = x.numpy()
        n_nodes, n_edges = specs["positions"].shape[0], \
            specs["edge_src"].shape[0]
        n_graphs = (specs["energy_target"].shape[0]
                    if "energy_target" in specs else 1)
        flat[f"{name}/n_graphs"] = np.int64(n_graphs)
        batches = []
        for step in range(STEPS):
            jb = jm.random_graph_batch(
                jax.random.PRNGKey(50 + 10 * n + step), n_nodes=n_nodes,
                n_edges=n_edges, d_feat=jcfg.d_feat, n_graphs=n_graphs)
            rng = np.random.default_rng(60 + 10 * n + step)
            b = {k: np.asarray(jb[k]) for k in specs if k in jb}
            b["edge_mask"] = rng.random(n_edges) > 0.1
            for k in ("energy_target", "force_target", "node_target"):
                if k in specs:
                    b[k] = rng.normal(size=specs[k].shape).astype(np.float32)
            if "node_mask" in specs:
                b["node_mask"] = (rng.random(n_nodes) > 0.5).astype(
                    np.float32)
            for i, x in enumerate(topt.tree_leaves(topt.tree_map(
                    lambda s, a: a, specs, b))):
                flat[f"{name}/batch{step}/{i}"] = x
            batches.append(b)
        ref[name] = (jcfg, jp, batches, n_graphs)
    np.savez(path, **flat)
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both child groups, started together."""
    root = tmp_path_factory.mktemp("mace_ranks")
    inputs = str(root / "inputs.npz")
    ref = _inputs(inputs)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs, out = [], {}
    for key, (shape, names) in MESHES.items():
        d = root / key
        d.mkdir()
        out[key] = d
        world = int(np.prod(shape))
        for r in range(world):
            procs.append((f"{key}/{r}", subprocess.Popen(
                [sys.executable, "-c", _CHILD, str(r), str(world),
                 str(d / "store"), str(d), inputs,
                 json.dumps([shape, names]),
                 json.dumps([SHAPES, COLLECTIVES, STEPS, ROWS, COLS])],
                env=env, text=True, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT)))
    logs = {}
    try:
        for name, p in procs:
            logs[name] = p.communicate(timeout=TIMEOUT)[0]
    finally:
        for _, p in procs:
            p.kill()
    for name, p in procs:
        assert p.returncode == 0, (name, logs[name][-4000:])
    res = {"ref": ref, "cache": {}}
    for key, d in out.items():
        res[key] = {"dir": d, "got": dict(np.load(d / "got.npz"))}
    res["pod2"]["coll1"] = dict(np.load(out["pod2"] / "coll1.npz"))
    return res


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _arrays(got, prefix):
    n = len([k for k in got if k.startswith(prefix + "/")])
    return [got[f"{prefix}/{i}"] for i in range(n)]


def _close(got, want, **tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **tol)


def _reference(runs, name):
    """The reference on one device: the first batch's energies and forces
    (energy cells), loss and gradients, then the losses and parameters of
    ``STEPS`` AdamW steps; computed once a module."""
    if name in runs["cache"]:
        return runs["cache"][name]
    jcfg, jp, batches, g = runs["ref"][name]
    loss_fn = jm.mace_node_loss if "node_target" in batches[0] \
        else jm.mace_loss
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    vg = jax.jit(lambda p, b: jax.value_and_grad(loss_fn)(
        p, dict(b, n_graphs=g), jcfg))
    ef = None
    if "force_target" in batches[0]:
        ef = tuple(np.asarray(x) for x in jax.jit(
            lambda p, b: jm.mace_energy_forces(p, dict(b, n_graphs=g),
                                               jcfg))(jp, jb[0]))
    loss0, grads0 = vg(jp, jb[0])
    state, losses = jopt.adamw_init(jp), []
    for b in jb:
        loss, grads = vg(jp, b)
        jp, state, _ = jadamw(grads, state, jp, jopt.AdamWConfig())
        losses.append(float(loss))
    runs["cache"][name] = (ef, float(loss0), grads0, losses, jp, state)
    return runs["cache"][name]


@pytest.mark.parametrize("key", sorted(MESHES))
def test_energies_and_forces_match_reference(runs, key):
    """``mace_energy_forces`` on the ranks' node and edge chunks: the
    energies (summed over the grid) and the forces (gathered) within
    EF_ATOL of the reference's."""
    (je, jf), *_ = _reference(runs, "molecule")
    got = runs[key]["got"]
    np.testing.assert_allclose(got["molecule/energies"], je, rtol=0,
                               atol=EF_ATOL)
    np.testing.assert_allclose(got["molecule/forces"], jf, rtol=0,
                               atol=EF_ATOL)


@pytest.mark.parametrize("name", SHAPES)
@pytest.mark.parametrize("key", sorted(MESHES))
def test_gradients_match_reference(runs, key, name):
    """The first batch's loss and parameter gradients, gathered: second
    order through the forces for ``molecule``, first order for the node
    loss; within GRAD_TOL."""
    _, loss0, grads0, *_ = _reference(runs, name)
    got = runs[key]["got"]
    np.testing.assert_allclose(got[f"{name}/loss0"], loss0, **GRAD_TOL)
    _close(_arrays(got, f"{name}/grads"), jax.tree.leaves(grads0),
           **GRAD_TOL)


@pytest.mark.parametrize("name", SHAPES)
@pytest.mark.parametrize("key", sorted(MESHES))
def test_steps_match_reference(runs, key, name):
    """2 steps of the cell: losses within GRAD_TOL, parameters within 2 lr
    a step of the reference's ``adamw_update`` composed directly."""
    *_, losses, params, _ = _reference(runs, name)
    got = runs[key]["got"]
    np.testing.assert_allclose(got[f"{name}/losses"], losses, **GRAD_TOL)
    _close(_arrays(got, f"{name}/params"), jax.tree.leaves(params), rtol=0,
           atol=_adam_atol(STEPS))


def _one_process(kind):
    """The collective test's function on one process: the sum of the
    ranks' shares over all their inputs, its gradient and the gradient of
    the loss of that gradient, each rank's rows."""
    world = MESHES["pod2"][0][0]
    gen = torch.Generator().manual_seed(7)
    xs = torch.randn(world, ROWS, COLS, generator=gen, dtype=torch.float64)
    w = torch.randn(world, 2 * ROWS if kind == "all_gather" else ROWS, COLS,
                    generator=gen, dtype=torch.float64)
    v = torch.randn(world, ROWS, COLS, generator=gen, dtype=torch.float64)
    x = xs.clone().requires_grad_()
    if kind == "all_gather":
        zs = [x.reshape(-1, COLS)] * world
    elif kind == "reduce_scatter":
        whole = torch.cat([x.sum(0), (x * x).sum(0)])
        zs = list(whole.split(ROWS))
    elif kind == "all_reduce":
        zs = [(x * x).sum(0)] * world
    else:
        half = ROWS // world
        zs = [torch.cat([(x[r] * x[r])[j * half:(j + 1) * half]
                         for r in range(world)]) for j in range(world)]
    total = sum((w[r] * zs[r] ** 3).sum() for r in range(world))
    (g,) = torch.autograd.grad(total, x, create_graph=True)
    (h,) = torch.autograd.grad((v * g * g).sum(), x)
    return g.detach().numpy(), h.numpy()


@pytest.mark.parametrize("kind", COLLECTIVES)
def test_second_order_gradient_through_each_collective(runs, kind):
    """Each autograd collective on two gloo ranks: the gradient of a
    rank's share (kept in the graph), then the gradient of a loss of it,
    equal to the function's on one process within 1e-12 (f64), on both
    ranks: a backward whose own backward is the adjoint collective."""
    g, h = _one_process(kind)
    for r, got in enumerate((runs["pod2"]["got"], runs["pod2"]["coll1"])):
        np.testing.assert_allclose(got[f"coll/{kind}/g"], g[r], **F64_TOL)
        np.testing.assert_allclose(got[f"coll/{kind}/h"], h[r], **F64_TOL)
        assert np.abs(h[r]).max() > 0


def test_checkpoint_from_the_mesh_restores_on_one_rank_bit_equal(runs):
    """The molecule cell's state after 2 steps on the 2 x 2 mesh, saved
    there (rank 0 writing the gathered leaves), restores on one rank equal
    bit for bit to what the mesh gathered."""
    got = runs["2x2"]["got"]
    cell = cells.build_cell("mace", "molecule", ONE, reduced=True)
    like = topt.tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype),
                         cell.args[0])
    (p, o), step = ck.restore_checkpoint(
        str(runs["2x2"]["dir"] / "mesh_ckpt"), (like, topt.adamw_init(like)))
    assert step == STEPS
    want = (_arrays(got, "molecule/params") + _arrays(got, "ckpt/m")
            + _arrays(got, "ckpt/v"))
    have = (topt.tree_leaves(p) + topt.tree_leaves(o["m"])
            + topt.tree_leaves(o["v"]))
    assert len(have) == len(want)
    for g, w in zip(have, want):
        assert np.array_equal(g.numpy(), w)
