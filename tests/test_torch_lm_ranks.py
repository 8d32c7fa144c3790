"""The LM cells across ranks on the CPU (``launch/cells.build_lm_cell`` on
a mesh of more than one rank: ``models/transformer.Ranks``), held to the
port's one-rank cell, which ``tests/test_torch_train.py`` and
``tests/test_torch_decoder.py`` hold to the reference, and the train step
also to the reference's ``lm_loss`` and ``adamw_update`` called directly
(its own LM cells fail on jax 0.9's Explicit mesh axes).

One child script runs as 4 gloo processes on a (data 2, model 2) mesh and
as 2 on a (pod 2, data 1, model 1) mesh, once each for the whole file:
the reduced gemma-2b (MQA, tied head), yi-9b, mixtral-8x22b (MoE) and
llama4-scout (its rules put the experts over ``data`` and leave
``embed`` whole). Rank 0 writes what it gathered; each rank writes its
shards' local shapes. The same numpy inputs go through the one-rank cell
here. Tolerances, with their reasons:

* losses and gradients, prefill and decode logits and caches: rtol 1e-4,
  atol 1e-5 (``GRAD_TOL``, as ``tests/test_torch_train.py``): the ranks
  sum a product's pieces, the vocab's logsumexp and the batch's mean in
  another order than one rank does;
* parameters and moments after 3 steps: atol 2 lr(step) summed over the
  steps (``tests/test_torch_train.py``'s reason: AdamW turns a small
  gradient error into a full-size update of either sign), rtol 0;
* greedy ids: equal wherever the top two logits of the one-rank run are
  more than ``NEAR_TIE`` apart;
* checkpoints across meshes, and each rank's local shapes: equal.
"""
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
from repro.distributed import sharding as jsh
from repro.models import transformer as jtf
from repro.train import optimizer as jopt
from repro_torch import interop
from repro_torch.launch import cells
from repro_torch.launch import train as ttrain
from repro_torch.launch.dryrun import MeshShape
from repro_torch.train import checkpoint as ck
from repro_torch.train import elastic
from repro_torch.train import optimizer as topt

GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
NEAR_TIE = 1e-4
ARCHS = ["gemma-2b", "yi-9b", "mixtral-8x22b", "llama4-scout-17b-a16e"]
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "pod2": ((2, 1, 1), ("pod", "data", "model"))}
SP_ARCHS = ["gemma-2b", "mixtral-8x22b"]   # seq_parallel on the 2 x 2 mesh
STEPS = 3
DECODE_STEPS = 4
TIMEOUT = 240
ONE = MeshShape(("data", "model"), (1, 1))

_CHILD = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

rank, world, store, key, out = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4], sys.argv[5])
shape, names = json.loads(sys.argv[6])
archs, sp_archs = json.loads(sys.argv[7])
steps, decode_steps = int(sys.argv[8]), int(sys.argv[9])
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
mesh = DeviceMesh("cpu", torch.arange(world).reshape(shape),
                  mesh_dim_names=tuple(names))
from repro_torch.distributed import sharding as sh
from repro_torch.launch import cells
from repro_torch.launch import train as ttrain
from repro_torch.train import checkpoint as ck
from repro_torch.train import elastic
from repro_torch.train import optimizer as topt

got, shapes, notes = {}, {}, {}


def full(tree):
    return [sh.full_tensor(x).numpy() for x in topt.tree_leaves(tree)]


def keep(name, arrays):
    for i, a in enumerate(arrays):     # a copy: a replicated leaf's
        got[f"{name}/{i}"] = np.array(a)   # gather is its own storage


def placed_state(cell, params):
    pl = topt.tree_map(lambda s: s.placements, cell.args[0])
    opt = topt.adamw_init(params)
    return (sh.place_tree(params, mesh, pl),
            {"m": sh.place_tree(opt["m"], mesh, pl),
             "v": sh.place_tree(opt["v"], mesh, pl),
             "step": sh.place(opt["step"], mesh,
                              cell.args[1]["step"].placements)})


def train(arch, mb, overrides=None, tag=None):
    cell = cells.build_lm_cell(arch, "train_4k", mesh, reduced=True,
                               overrides={"microbatches": mb,
                                          **(overrides or {})})
    tag = tag or f"{arch}/mb{mb}"
    params, opt = placed_state(cell, ttrain.initial_params(cell, 0, "cpu"))
    for leaf in topt.tree_leaves(params):
        shapes.setdefault(arch, []).append(list(leaf.to_local().shape))
    tokens = sh.place(ttrain.step_batch(cell, 0, "cpu"), mesh,
                      cell.args[2].placements)
    loss, grads = cells.lm_grads(params, tokens, cell.cfg, mb,
                                 cell.ranks())
    keep(f"{tag}/grads", full(grads))
    got[f"{tag}/loss0"] = np.float32(loss)
    got[f"{tag}/norm"] = np.float32(topt.global_norm(grads))
    losses = []
    for step in range(steps):
        tokens = sh.place(ttrain.step_batch(cell, step, "cpu"), mesh,
                          cell.args[2].placements)
        params, opt, loss = cell.fn(params, opt, tokens)
        losses.append(float(loss))
    got[f"{tag}/losses"] = np.array(losses, np.float32)
    keep(f"{tag}/params", full(params))
    keep(f"{tag}/m", full(opt["m"]))
    return cell, params, opt


def serve(arch):
    pre = cells.build_lm_cell(arch, "prefill_32k", mesh, reduced=True)
    dec = cells.build_lm_cell(arch, "decode_32k", mesh, reduced=True)
    pl = topt.tree_map(lambda s: s.placements, pre.args[0])
    params = sh.place_tree(ttrain.initial_params(pre, 0, "cpu"), mesh, pl)
    b, s = pre.args[1].shape
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, 512, (b, s)).astype(np.int32))
    logits, cache = pre.fn(params, sh.place(tokens, mesh,
                                            pre.args[1].placements))
    got[f"{arch}/prefill"] = sh.full_tensor(logits).numpy()
    for k in ("k", "v"):
        got[f"{arch}/prefill_{k}"] = sh.full_tensor(cache[k]).numpy()
    for i in range(decode_steps):
        tok = torch.from_numpy(np.random.default_rng(50 + i).integers(
            0, 512, (b, 1)).astype(np.int32))
        logits, cache = dec.fn(params, cache, sh.place(
            tok, mesh, dec.args[2].placements))
        got[f"{arch}/decode{i}"] = sh.full_tensor(logits).numpy()
    for k in ("k", "v", "pos"):
        got[f"{arch}/decode_{k}"] = sh.full_tensor(cache[k]).numpy()


for arch in archs:
    for mb in (1, 2):
        cell, params, opt = train(arch, mb)
    serve(arch)
if key == "2x2":
    for arch in sp_archs:
        train(arch, 1, {"seq_parallel": True}, tag=f"{arch}/sp")
    # checkpoints across meshes: this mesh's state after the steps, then
    # the next step's loss; a one-rank state written here before the run
    # restored onto the mesh; and a save to a directory of each rank's
    # own: only rank 0's is written
    cell, params, opt = train("gemma-2b", 1, tag="ckpt")
    ck.save_checkpoint(os.path.join(out, "mesh_ckpt"), steps,
                       (params, opt))
    tokens = sh.place(ttrain.step_batch(cell, steps, "cpu"), mesh,
                      cell.args[2].placements)
    got["ckpt/next_loss"] = np.float32(cell.fn(params, opt, tokens)[2])
    (p2, o2), step = elastic.resume_on_mesh(
        os.path.join(out, "one_ckpt"), (params, opt), mesh,
        tuple(topt.tree_map(lambda x: x.placements, t)
              for t in (params, opt)))
    notes["restored_step"] = step
    notes["restored_placed"] = all(
        x.placements == y.placements and tuple(x.to_local().shape) ==
        tuple(y.to_local().shape)
        for x, y in zip(topt.tree_leaves([p2, o2]),
                        topt.tree_leaves([params, opt])))
    keep("restored", full([p2, o2]))
    own = os.path.join(out, f"own_{rank}")
    ck.save_checkpoint(own, 1, params)
    notes["own_written"] = os.path.isdir(own)
    plan = elastic.plan_for_mesh(mesh, global_batch=4, base_data_parallel=2)
    notes["plan"] = [plan.accum_steps, plan.per_step_batch]
if rank == 0:
    np.savez(os.path.join(out, "got.npz"), **got)
with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
    json.dump({"shapes": shapes, "notes": notes}, f)
dist.destroy_process_group()
print("LM-RANKS-OK", rank, flush=True)
"""


def _adam_atol(steps: int) -> float:
    """2 lr(step) summed over steps 1..``steps``."""
    return sum(2 * topt._schedule(torch.tensor(s), topt.AdamWConfig()).item()
               for s in range(1, steps + 1))


def _one_rank_state():
    """The state the one-rank checkpoint holds: gemma-2b's initial
    parameters and AdamW state after one one-rank step."""
    cell = cells.build_lm_cell("gemma-2b", "train_4k", ONE, reduced=True)
    params = ttrain.initial_params(cell, 0, "cpu")
    opt = topt.adamw_init(params)
    params, opt, _ = cell.fn(params, opt, ttrain.step_batch(cell, 0, "cpu"))
    return params, opt


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both child groups, started together; the one-rank checkpoint the
    2 x 2 group restores is written first."""
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out, procs = {}, []
    for key, (shape, names) in MESHES.items():
        d = tmp_path_factory.mktemp(key)
        out[key] = d
        if key == "2x2":
            ck.save_checkpoint(str(d / "one_ckpt"), 1, _one_rank_state())
        world = int(np.prod(shape))
        for r in range(world):
            procs.append((key, r, subprocess.Popen(
                [sys.executable, "-c", _CHILD, str(r), str(world),
                 str(d / "store"), key, str(d),
                 json.dumps([shape, names]), json.dumps([ARCHS, SP_ARCHS]),
                 str(STEPS), str(DECODE_STEPS)],
                env=env, text=True, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT)))
    logs = {}
    try:
        for key, r, p in procs:
            logs[(key, r)] = p.communicate(timeout=TIMEOUT)[0]
    finally:
        for _, _, p in procs:
            p.kill()
    for (key, r, p) in procs:
        assert p.returncode == 0, logs[(key, r)][-4000:]
        assert f"LM-RANKS-OK {r}" in logs[(key, r)]
    res = {}
    for key, d in out.items():
        world = int(np.prod(MESHES[key][0]))
        res[key] = {"dir": d,
                    "got": dict(np.load(d / "got.npz")),
                    "ranks": [json.loads((d / f"rank{r}.json").read_text())
                              for r in range(world)]}
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
        np.testing.assert_allclose(g, interop.to_numpy(w), **tol)


def _one_rank_train(arch, mb, overrides=None):
    cell = cells.build_lm_cell(arch, "train_4k", ONE, reduced=True,
                               overrides={"microbatches": mb,
                                          **(overrides or {})})
    params = ttrain.initial_params(cell, 0, "cpu")
    loss0, grads = cells.lm_grads(params, ttrain.step_batch(cell, 0, "cpu"),
                                  cell.cfg, mb)
    opt, losses = topt.adamw_init(params), []
    for step in range(STEPS):
        params, opt, loss = cell.fn(params, opt,
                                    ttrain.step_batch(cell, step, "cpu"))
        losses.append(float(loss))
    return loss0, grads, losses, params, opt


@pytest.mark.parametrize("mb", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("key", sorted(MESHES))
def test_train_step_matches_one_rank(runs, key, arch, mb):
    """The first batch's loss and gradients (gathered whole), then 3
    steps: losses within GRAD_TOL, parameters and moments within 2 lr a
    step."""
    got = runs[key]["got"]
    loss0, grads, losses, params, opt = _one_rank_train(arch, mb)
    tag = f"{arch}/mb{mb}"
    np.testing.assert_allclose(got[f"{tag}/loss0"], loss0.item(), **GRAD_TOL)
    _close(_arrays(got, f"{tag}/grads"), topt.tree_leaves(grads), **GRAD_TOL)
    np.testing.assert_allclose(got[f"{tag}/losses"], losses, **GRAD_TOL)
    atol = _adam_atol(STEPS)
    _close(_arrays(got, f"{tag}/params"), topt.tree_leaves(params), rtol=0,
           atol=atol)
    _close(_arrays(got, f"{tag}/m"), topt.tree_leaves(opt["m"]), rtol=0,
           atol=atol)


@pytest.mark.parametrize("arch", SP_ARCHS)
def test_sequence_parallel_train_matches_one_rank(runs, arch):
    """``seq_parallel`` on the 2 x 2 mesh (the residual stream split on
    the sequence over ``model``): the same values as one rank."""
    got = runs["2x2"]["got"]
    loss0, grads, losses, params, _ = _one_rank_train(arch, 1)
    np.testing.assert_allclose(got[f"{arch}/sp/loss0"], loss0.item(),
                               **GRAD_TOL)
    _close(_arrays(got, f"{arch}/sp/grads"), topt.tree_leaves(grads),
           **GRAD_TOL)
    np.testing.assert_allclose(got[f"{arch}/sp/losses"], losses, **GRAD_TOL)
    _close(_arrays(got, f"{arch}/sp/params"), topt.tree_leaves(params),
           rtol=0, atol=_adam_atol(STEPS))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(runs, arch):
    """The 2 x 2 mesh's first gradients against the reference's
    ``value_and_grad(lm_loss)``, and the global norm it clips by against
    the reference's ``global_norm``, both within GRAD_TOL."""
    got = runs["2x2"]["got"]
    jcfg = jconfigs.get_arch(arch).make_reduced()
    cell = cells.build_lm_cell(arch, "train_4k", ONE, reduced=True)
    params = ttrain.initial_params(cell, 0, "cpu")
    jparams = jax.tree.map(jnp.asarray, topt.tree_map(interop.to_numpy,
                                                      params))
    tokens = jnp.asarray(ttrain.step_batch(cell, 0, "cpu").numpy())
    jl, jg = jax.jit(jax.value_and_grad(jtf.lm_loss), static_argnums=2)(
        jparams, tokens, jcfg)
    np.testing.assert_allclose(got[f"{arch}/mb1/loss0"], float(jl),
                               **GRAD_TOL)
    _close(_arrays(got, f"{arch}/mb1/grads"), jax.tree.leaves(jg),
           **GRAD_TOL)
    np.testing.assert_allclose(got[f"{arch}/mb1/norm"],
                               float(jopt.global_norm(jg)), **GRAD_TOL)


def _greedy_equal_away_from_ties(got, want):
    top2 = np.sort(want, -1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > NEAR_TIE
    assert np.array_equal(np.argmax(got, -1)[clear],
                          np.argmax(want, -1)[clear])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("key", sorted(MESHES))
def test_prefill_and_decode_match_one_rank(runs, key, arch):
    """Prefill's last-token logits and cache, then 4 decode steps'
    logits and the final cache, gathered whole: within GRAD_TOL; greedy
    ids equal away from near-ties."""
    got = runs[key]["got"]
    pre = cells.build_lm_cell(arch, "prefill_32k", ONE, reduced=True)
    dec = cells.build_lm_cell(arch, "decode_32k", ONE, reduced=True)
    params = ttrain.initial_params(pre, 0, "cpu")
    b, s = pre.args[1].shape
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, 512, (b, s)).astype(np.int32))
    logits, cache = pre.fn(params, tokens)
    np.testing.assert_allclose(got[f"{arch}/prefill"], logits.numpy(),
                               **GRAD_TOL)
    _greedy_equal_away_from_ties(got[f"{arch}/prefill"], logits.numpy())
    for k in ("k", "v"):
        np.testing.assert_allclose(got[f"{arch}/prefill_{k}"],
                                   cache[k].numpy(), **GRAD_TOL)
    for i in range(DECODE_STEPS):
        tok = torch.from_numpy(np.random.default_rng(50 + i).integers(
            0, 512, (b, 1)).astype(np.int32))
        logits, cache = dec.fn(params, cache, tok)
        np.testing.assert_allclose(got[f"{arch}/decode{i}"], logits.numpy(),
                                   **GRAD_TOL)
        _greedy_equal_away_from_ties(got[f"{arch}/decode{i}"],
                                     logits.numpy())
    for k in ("k", "v"):
        np.testing.assert_allclose(got[f"{arch}/decode_{k}"],
                                   cache[k].numpy(), **GRAD_TOL)
    assert np.array_equal(got[f"{arch}/decode_pos"], cache["pos"].numpy())


def _rules_shards(arch, mesh_sizes):
    """Each parameter's local shape by the REFERENCE's rules table (its
    ``LM_RULES`` with the arch's ``rules_override``): every dim over the
    product of the sizes of the mesh axes its logical name maps to."""
    spec = jconfigs.get_arch(arch)
    rules = {**jsh.LM_RULES, **(spec.rules_override or {})}
    cfg = spec.make_reduced()
    axes = jtf.param_logical_axes(cfg)
    shapes = jax.eval_shape(lambda: jtf.init_transformer(
        jax.random.PRNGKey(0), cfg))
    out = []
    for logical, leaf in zip(jax.tree.leaves(
            axes, is_leaf=lambda x: isinstance(x, tuple)),
            jax.tree.leaves(shapes)):
        dims = []
        for n, name in zip(leaf.shape, logical):
            target = rules.get(name)
            target = (target,) if isinstance(target, str) else (target or ())
            dims.append(n // int(np.prod([mesh_sizes.get(a, 1)
                                          for a in target])))
        out.append(dims)
    return out


@pytest.mark.parametrize("key", sorted(MESHES))
def test_each_rank_holds_only_its_shards(runs, key):
    """Every rank's parameter leaves have the whole shape divided as the
    reference's rules place them (ZeRO ``embed`` over ``data``, TP over
    ``model``, llama4's experts over ``data``), on both meshes."""
    shape, names = MESHES[key]
    sizes = dict(zip(names, shape))
    for rank in runs[key]["ranks"]:
        for arch in ARCHS:
            assert rank["shapes"][arch][:len(_rules_shards(arch, sizes))] \
                == _rules_shards(arch, sizes), arch


def test_checkpoint_from_the_mesh_restores_on_one_rank_bit_equal(runs):
    """The 2 x 2 mesh's state after 3 steps, saved there (rank 0 writing
    the gathered leaves), restores on one rank equal bit for bit to what
    the mesh gathered; the restored state's next step gives the mesh's
    next loss within GRAD_TOL."""
    got = runs["2x2"]["got"]
    cell = cells.build_lm_cell("gemma-2b", "train_4k", ONE, reduced=True)
    params = ttrain.initial_params(cell, 0, "cpu")
    like = (params, topt.adamw_init(params))
    (p, o), step = ck.restore_checkpoint(
        str(runs["2x2"]["dir"] / "mesh_ckpt"), like)
    assert step == STEPS
    want = _arrays(got, "ckpt/params") + _arrays(got, "ckpt/m")
    have = topt.tree_leaves(p) + topt.tree_leaves(o["m"])
    for g, w in zip(have, want):
        assert np.array_equal(g.numpy(), w)
    _, _, loss = cell.fn(p, o, ttrain.step_batch(cell, STEPS, "cpu"))
    np.testing.assert_allclose(loss.item(), got["ckpt/next_loss"],
                               **GRAD_TOL)


def test_checkpoint_from_one_rank_restores_on_the_mesh_bit_equal(runs):
    """A one-rank checkpoint restored onto the 2 x 2 mesh by
    ``resume_on_mesh``: placed as the cell's specs, gathered equal bit for
    bit to the one-rank state."""
    ranks = runs["2x2"]["ranks"]
    assert all(r["notes"]["restored_step"] == 1 for r in ranks)
    assert all(r["notes"]["restored_placed"] for r in ranks)
    params, opt = _one_rank_state()
    for g, w in zip(_arrays(runs["2x2"]["got"], "restored"),
                    topt.tree_leaves([params, opt])):
        assert np.array_equal(g, w.numpy())


def test_only_rank_zero_writes_a_checkpoint(runs):
    """Each rank saved to a directory of its own: only rank 0's exists
    (every rank joins the gather, one writes)."""
    for r, rank in enumerate(runs["2x2"]["ranks"]):
        assert rank["notes"]["own_written"] == (r == 0)
        assert os.path.isdir(runs["2x2"]["dir"] / f"own_{r}") == (r == 0)


def test_plan_for_mesh_keeps_the_global_batch(runs):
    """A global batch of 4 planned for 2 data-parallel ranks: the 2 x 2
    mesh takes it in one step of 4, one rank in 2 microbatches of 2."""
    for rank in runs["2x2"]["ranks"]:
        assert rank["notes"]["plan"] == [1, 4]
    plan = elastic.plan_for_mesh(ONE, global_batch=4, base_data_parallel=2)
    assert (plan.accum_steps, plan.per_step_batch) == (2, 2)
