"""The recsys cells across ranks on the CPU (``launch/cells.build_recsys_cell``
on a mesh of more than one rank: ``models/recsys.Ranks``), held to the
reference's functions called on one device and to its retrieval step on a
(data 2, model 2) mesh of host devices.

One child script runs as 4 gloo processes on a (data 2, model 2) mesh and
as 2 on a (pod 2, data 1, model 1) mesh, once each for the whole file, at
the reduced configs of the four archs (AutoInt, DCN-v2, DIEN, DLRM). The
inputs are numpy draws made here: the reference's initial parameters
(``init_recsys``, carried across by ``interop.model_params``) and batches
whose ids cover every table's padded rows, so every rank's chunk is read.
Each rank places them by the cell's specs (``sharding.place_tree``). Rank
0 writes what it gathered, each rank its own table gradients.
Tolerances, with their reasons:

* losses and gradients: rtol 1e-4, atol 1e-5 (``GRAD_TOL``, as
  ``tests/test_torch_lm_ranks.py``): each rank's loss is its share, and
  the shares, the gradients of the replicated layers and the lookups'
  partial sums are added over the ranks in another order than one device
  adds them;
* parameters and moments after 3 steps: atol 2 lr(step) summed over the
  steps (``adam_atol``: AdamW turns a small gradient error into a
  full-size update of either sign), rtol 0;
* each rank's table gradients: its rows of the one-device gradient (the
  rules' share: R / 4 rows on the 2 x 2 mesh) within ``GRAD_TOL``, and
  exactly zero on the rows no id reads;
* lookups with ids that wrap (-1, -R) or fall outside the table (NaN
  rows): the serve step's logits within ``TOL`` and NaN where the
  reference's are;
* retrieval (``sharded_topk`` ``False``, ``True`` and ``"local"``):
  scores within ``TOL`` (rtol 1e-5, atol 1e-6: the same f32 products in
  another order), ids equal at every position of the top 100 that no
  other candidate's distinct score lies within twice that of (at least
  80 positions: two scores closer than the tolerance may swap). The reference's step runs in
  a subprocess on four host devices whose mesh axes are ``Auto``: on jax
  0.9's default Explicit axes its ``jnp.take`` from the row-sharded table
  raises (ROADMAP.md, "Reference caveats"). Both meshes are also held to
  the step's statement written out in numpy;
* checkpoints across meshes: equal.
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
from repro.models import recsys as jrs
from repro.train import optimizer as jopt
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.launch import cells
from repro_torch.launch.dryrun import MeshShape
from repro_torch.models import recsys as trs
from repro_torch.train import checkpoint as ck
from repro_torch.train import optimizer as topt

GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
TOL = dict(rtol=1e-5, atol=1e-6)
RECSYS = ["autoint", "dcn-v2", "dien", "dlrm-mlperf"]
VARIANTS = {"false": False, "true": True, "local": "local"}
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "pod2": ((2, 1, 1), ("pod", "data", "model"))}
STEPS = 3
TIMEOUT = 240
ONE = MeshShape(("data", "model"), (1, 1))

jloss_grad = jax.jit(jax.value_and_grad(jrs.bce_loss), static_argnums=2)
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
archs, variants, steps = json.loads(sys.argv[7])
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
mesh = DeviceMesh("cpu", torch.arange(world).reshape(shape),
                  mesh_dim_names=tuple(names))
from repro_torch.distributed import sharding as sh
from repro_torch.launch import cells
from repro_torch.models import recsys as rs
from repro_torch.train import checkpoint as ck
from repro_torch.train import elastic
from repro_torch.train import optimizer as topt

data = np.load(inputs)
got, mine = {}, {}


def arrays(prefix):
    n = len([k for k in data.files if k.startswith(prefix + "/")])
    return [torch.from_numpy(data[f"{prefix}/{i}"]) for i in range(n)]


def tree(specs, prefix):
    return topt.tree_unflatten(specs, arrays(prefix))


def placed(specs, prefix):
    return sh.place_tree(tree(specs, prefix), mesh,
                         topt.tree_map(lambda s: s.placements, specs))


def keep(name, leaves):
    for i, x in enumerate(leaves):     # a copy: a replicated leaf's
        got[f"{name}/{i}"] = np.array(sh.full_tensor(x).numpy())


for arch in archs:
    cell = cells.build_cell(arch, "train_batch", mesh, reduced=True)
    params = placed(cell.args[0], f"{arch}/params")
    opt = topt.adamw_init(tree(cell.args[0], f"{arch}/params"))
    pl = topt.tree_map(lambda s: s.placements, cell.args[0])
    opt = {"m": sh.place_tree(opt["m"], mesh, pl),
           "v": sh.place_tree(opt["v"], mesh, pl),
           "step": sh.place(opt["step"], mesh,
                            cell.args[1]["step"].placements)}
    batch = placed(cell.args[2], f"{arch}/batch0")
    loss, grads = cells.grads_ranks(rs.bce_loss, params, batch, cell.cfg,
                                    cell.ranks())
    got[f"{arch}/loss0"] = np.float32(loss)
    keep(f"{arch}/grads", topt.tree_leaves(grads))
    leaves = topt.tree_leaves(grads)
    for i, (g, s) in enumerate(zip(leaves, topt.tree_leaves(cell.args[0]))):
        if any(p.is_shard() for p in s.placements):
            mine[f"{arch}/table{i}"] = g.to_local().numpy().copy()
    losses = []
    for step in range(steps):
        b = placed(cell.args[2], f"{arch}/batch{step}")
        params, opt, loss = cell.fn(params, opt, b)
        losses.append(float(loss))
    got[f"{arch}/losses"] = np.array(losses, np.float32)
    keep(f"{arch}/params", topt.tree_leaves(params))
    keep(f"{arch}/m", topt.tree_leaves(opt["m"]))
    if arch == "dcn-v2":
        keep("ckpt/v", topt.tree_leaves(opt["v"]))
        ck.save_checkpoint(os.path.join(out, "mesh_ckpt"), steps,
                           (params, opt))
        (p2, o2), step = elastic.resume_on_mesh(
            os.path.join(out, "..", "one_ckpt"), (params, opt), mesh,
            tuple(topt.tree_map(lambda x: x.placements, t)
                  for t in (params, opt)))
        got["restored_step"] = np.int32(step)
        keep("restored", topt.tree_leaves([p2, o2]))

    serve = cells.build_cell(arch, "serve_p99", mesh, reduced=True)
    logits = serve.fn(placed(serve.args[0], f"{arch}/params"),
                      placed(serve.args[1], f"{arch}/serve"))
    got[f"{arch}/serve"] = sh.full_tensor(logits).numpy().copy()

    for name, variant in variants.items():
        ret = cells.build_cell(arch, "retrieval_cand", mesh, reduced=True,
                               overrides={"sharded_topk": variant})
        cand = torch.from_numpy(data[f"{arch}/cand_{name}"])
        s, i = ret.fn(placed(ret.args[0], f"{arch}/params"),
                      placed(ret.args[1], f"{arch}/query"),
                      sh.place(cand, mesh, ret.args[2].placements))
        got[f"{arch}/{name}/scores"] = sh.full_tensor(s).numpy().copy()
        got[f"{arch}/{name}/ids"] = sh.full_tensor(i).numpy().copy()
if rank == 0:
    np.savez(os.path.join(out, "got.npz"), **got)
np.savez(os.path.join(out, f"rank{rank}.npz"), **mine)
dist.destroy_process_group()
print("RECSYS-RANKS-OK", rank, flush=True)
"""

# the reference's retrieval step on a (data 2, model 2) mesh of host
# devices with Auto axes; argv: inputs, output, archs, variants
_REFERENCE = r"""
import json, sys
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType
from repro.launch import cells as jcells
inputs, out = sys.argv[1], sys.argv[2]
archs, variants = json.loads(sys.argv[3])
data = np.load(inputs)
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
res = {}


def put(specs, prefix):
    leaves, treedef = jax.tree.flatten(specs)
    return treedef.unflatten([
        jax.device_put(jnp.asarray(data[f"{prefix}/{i}"]), s.sharding)
        for i, s in enumerate(leaves)])


for arch in archs:
    for name, variant in variants.items():
        cell = jcells.build_recsys_cell(
            arch, "retrieval_cand", mesh, reduced=True,
            overrides={"sharded_topk": variant})
        cand = jax.device_put(jnp.asarray(data[f"{arch}/cand_{name}"]),
                              cell.args[2].sharding)
        s, i = cell.fn(put(cell.args[0], f"{arch}/params"),
                       put(cell.args[1], f"{arch}/query"), cand)
        res[f"{arch}/{name}/scores"] = np.asarray(s)
        res[f"{arch}/{name}/ids"] = np.asarray(i)
np.savez(out, **res)
print("REFERENCE-OK", flush=True)
"""


def _adam_atol(steps: int) -> float:
    """2 lr(step) summed over steps 1..``steps``."""
    return sum(2 * topt._schedule(torch.tensor(s), topt.AdamWConfig()).item()
               for s in range(1, steps + 1))


def _cfgs(arch):
    return (jconfigs.get_arch(arch).make_reduced(),
            tconfigs.get_arch(arch).make_reduced())


def _one_cell(arch, shape, **overrides):
    return cells.build_cell(arch, shape, ONE, reduced=True,
                            overrides=overrides or None)


def _rows(tcfg, field: int) -> int:
    """The padded row count of a field's table (DIEN: 0 item, 1 cat)."""
    if tcfg.arch == "dien":
        return trs._pad_rows((tcfg.item_vocab, tcfg.cat_vocab)[field])
    cards = (trs._autoint_cards(tcfg) if tcfg.arch == "autoint"
             else tcfg.vocab_sizes)
    return trs._pad_rows(cards[field])


def _batch(tcfg, b, seed, *, label=True, odd=False):
    """A numpy batch of ``b`` rows whose ids cover each table's padded
    rows; ``odd``: row 0 of the first field reads id -1, row 1 id -R
    (both wrap), row 2 id R and row 3 id -R - 1 (NaN rows)."""
    rng = np.random.default_rng(seed)
    if tcfg.arch == "dien":
        t = tcfg.seq_len
        mask = (rng.random((b, t)) < 0.7).astype(np.float32)
        mask[:4] = 1.0
        out = {"target_item": rng.integers(0, _rows(tcfg, 0), b),
               "target_cat": rng.integers(0, _rows(tcfg, 1), b),
               "hist_items": rng.integers(0, _rows(tcfg, 0), (b, t)),
               "hist_cats": rng.integers(0, _rows(tcfg, 1), (b, t)),
               "hist_mask": mask}
        first, r0 = out["hist_items"][:, 0], _rows(tcfg, 0)
    else:
        out = {"sparse": np.stack([rng.integers(0, _rows(tcfg, f), b)
                                   for f in range(tcfg.n_sparse)], 1)}
        if tcfg.n_dense:
            out["dense"] = rng.standard_normal((b, tcfg.n_dense)).astype(
                np.float32)
        first, r0 = out["sparse"][:, 0], _rows(tcfg, 0)
    if odd:
        first[:4] = [-1, -r0, r0, -r0 - 1]
    if label:
        out["label"] = rng.integers(0, 2, b).astype(np.float32)
    return {k: v.astype(np.int32) if v.dtype.kind == "i" else v
            for k, v in out.items()}


def _leaves(batch, specs):
    """A batch dict's arrays in the specs' flatten order."""
    return topt.tree_leaves(topt.tree_map(lambda s, a: a, specs, batch))


def _inputs(path):
    """Every input the children and the reference read, by name; and the
    reference's parameters and batches."""
    flat, ref = {}, {}
    for n, arch in enumerate(RECSYS):
        jcfg, tcfg = _cfgs(arch)
        jp = jrs.init_recsys(jax.random.PRNGKey(20 + n), jcfg)
        for i, x in enumerate(topt.tree_leaves(interop.model_params(jp))):
            flat[f"{arch}/params/{i}"] = x.numpy()
        train = _one_cell(arch, "train_batch")
        b = train.args[2]["label"].shape[0]
        batches = [_batch(tcfg, b, 100 * n + s) for s in range(STEPS)]
        for s, batch in enumerate(batches):
            for i, x in enumerate(_leaves(batch, train.args[2])):
                flat[f"{arch}/batch{s}/{i}"] = x
        serve = _one_cell(arch, "serve_p99")
        sb = _batch(tcfg, serve.args[1]["label"].shape[0], 7, odd=True)
        for i, x in enumerate(_leaves(sb, serve.args[1])):
            flat[f"{arch}/serve/{i}"] = x
        query = _batch(tcfg, 1, 9, label=False)
        ret = _one_cell(arch, "retrieval_cand")
        for i, x in enumerate(_leaves(query, ret.args[1])):
            flat[f"{arch}/query/{i}"] = x
        rows = trs.item_matrix(interop.model_params(jp), tcfg).shape[0]
        for name, variant in VARIANTS.items():
            nc = cells.build_cell(arch, "retrieval_cand",
                                  MeshShape(*MESHES["2x2"][::-1]),
                                  reduced=True, overrides={
                                      "sharded_topk": variant}).args[2].shape[0]
            flat[f"{arch}/cand_{name}"] = np.random.default_rng(
                30 + n).permutation(np.arange(nc) % rows).astype(np.int32)
        ref[arch] = (jcfg, jp, batches, sb, query)
    np.savez(path, **flat)
    return flat, ref


def _one_rank_state():
    """DCN-v2's initial state after one one-rank step: what the one-rank
    checkpoint the 2 x 2 group restores holds."""
    cell = _one_cell("dcn-v2", "train_batch")
    from repro_torch.launch import train as ttrain
    params = ttrain.initial_params(cell, 0, "cpu")
    opt = topt.adamw_init(params)
    params, opt, _ = cell.fn(params, opt, ttrain.step_batch(cell, 0, "cpu"))
    return params, opt


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both child groups and the reference's retrieval steps, started
    together."""
    root = tmp_path_factory.mktemp("recsys_ranks")
    inputs = str(root / "inputs.npz")
    flat, ref = _inputs(inputs)
    ck.save_checkpoint(str(root / "one_ckpt"), 1, _one_rank_state())
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
                 json.dumps([RECSYS, VARIANTS, STEPS])],
                env=env, text=True, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT)))
    jenv = dict(env, JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=4")
    procs.append(("reference", subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, inputs, str(root / "ref.npz"),
         json.dumps([RECSYS, VARIANTS])], env=jenv, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    logs = {}
    try:
        for name, p in procs:
            logs[name] = p.communicate(timeout=TIMEOUT)[0]
    finally:
        for _, p in procs:
            p.kill()
    for name, p in procs:
        assert p.returncode == 0, (name, logs[name][-4000:])
    res = {"root": root, "flat": flat, "ref": ref,
           "reference": dict(np.load(root / "ref.npz"))}
    for key, d in out.items():
        world = int(np.prod(MESHES[key][0]))
        res[key] = {"dir": d, "got": dict(np.load(d / "got.npz")),
                    "ranks": [dict(np.load(d / f"rank{r}.npz"))
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
        np.testing.assert_allclose(g, np.asarray(w), **tol)


def _reference_train(runs, arch):
    """The reference's first loss and gradients, and its losses,
    parameters and moments over the steps (``bce_loss`` and
    ``adamw_update`` on one device), computed once a module."""
    cache = runs.setdefault("train_ref", {})
    if arch not in cache:
        cache[arch] = _reference_steps(*runs["ref"][arch][:3])
    return cache[arch]


def _reference_steps(jcfg, jp, batches):
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    loss0, grads0 = jloss_grad(jp, jb[0], jcfg)
    state, losses = jopt.adamw_init(jp), []
    for b in jb:
        loss, g = jloss_grad(jp, b, jcfg)
        jp, state, _ = jadamw(g, state, jp, jopt.AdamWConfig())
        losses.append(float(loss))
    return loss0, grads0, losses, jp, state


@pytest.mark.parametrize("arch", RECSYS)
@pytest.mark.parametrize("key", sorted(MESHES))
def test_train_step_matches_reference(runs, key, arch):
    """The first batch's loss and gradients (gathered whole) within
    GRAD_TOL; 3 steps of the cell: losses within GRAD_TOL, parameters and
    moments within 2 lr a step."""
    got = runs[key]["got"]
    loss0, grads0, losses, params, state = _reference_train(runs, arch)
    np.testing.assert_allclose(got[f"{arch}/loss0"], float(loss0),
                               **GRAD_TOL)
    _close(_arrays(got, f"{arch}/grads"), jax.tree.leaves(grads0),
           **GRAD_TOL)
    np.testing.assert_allclose(got[f"{arch}/losses"], losses, **GRAD_TOL)
    atol = _adam_atol(STEPS)
    _close(_arrays(got, f"{arch}/params"), jax.tree.leaves(params), rtol=0,
           atol=atol)
    _close(_arrays(got, f"{arch}/m"), jax.tree.leaves(state["m"]), rtol=0,
           atol=atol)


@pytest.mark.parametrize("arch", RECSYS)
@pytest.mark.parametrize("key", sorted(MESHES))
def test_table_gradients_are_each_ranks_share(runs, key, arch):
    """Each rank's gradient of each table is its chunk of the reference's
    one-device gradient (rows ``s R / G`` to ``(s + 1) R / G``, s the
    rank's grid chunk: its rank on these meshes), within GRAD_TOL, and
    zero on every row no id reads, in both."""
    _, grads0, _, _, _ = _reference_train(runs, arch)
    want = [np.asarray(g) for g in jax.tree.leaves(grads0)]
    shape, names = MESHES[key]
    sizes = dict(zip(names, shape))
    grid = sizes["data"] * sizes["model"]
    for r, rank in enumerate(runs[key]["ranks"]):
        tables = {int(k.split("table")[1]): v for k, v in rank.items()
                  if k.startswith(f"{arch}/")}
        assert len(tables) == (2 if arch == "dien" else
                               tconfigs.get_arch(arch).make_reduced()
                               .n_sparse)
        s = r % grid
        for i, g in tables.items():
            n = want[i].shape[0] // grid
            assert g.shape == (n,) + want[i].shape[1:]
            w = want[i][s * n:(s + 1) * n]
            np.testing.assert_allclose(g, w, **GRAD_TOL)
            assert np.array_equal(g == 0, w == 0)


@pytest.mark.parametrize("arch", RECSYS)
@pytest.mark.parametrize("key", sorted(MESHES))
def test_lookup_wrap_and_nan_fill_match_reference(runs, key, arch):
    """The serve step with ids -1 and -R (they wrap to rows R - 1 and 0)
    and R and -R - 1 (NaN rows): logits within TOL of the reference's
    ``recsys_forward`` and NaN where its are."""
    jcfg, jp, _, sb, _ = runs["ref"][arch]
    sb = dict(sb)
    sb.pop("label")
    want = np.asarray(jrs.recsys_forward(
        jp, {k: jnp.asarray(v) for k, v in sb.items()}, jcfg))
    got = runs[key]["got"][f"{arch}/serve"]
    assert np.isnan(want).any() and not np.isnan(want).all()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, equal_nan=True, **TOL)


def _statement(runs, arch, variant, grid):
    """The retrieval step as section 2 states it, in numpy: the user
    vector against the candidates' rows, a stable top k (ties to the
    lowest position); ``"local"``: chunk s of the candidates scores rows
    ``cand % rows_l`` of chunk s of the item matrix, its ids offset by s
    times the chunk's length, then a stable top k of the chunks' lists.
    Returns the top k's scores and ids, and which of its positions are
    clear of near-ties: no other distinct score of any candidate lies
    within twice ``TOL`` of the position's (a row read twice is an exact
    tie, which every path takes at the lower position)."""
    jcfg, jp, _, _, query = runs["ref"][arch]
    u = np.asarray(jrs.user_vector(
        jp, {k: jnp.asarray(v) for k, v in query.items()}, jcfg))
    items = np.asarray(jrs.item_matrix(jp, jcfg))
    cand = runs["flat"][f"{arch}/cand_{variant}"]
    k = min(100, cand.shape[0])

    def top(s, ids, kk):
        order = np.argsort(-s, axis=1, kind="stable")[:, :kk]
        return (np.take_along_axis(s, order, 1),
                np.take_along_axis(ids, order, 1))
    if variant != "local":
        every = u @ items[cand].T
        ws, wi = top(every, np.broadcast_to(np.arange(len(cand)),
                                            every.shape), k)
    else:
        n_l, rows_l = len(cand) // grid, items.shape[0] // grid
        ls, li, every = [], [], []
        for c in range(grid):
            chunk = cand[c * n_l:(c + 1) * n_l]
            s = u @ items[c * rows_l:(c + 1) * rows_l][chunk % rows_l].T
            a, b = top(s, np.broadcast_to(np.arange(n_l) + c * n_l,
                                          s.shape), min(k, n_l))
            ls.append(a)
            li.append(b)
            every.append(s)
        ws, wi = top(np.concatenate(ls, 1), np.concatenate(li, 1), k)
        every = np.concatenate(every, 1)
    err = 2 * (TOL["atol"] + TOL["rtol"] * np.abs(every).max())
    distinct = np.unique(every)
    near = np.abs(ws[0][:, None] - distinct[None, :]) <= err
    clear = near.sum(1) == 1          # the position's own value alone
    return ws, wi, clear


def _same_top(got_s, got_i, ws, wi, clear):
    """Scores within TOL at every position, ids equal at every position
    clear of near-ties, and at least 80 of the 100 positions clear."""
    np.testing.assert_allclose(got_s, ws, **TOL)
    assert clear.sum() >= 80, f"only {clear.sum()} positions clear"
    assert np.array_equal(got_i[0][clear], wi[0][clear])


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("arch", RECSYS)
def test_retrieval_matches_reference_on_the_2x2_mesh(runs, arch, variant):
    """Each ``sharded_topk`` variant on the 2 x 2 mesh against the
    reference's retrieval step on a (data 2, model 2) mesh of host
    devices: scores within TOL, ids equal away from near-ties. The
    reference's ``"local"`` numbers its chunks model-major and the port
    data-major; the merged result depends only on the chunks, so they
    agree."""
    _, _, clear = _statement(runs, arch, variant, 4)
    got, ref = runs["2x2"]["got"], runs["reference"]
    _same_top(got[f"{arch}/{variant}/scores"], got[f"{arch}/{variant}/ids"],
              ref[f"{arch}/{variant}/scores"], ref[f"{arch}/{variant}/ids"],
              clear)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("arch", RECSYS)
@pytest.mark.parametrize("key", sorted(MESHES))
def test_retrieval_matches_its_statement(runs, key, arch, variant):
    """Each variant on each mesh against section 2's statement in numpy
    with the mesh's grid size (4 chunks on 2 x 2, 1 on pod 2): scores
    within TOL, ids equal away from near-ties. ``False`` and ``True`` are
    the global top k."""
    shape, names = MESHES[key]
    sizes = dict(zip(names, shape))
    ws, wi, clear = _statement(runs, arch, variant,
                               sizes["data"] * sizes["model"])
    got = runs[key]["got"]
    _same_top(got[f"{arch}/{variant}/scores"], got[f"{arch}/{variant}/ids"],
              ws, wi, clear)


def test_checkpoint_from_the_mesh_restores_on_one_rank_bit_equal(runs):
    """DCN-v2's state after 3 steps on the 2 x 2 mesh, saved there (rank 0
    writing the gathered leaves), restores on one rank equal bit for bit
    to what the mesh gathered."""
    got = runs["2x2"]["got"]
    cell = _one_cell("dcn-v2", "train_batch")
    from repro_torch.launch import train as ttrain
    params = ttrain.initial_params(cell, 0, "cpu")
    (p, o), step = ck.restore_checkpoint(
        str(runs["2x2"]["dir"] / "mesh_ckpt"),
        (params, topt.adamw_init(params)))
    assert step == STEPS
    want = (_arrays(got, "dcn-v2/params") + _arrays(got, "dcn-v2/m")
            + _arrays(got, "ckpt/v"))
    have = (topt.tree_leaves(p) + topt.tree_leaves(o["m"])
            + topt.tree_leaves(o["v"]))
    assert len(have) == len(want)
    for g, w in zip(have, want):
        assert np.array_equal(g.numpy(), w)


def test_checkpoint_from_one_rank_restores_on_the_mesh_bit_equal(runs):
    """A one-rank DCN-v2 state restored onto the 2 x 2 mesh by
    ``resume_on_mesh`` (its tables' rows over the grid), gathered equal
    bit for bit to the one-rank state."""
    got = runs["2x2"]["got"]
    assert int(got["restored_step"]) == 1
    params, opt = _one_rank_state()
    have = _arrays(got, "restored")
    want = topt.tree_leaves([params, opt])
    assert len(have) == len(want)
    for g, w in zip(have, want):
        assert np.array_equal(g, w.numpy())
