"""The port's LM training against the JAX package on the CPU: the train
cell (``launch/cells.build_lm_cell``), the donated AdamW update,
``train_loop`` with checkpoints and resume, the checkpoint format (across
the packages), the elastic policies, ``launch/train.py`` and the cells'
specs, at the reduced configs of the five LM architectures (f32).

The same numpy inputs go through both packages. The reference's step is
composed directly: ``jax.value_and_grad(lm_loss)`` (per microbatch, the
gradients summed as its scan does) plus ``adamw_update``, with the
activation-sharding options left ``None`` (its ``build_cell`` fails on
``with_sharding_constraint`` in some JAX 0.9 setups). Tolerances, with
their reasons:

* losses and gradients: rtol 1e-4, atol 1e-5 (backward passes sum in
  other orders; as ``tests/test_torch_decoder.py``);
* parameters after n steps: atol 2 lr(step) summed over the n steps, rtol
  0. AdamW turns a small gradient error into a full-size update: where |g|
  is near its own error, m / sqrt(v) may take either sign, and at these
  steps |m / sqrt(v)| <= 1, so one element may move by up to 2 lr a step
  apart in the two packages however close the gradients are;
* the donated update against the functional one, initial parameters,
  checkpoints across the packages, resumed losses and specs: equal.
"""
import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import cells as jcells
from repro.launch import mesh as jmesh
from repro.launch import train as jtrain
from repro.models import transformer as jtf
from repro.train import checkpoint as jck
from repro.train import optimizer as jopt
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.distributed.sharding import placements
from repro_torch.launch import cells
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as ttf
from repro_torch.train import checkpoint as ck
from repro_torch.train import elastic
from repro_torch.train import loop as tloop
from repro_torch.train import optimizer as topt

GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
LM_ARCHS = [a for a in jconfigs.ARCH_IDS
            if jconfigs.get_arch(a).family == "lm"]
SHAPES = {"train": "train_4k", "prefill": "prefill_32k",
          "decode": "decode_32k"}
_DTYPES = {jnp.dtype(jnp.float32): torch.float32,
           jnp.dtype(jnp.bfloat16): torch.bfloat16,
           jnp.dtype(jnp.int32): torch.int32}

jloss_grad = jax.jit(jax.value_and_grad(jtf.lm_loss), static_argnums=2)
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


def _adam_atol(steps: int) -> float:
    """2 lr(step) summed over steps 1..``steps``."""
    return sum(2 * topt._schedule(torch.tensor(s), topt.AdamWConfig()).item()
               for s in range(1, steps + 1))


def _ref_step_grads(params, tokens, jcfg, mb):
    """The reference's loss and gradients, its microbatched scan composed
    eagerly from the jitted ``value_and_grad``. A microbatch's loss and
    gradient are taken on its rows repeated ``mb`` times: the same mean
    (and the same MoE routing: a row is its own routing group), at the
    whole batch's shape, so one compiled function serves every ``mb``."""
    if mb == 1:
        return jloss_grad(params, tokens, jcfg)
    b, s1 = tokens.shape
    acc = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
    losses = []
    for t in tokens.reshape(mb, b // mb, s1):
        loss, g = jloss_grad(params, jnp.tile(t, (mb, 1)), jcfg)
        acc = jax.tree.map(lambda a, g_: a + g_.astype(jnp.float32) / mb,
                           acc, g)
        losses.append(loss)
    return jnp.stack(losses).mean(), acc


def _close_trees(got, want, **tol):
    for g, w in zip(topt.tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(interop.to_numpy(g), np.asarray(w), **tol)


@pytest.mark.parametrize("mb", [1, 2])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_train_step_matches_reference(mesh, arch, mb):
    """Loss and gradients of the first batch, then 3 steps of the cell:
    losses within GRAD_TOL, parameters and moments within 2 lr(step) a
    step."""
    jcfg = jconfigs.get_arch(arch).make_reduced()
    tcfg = tconfigs.get_arch(arch).make_reduced()
    cell = cells.build_lm_cell(arch, "train_4k", mesh, reduced=True,
                               overrides={"microbatches": mb})
    params = ttrain.initial_params(cell, 0, "cpu")
    jparams = jax.tree.map(jnp.asarray, _np(params))
    tokens = ttrain.step_batch(cell, 0, "cpu")
    loss, grads = cells.lm_grads(params, tokens, tcfg, mb)
    jl, jg = _ref_step_grads(jparams, jnp.asarray(tokens.numpy()), jcfg, mb)
    np.testing.assert_allclose(loss.item(), float(jl), **GRAD_TOL)
    _close_trees(grads, jg, **GRAD_TOL)

    opt, jstate = topt.adamw_init(params), jopt.adamw_init(jparams)
    for step in range(3):
        tokens = ttrain.step_batch(cell, step, "cpu")
        params, opt, loss = cell.fn(params, opt, tokens)
        jl, jg = _ref_step_grads(jparams, jnp.asarray(tokens.numpy()),
                                 jcfg, mb)
        jparams, jstate, _ = jadamw(jg, jstate, jparams, jopt.AdamWConfig())
        np.testing.assert_allclose(loss.item(), float(jl), **GRAD_TOL)
    atol = _adam_atol(3)
    _close_trees(params, jparams, rtol=0, atol=atol)
    _close_trees(opt["m"], jstate["m"], rtol=0, atol=atol)
    assert int(opt["step"]) == int(jstate["step"]) == 3


def _np(tree):
    return topt.tree_map(interop.to_numpy, tree)


@pytest.mark.parametrize("scale", [1.0, 1e-3], ids=["clipped", "unclipped"])
def test_donated_update_is_the_functional_one_bit_for_bit(scale):
    """``adamw_update_`` writes ``adamw_update``'s values into the given
    leaves (their pointers unchanged), with and without clipping."""
    cfg = tconfigs.get_arch("mixtral-8x22b").make_reduced()
    rng = np.random.default_rng(5)

    def draw(positive=False):
        return topt.tree_map(lambda s: torch.from_numpy(
            (np.abs if positive else np.asarray)(
                rng.standard_normal(s)).astype(np.float32)),
            _shapes(cfg))
    params, grads = draw(), topt.tree_map(lambda g: g * scale, draw())
    state = {"m": draw(), "v": topt.tree_map(lambda v: v * 1e-3,
                                            draw(positive=True)),
             "step": torch.tensor(41, dtype=torch.int32)}
    ocfg = topt.AdamWConfig(warmup_steps=10, total_steps=100)
    want_p, want_s, want_info = topt.adamw_update(grads, state, params, ocfg)
    got_p, got_s = (topt.tree_map(torch.clone, params),
                    topt.tree_map(torch.clone, state))
    ptrs = [t.data_ptr() for t in topt.tree_leaves(got_p)
            + topt.tree_leaves(got_s)]
    info = topt.adamw_update_(topt.tree_map(torch.clone, grads), got_s,
                              got_p, ocfg)
    assert ptrs == [t.data_ptr() for t in topt.tree_leaves(got_p)
                    + topt.tree_leaves(got_s)]
    for got, want in zip(topt.tree_leaves(got_p) + topt.tree_leaves(got_s),
                         topt.tree_leaves(want_p) + topt.tree_leaves(want_s)):
        assert torch.equal(got, want)
    assert torch.equal(info["lr"], want_info["lr"])
    assert torch.equal(info["grad_norm"], want_info["grad_norm"])
    assert (want_info["grad_norm"] > ocfg.grad_clip) == (scale == 1.0)


def _shapes(cfg):
    return ttf.param_shapes(cfg)


# --------------------------------------------------------------------------
# train_loop and launch/train
# --------------------------------------------------------------------------

def _train(argv):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        losses = ttrain.main(argv + ["--device", "cpu"])
    return losses, out.getvalue()


@pytest.mark.parametrize("arch", ["gemma-2b", "mixtral-8x22b"])
def test_resumed_loop_is_bit_equal_to_an_uninterrupted_one(tmp_path, arch):
    """12 steps, then the same call to 20 resumes at 12 (``latest_step``)
    and gives the uninterrupted run's losses and final checkpoint."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    first, _ = _train(["--arch", arch, "--steps", "12",
                       "--checkpoint-dir", a])
    assert ck.latest_step(a) == 12
    second, out = _train(["--arch", arch, "--steps", "20",
                          "--checkpoint-dir", a])
    assert "resumed from step 12" in out and len(second) == 8
    whole, _ = _train(["--arch", arch, "--steps", "20",
                       "--checkpoint-dir", b])
    assert first + second == whole
    like = _like(arch)
    got, step = ck.restore_checkpoint(a, like)
    want, _ = ck.restore_checkpoint(b, like)
    assert step == 20
    for g, w in zip(ck._flatten(got), ck._flatten(want)):
        assert g[0] == w[0] and torch.equal(g[1], w[1])


def _like(arch):
    """A (params, AdamW state) tree of the reduced arch on the CPU."""
    params = topt.tree_map(torch.zeros, _shapes(
        tconfigs.get_arch(arch).make_reduced()))
    return params, topt.adamw_init(params)


def test_remesh_verdict_saves_a_checkpoint(tmp_path, monkeypatch):
    """A straggler verdict of "remesh" after step 4 saves step 5 at once
    (checkpoint_every is far off), then the loop goes on to its end and
    saves step 8. (The worker may skip step 5's write if step 8's save
    supersedes it in the queue: the save calls and their host copies are
    what is checked.)"""
    class Verdicts:
        def __init__(self):
            self.n = 0

        def observe(self, seconds):
            self.n += 1
            return "remesh" if self.n == 5 else "ok"

    monkeypatch.setattr(tloop, "StragglerPolicy", Verdicts)
    saved = []
    orig = ck._host_copy
    monkeypatch.setattr(ck, "_host_copy", lambda tree: (
        saved.append(orig(tree)), saved[-1])[1])
    params = {"w": torch.zeros(3)}

    def step_fn(p, o, batch):
        p["w"].add_(batch)
        return p, o, p["w"].sum()

    with contextlib.redirect_stdout(io.StringIO()) as out:
        _, _, losses = tloop.train_loop(
            step_fn, params, {"n": torch.zeros(())}, lambda s: float(s),
            tloop.LoopConfig(total_steps=8, log_every=0,
                             checkpoint_every=100,
                             checkpoint_dir=str(tmp_path)))
    assert "remesh" in out.getvalue() and len(saved) == 2
    assert np.array_equal(saved[0][0]["w"], np.full(3, 10.0))  # 0 + .. + 4
    assert ck.latest_step(str(tmp_path)) == 8
    got, _ = ck.restore_checkpoint(str(tmp_path), (params, {"n": 0}))
    assert torch.equal(got[0]["w"], torch.full((3,), 28.0))   # 0 + .. + 7
    assert losses == [3.0 * sum(range(i + 1)) for i in range(8)]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_launcher_matches_reference_draw_and_steps(mesh, arch):
    """``launch/train``'s initial parameters are the reference launcher's
    ``_batch_like`` draw bit for bit; 6 steps' losses match the
    reference's step composed directly on the same parameters and
    batches."""
    cell = cells.build_lm_cell(arch, "train_4k", mesh, reduced=True)
    jcell = jcells.build_cell(arch, "train_4k", jmesh.make_host_mesh(),
                              reduced=True)
    want = jax.tree.map(lambda x: x * 0.02, jtrain._batch_like(
        jcell.args[0], 0, np.random.default_rng(0)))
    got = ttrain.initial_params(cell, 0, "cpu")
    for g, w in zip(topt.tree_leaves(got), jax.tree.leaves(want)):
        assert g.dtype == torch.float32
        assert np.array_equal(g.numpy(), np.asarray(w))
    jcfg = jconfigs.get_arch(arch).make_reduced()
    jparams, jstate = want, jopt.adamw_init(want)
    wlosses = []
    for step in range(6):
        toks = jtrain._batch_like(jcell.args[2], step,
                                  np.random.default_rng(step))
        assert np.array_equal(np.asarray(toks),
                              ttrain.step_batch(cell, step, "cpu").numpy())
        loss, g = jloss_grad(jparams, toks, jcfg)
        jparams, jstate, _ = jadamw(g, jstate, jparams, jopt.AdamWConfig())
        wlosses.append(float(loss))
    losses, _ = _train(["--arch", arch, "--steps", "6"])
    np.testing.assert_allclose(losses, wlosses, **GRAD_TOL)


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nested": {"b": torch.ones((4,), dtype=torch.int32)}}
    ck.save_checkpoint(str(tmp_path), 7, tree)
    assert ck.latest_step(str(tmp_path)) == 7
    restored, step = ck.restore_checkpoint(str(tmp_path), tree)
    assert step == 7
    assert torch.equal(restored["a"], tree["a"])
    assert torch.equal(restored["nested"]["b"], tree["nested"]["b"])
    assert restored["nested"]["b"].dtype == torch.int32


def test_checkpoint_atomicity(tmp_path):
    """A crashed writer must never corrupt the published checkpoint."""
    tree = {"a": torch.ones((3,))}
    ck.save_checkpoint(str(tmp_path), 1, tree)
    # a stale tmp dir from a crashed writer
    os.makedirs(os.path.join(str(tmp_path), "step_0000000002.tmp"))
    assert ck.latest_step(str(tmp_path)) == 1
    restored, _ = ck.restore_checkpoint(str(tmp_path), tree)
    assert float(restored["a"].sum()) == 3.0


def test_async_checkpointer(tmp_path):
    """keep=2 leaves the two newest; each save is the host copy made when
    it was called, though the caller changes its tensor in place after."""
    c = ck.AsyncCheckpointer(str(tmp_path), keep=2)
    tree = {"a": torch.ones((3,))}
    for step in (1, 2, 3):
        tree["a"].fill_(float(step))
        c.save(step, tree)
    tree["a"].fill_(-1.0)
    c.close()
    assert ck.latest_step(str(tmp_path)) == 3
    restored, _ = ck.restore_checkpoint(str(tmp_path), tree, step=3)
    assert float(restored["a"][0]) == 3.0
    # a newer pending save supersedes an older one not yet taken by the
    # worker; of those written, the two newest are kept
    kept = sorted(os.listdir(str(tmp_path)))
    assert 1 <= len(kept) <= 2 and kept[-1] == "step_0000000003", kept


def test_async_checkpointer_surfaces_a_failed_write(tmp_path):
    """A write that fails on the worker is raised by close()."""
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("")
    c = ck.AsyncCheckpointer(str(blocker), keep=2)
    c.save(1, {"a": torch.zeros(2)})
    with pytest.raises(FileExistsError):
        c.close()


def test_elastic_reshard_roundtrip(tmp_path, mesh):
    """Written from a tensor placed on one layout, restored onto another
    (elastic re-mesh resume on a 1-rank gloo mesh): values identical,
    placements re-applied."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    w = torch.arange(8.0).reshape(4, 2)
    ck.save_checkpoint(str(tmp_path), 5, {"w": distribute_tensor(
        w, mesh, placements(mesh, ("data", None)))})
    shardings = {"w": placements(mesh, ("model", None))}
    restored, step = elastic.resume_on_mesh(str(tmp_path), {"w": w}, mesh,
                                            shardings)
    assert step == 5
    assert restored["w"].placements == (Replicate(), Shard(0))
    assert torch.equal(restored["w"].full_tensor(), w)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoints_cross_between_the_packages(tmp_path, writer):
    """float32 and int32 leaves of a (params, state) tuple tree written by
    either package restore in the other bit for bit, manifest equal."""
    rng = np.random.default_rng(9)
    tree = ({"embed": rng.standard_normal((5, 3)).astype(np.float32),
             "layers": {"wq": rng.standard_normal((2, 3, 4)).astype(
                 np.float32)}},
            {"m": {"x": rng.standard_normal(7).astype(np.float32)},
             "step": np.int32(12)})
    port = jax.tree.map(torch.from_numpy,
                        jax.tree.map(np.asarray, tree))
    ref = jax.tree.map(jnp.asarray, tree)
    if writer == "port":
        ck.save_checkpoint(str(tmp_path), 3, port)
        got, step = jck.restore_checkpoint(str(tmp_path), ref)
        leaves = [np.asarray(x) for x in jax.tree.leaves(got)]
    else:
        jck.save_checkpoint(str(tmp_path), 3, ref)
        got, step = ck.restore_checkpoint(str(tmp_path), port)
        leaves = [x.numpy() for _, x in ck._flatten(got)]
    assert step == 3
    for g, w in zip(leaves, jax.tree.leaves(jax.tree.map(np.asarray, tree))):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    with open(os.path.join(str(tmp_path), "step_0000000003",
                           "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["paths"] == ["0/embed", "0/layers/wq", "1/m/x", "1/step"]
    assert manifest["dtypes"] == ["float32", "float32", "float32", "int32"]


def test_bfloat16_leaf_raises_naming_it(tmp_path):
    tree = {"layers": {"wq": torch.ones(2, dtype=torch.bfloat16)}}
    with pytest.raises(TypeError, match="'layers/wq' is bfloat16"):
        ck.save_checkpoint(str(tmp_path), 1, tree)
    c = ck.AsyncCheckpointer(str(tmp_path), keep=1)
    with pytest.raises(TypeError, match="'layers/wq' is bfloat16"):
        c.save(1, tree)
    c.close()


# --------------------------------------------------------------------------
# elastic policies
# --------------------------------------------------------------------------

def test_elastic_plan_keeps_global_batch(mesh):
    plan = elastic.plan_for_mesh(mesh, global_batch=256,
                                 base_data_parallel=16)
    assert plan.accum_steps == 16
    assert plan.accum_steps * plan.per_step_batch == 256


def test_straggler_policy_flags_then_remeshes():
    pol = elastic.StragglerPolicy(deadline_factor=2.0, max_flags=2)
    for _ in range(8):
        assert pol.observe(1.0) == "ok"
    assert pol.observe(5.0) == "flag"
    assert pol.observe(5.0) == "remesh"
    assert pol.observe(1.0) == "ok"


def test_heartbeat_monitor():
    t = [0.0]
    mon = elastic.HeartbeatMonitor(timeout_s=10.0, now=lambda: t[0])
    mon.beat("w0")
    mon.beat("w1")
    t[0] = 5.0
    mon.beat("w0")
    t[0] = 12.0
    assert mon.dead() == ["w1"]


# --------------------------------------------------------------------------
# cells
# --------------------------------------------------------------------------

def _spec_entries(sds):
    """A reference ShapeDtypeStruct's (shape, dtype, spec entries)."""
    return tuple(sds.shape), _DTYPES[jnp.dtype(sds.dtype)], \
        tuple(sds.sharding.spec)


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cell_specs_equal_the_references(mesh, arch, reduced):
    """Train, prefill and decode: every argument's shape, dtype and
    placements (the reference's PartitionSpec on the port's mesh), the
    kind, the donated arguments and the model flops."""
    jm = jmesh.make_host_mesh()
    for kind, shape in SHAPES.items():
        got = cells.build_lm_cell(arch, shape, mesh, reduced=reduced)
        want = jcells.build_lm_cell(arch, shape, jm, reduced=reduced)
        assert got.kind == want.kind == kind
        assert got.donate == want.donate
        assert got.model_flops_per_step == want.model_flops_per_step
        assert len(got.args) == len(want.args)
        for g_arg, w_arg in zip(got.args, want.args):
            g_leaves = topt.tree_leaves(g_arg) if isinstance(g_arg, dict) \
                else [g_arg]
            w_leaves = jax.tree.leaves(w_arg)
            assert len(g_leaves) == len(w_leaves)
            for g, w in zip(g_leaves, w_leaves):
                shape_, dtype, spec = _spec_entries(w)
                assert (g.shape, g.dtype) == (shape_, dtype)
                assert g.placements == placements(mesh, spec)


def test_lm_model_flops_equal_the_references():
    for arch in LM_ARCHS:
        jcfg = jconfigs.get_arch(arch).make_config()
        tcfg = tconfigs.get_arch(arch).make_config()
        for kind in ("train", "prefill", "decode"):
            assert cells.lm_model_flops(tcfg, 4096, kind) == \
                jcells.lm_model_flops(jcfg, 4096, kind)


@pytest.mark.parametrize("arch", ["dlrm-mlperf", "mace"])
def test_build_cell_raises_for_the_other_families(mesh, arch):
    """The recsys and GNN families build on one rank and raise on a mesh
    of more than one (the production layout's 256 ranks), naming item
    15(d)."""
    from repro_torch.launch.dryrun import PRODUCTION
    shape = "train_batch" if arch == "dlrm-mlperf" else "molecule"
    assert cells.build_cell(arch, shape, mesh, reduced=True).kind == "train"
    with pytest.raises(NotImplementedError, match=r"item 15\(d\)"):
        cells.build_cell(arch, shape, PRODUCTION["single"][1], reduced=True)
