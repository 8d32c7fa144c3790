"""The port's recsys rankers (``models/recsys.py``) and their cells against
the JAX package on the CPU, at the reduced configs of the four archs
(AutoInt, DCN-v2, DIEN, DLRM; f32).

The same numpy inputs go through both packages. Tolerances, with their
reasons:

* inits, the cells' specs and flop counts, the EmbeddingBag's integer
  bookkeeping (which rows are NaN, empty bags), the donated AdamW step
  against the functional one, the tree flatten order: equal;
* forward outputs, losses and gradients: rtol 1e-5, atol 1e-6 (the same
  f32 products and sums in another order);
* the train cell's parameters after n steps: atol 2 lr(step) summed over
  the n steps (see ``tests/test_torch_train.py``);
* retrieval: the same top-k positions on tie-free scores, scores within
  the forward tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import cells as jcells
from repro.launch import mesh as jmesh
from repro.launch import train as jtrain
from repro.models import recsys as jrs
from repro.train import optimizer as jopt
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.core import prng
from repro_torch.distributed.sharding import placements
from repro_torch.launch import cells
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as ttrain
from repro_torch.models import recsys as trs
from repro_torch.train import optimizer as topt

TOL = dict(rtol=1e-5, atol=1e-6)
RECSYS = ["autoint", "dcn-v2", "dien", "dlrm-mlperf"]
_DTYPES = {jnp.dtype(jnp.float32): torch.float32,
           jnp.dtype(jnp.int32): torch.int32,
           jnp.dtype(jnp.bool_): torch.bool}

jforward = jax.jit(jrs.recsys_forward, static_argnums=2)
jloss_grad = jax.jit(jax.value_and_grad(jrs.bce_loss), static_argnums=2)
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


def _cfgs(arch):
    return (jconfigs.get_arch(arch).make_reduced(),
            tconfigs.get_arch(arch).make_reduced())


def _batch(cfg, b, seed):
    """A numpy batch of ``b`` rows with in-range ids."""
    rng = np.random.default_rng(seed)
    if cfg.arch == "dien":
        t = cfg.seq_len
        mask = (rng.random((b, t)) < 0.7).astype(np.float32)
        if b > 1:
            mask[0] = 0.0                     # a row with no history
        return {"target_item": rng.integers(0, cfg.item_vocab, b),
                "target_cat": rng.integers(0, cfg.cat_vocab, b),
                "hist_items": rng.integers(0, cfg.item_vocab, (b, t)),
                "hist_cats": rng.integers(0, cfg.cat_vocab, (b, t)),
                "hist_mask": mask,
                "label": rng.integers(0, 2, b).astype(np.float32)}
    cards = (trs._autoint_cards(cfg) if cfg.arch == "autoint"
             else cfg.vocab_sizes)
    out = {"sparse": np.stack([rng.integers(0, v, b) for v in cards], 1),
           "label": rng.integers(0, 2, b).astype(np.float32)}
    if cfg.n_dense:
        out["dense"] = rng.standard_normal((b, cfg.n_dense)).astype(
            np.float32)
    return out


def _as(tree, to):
    return {k: to(v.astype(np.int32) if v.dtype.kind == "i" else v)
            for k, v in tree.items()}


def _close_trees(got, want, **tol):
    g_leaves, w_leaves = topt.tree_leaves(got), jax.tree.leaves(want)
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        np.testing.assert_allclose(interop.to_numpy(g), np.asarray(w), **tol)


# --------------------------------------------------------------------------
# trees, inits
# --------------------------------------------------------------------------

def test_tree_leaves_flatten_in_jaxs_order():
    """Lists in index order, int keys sorted, str keys sorted: a tree's
    leaves, unflattened and mapped, come back where JAX puts them."""
    tree = {"b": [{"z": 0, "a": 1}, {"a": 2}], "a": {10: 3, 2: 4, 0: 5},
            "m": [6, [7, 8]]}
    assert topt.tree_leaves(tree) == jax.tree.leaves(tree)
    again = topt.tree_unflatten(tree, topt.tree_leaves(tree))
    assert again == tree and type(again["b"]) is list
    assert topt.tree_map(lambda x, y: x + y, tree, tree) == \
        jax.tree.map(lambda x, y: x + y, tree, tree)


@pytest.mark.parametrize("arch", RECSYS)
def test_init_is_the_references_bit_for_bit(arch):
    jcfg, tcfg = _cfgs(arch)
    want = jrs.init_recsys(jax.random.PRNGKey(7), jcfg)
    got = trs.init_recsys(prng.prng_key(7), tcfg, device="cpu")
    ref = interop.model_params(want)
    assert jax.tree.structure(ref) == jax.tree.structure(got)
    for g, w in zip(topt.tree_leaves(got), jax.tree.leaves(want)):
        assert g.dtype == torch.float32
        assert np.array_equal(g.numpy(), np.asarray(w))


# --------------------------------------------------------------------------
# the EmbeddingBag substrate
# --------------------------------------------------------------------------

def _table(rows=11, dim=4, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (rows, dim)).astype(np.float32)


def test_embedding_lookup_keeps_takes_fill_and_wrap():
    """-1 and -rows wrap to the end and the start; an id past either end
    is a row of NaN, as ``jnp.take`` gives it."""
    table = _table()
    ids = np.array([[0, 10, -1, -11], [11, -12, 5, 2 ** 30]], np.int32)
    want = np.asarray(jrs.embedding_lookup(jnp.asarray(table),
                                           jnp.asarray(ids)))
    got = trs.embedding_lookup(torch.from_numpy(table),
                               torch.from_numpy(ids)).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(want[1, :2]).all() and not np.isnan(want[0]).any()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_matches_reference(mode, weighted):
    """Bags of 0 (bag 1), 1 and several ids, with the layout's first ids
    before ``offsets[0]`` in no bag."""
    table = _table()
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 11, 14).astype(np.int32)
    offsets = np.array([2, 5, 5, 6, 12], np.int32)
    w = rng.random(14).astype(np.float32) if weighted else None
    want = np.asarray(jrs.embedding_bag(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(offsets),
        num_bags=5, weights=None if w is None else jnp.asarray(w),
        mode=mode))
    got = trs.embedding_bag(
        torch.from_numpy(table), torch.from_numpy(ids),
        torch.from_numpy(offsets), num_bags=5,
        weights=None if w is None else torch.from_numpy(w), mode=mode)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if mode == "max":
        assert np.isneginf(want[1]).all()
    else:
        assert (want[1] == 0).all()


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_masked_bag_matches_reference(mode):
    table = _table()
    rng = np.random.default_rng(4)
    ids = rng.integers(-1, 11, (5, 6)).astype(np.int32)
    mask = rng.random((5, 6)) < 0.6
    mask[1] = False
    want = np.asarray(jrs.masked_bag(jnp.asarray(table), jnp.asarray(ids),
                                     jnp.asarray(mask), mode))
    got = trs.masked_bag(torch.from_numpy(table), torch.from_numpy(ids),
                         torch.from_numpy(mask), mode).numpy()
    np.testing.assert_allclose(got, want, **TOL)


# --------------------------------------------------------------------------
# forward, loss, gradients, retrieval
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", RECSYS)
def test_forward_loss_and_grads_match_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jp = jrs.init_recsys(jax.random.PRNGKey(1), jcfg)
    tp = interop.model_params(jp)
    batch = _batch(tcfg, 16, seed=2)
    jb, tb = _as(batch, jnp.asarray), _as(batch, torch.from_numpy)
    np.testing.assert_allclose(
        trs.recsys_forward(tp, tb, tcfg).numpy(),
        np.asarray(jforward(jp, jb, jcfg)), **TOL)
    loss, grads = cells.value_and_grad(trs.bce_loss, tp, tb, tcfg)
    jl, jg = jloss_grad(jp, jb, jcfg)
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    _close_trees(grads, jg, **TOL)


@pytest.mark.parametrize("arch", RECSYS)
def test_user_vector_item_matrix_and_scores_match_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jp = jrs.init_recsys(jax.random.PRNGKey(2), jcfg)
    tp = interop.model_params(jp)
    batch = _batch(tcfg, 3, seed=5)
    batch.pop("label")
    jb, tb = _as(batch, jnp.asarray), _as(batch, torch.from_numpy)
    np.testing.assert_allclose(trs.user_vector(tp, tb, tcfg).numpy(),
                               np.asarray(jrs.user_vector(jp, jb, jcfg)),
                               **TOL)
    items = trs.item_matrix(tp, tcfg)
    assert np.array_equal(items.numpy(),
                          np.asarray(jrs.item_matrix(jp, jcfg)))
    assert items.shape[1] == trs.item_matrix_dim(tcfg) == \
        jrs.item_matrix_dim(jcfg)
    cand = np.random.default_rng(6).integers(
        0, items.shape[0], 300).astype(np.int32)
    np.testing.assert_allclose(
        trs.retrieval_scores(tp, tb, tcfg, torch.from_numpy(cand)).numpy(),
        np.asarray(jrs.retrieval_scores(jp, jb, jcfg, jnp.asarray(cand))),
        **TOL)


@pytest.mark.parametrize("arch", RECSYS)
def test_retrieval_step_matches_reference_top_k(mesh, arch):
    """The retrieval cell's step (the dense top-k's plain path here)
    against the reference's ``lax.top_k`` of ``retrieval_scores``, on
    candidates that cover the item rows in a shuffled order: a row drawn
    twice is an exact tie, which both take at the lower position; no two
    distinct scores lie near each other."""
    jcfg, tcfg = _cfgs(arch)
    cell = cells.build_recsys_cell(arch, "retrieval_cand", mesh,
                                   reduced=True)
    jp = jrs.init_recsys(jax.random.PRNGKey(3), jcfg)
    tp = interop.model_params(jp)
    batch = _batch(tcfg, 1, seed=7)
    batch.pop("label")
    jb, tb = _as(batch, jnp.asarray), _as(batch, torch.from_numpy)
    rows = trs.item_matrix(tp, tcfg).shape[0]
    nc = cell.args[2].shape[0]
    cand = np.random.default_rng(8).permutation(
        np.arange(nc) % rows).astype(np.int32)
    scores = jrs.retrieval_scores(jp, jb, jcfg, jnp.asarray(cand))
    ws, wi = jax.lax.top_k(scores, min(100, nc))
    gs, gi = cell.fn(tp, tb, torch.from_numpy(cand))
    s = np.unique(np.asarray(scores)[0])[::-1][:101]
    err = TOL["atol"] + TOL["rtol"] * np.abs(s).max()
    assert np.min(s[:-1] - s[1:]) > 2 * err, "the draw has near-ties"
    assert np.array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), **TOL)


# --------------------------------------------------------------------------
# cells
# --------------------------------------------------------------------------

def test_recsys_flops_equal_the_references():
    for arch in RECSYS:
        spec_j, spec_t = jconfigs.get_arch(arch), tconfigs.get_arch(arch)
        for make in ("make_config", "make_reduced"):
            jcfg, tcfg = getattr(spec_j, make)(), getattr(spec_t, make)()
            for b in (1, 512, 65536):
                assert cells._recsys_flops(tcfg, b) == \
                    jcells._recsys_flops(jcfg, b)


def _spec_entries(sds):
    return tuple(sds.shape), _DTYPES[jnp.dtype(sds.dtype)], \
        tuple(sds.sharding.spec)


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", RECSYS)
def test_recsys_cell_specs_equal_the_references(mesh, arch, reduced):
    """Train, serve and retrieval: every argument's shape, dtype and
    placements (the reference's PartitionSpec on the port's mesh), the
    kind, the donated arguments and the model flops."""
    jm = jmesh.make_host_mesh()
    for shape in tconfigs.RECSYS_SHAPES:
        got = cells.build_cell(arch, shape, mesh, reduced=reduced)
        want = jcells.build_cell(arch, shape, jm, reduced=reduced)
        assert got.kind == want.kind
        assert got.donate == want.donate
        assert got.model_flops_per_step == want.model_flops_per_step
        assert len(got.args) == len(want.args)
        for g_arg, w_arg in zip(got.args, want.args):
            g_leaves, w_leaves = topt.tree_leaves(g_arg), \
                jax.tree.leaves(w_arg)
            assert len(g_leaves) == len(w_leaves)
            for g, w in zip(g_leaves, w_leaves):
                shape_, dtype, spec = _spec_entries(w)
                assert (g.shape, g.dtype) == (shape_, dtype)
                assert g.placements == placements(mesh, spec)


def _adam_atol(steps: int) -> float:
    return sum(2 * topt._schedule(torch.tensor(s), topt.AdamWConfig()).item()
               for s in range(1, steps + 1))


@pytest.mark.parametrize("arch", RECSYS)
def test_train_cell_matches_reference(mesh, arch):
    """``launch/train``'s initial draw bit-equal to the reference
    launcher's; 3 steps of the cell against the reference's loss,
    gradient and ``adamw_update`` composed directly: losses within the
    tolerance, parameters and moments within 2 lr(step) a step."""
    jcfg, _ = _cfgs(arch)
    cell = cells.build_cell(arch, "train_batch", mesh, reduced=True)
    jcell = jcells.build_cell(arch, "train_batch", jmesh.make_host_mesh(),
                              reduced=True)
    jparams = jax.tree.map(lambda x: x * 0.02, jtrain._batch_like(
        jcell.args[0], 0, np.random.default_rng(0)))
    params = ttrain.initial_params(cell, 0, "cpu")
    for g, w in zip(topt.tree_leaves(params), jax.tree.leaves(jparams)):
        assert np.array_equal(g.numpy(), np.asarray(w))
    opt, jstate = topt.adamw_init(params), jopt.adamw_init(jparams)
    for step in range(3):
        batch = ttrain.step_batch(cell, step, "cpu")
        jb = jtrain._batch_like(jcell.args[2], step,
                                np.random.default_rng(step))
        for g, w in zip(topt.tree_leaves(batch), jax.tree.leaves(jb)):
            assert np.array_equal(g.numpy(), np.asarray(w))
        params, opt, loss = cell.fn(params, opt, batch)
        jl, jg = jloss_grad(jparams, jb, jcfg)
        jparams, jstate, _ = jadamw(jg, jstate, jparams, jopt.AdamWConfig())
        np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    atol = _adam_atol(3)
    _close_trees(params, jparams, rtol=0, atol=atol)
    _close_trees(opt["m"], jstate["m"], rtol=0, atol=atol)


@pytest.mark.parametrize("scale", [1.0, 1e-4], ids=["clipped", "unclipped"])
def test_donated_update_on_a_recsys_tree_is_the_functional_one(scale):
    """DCN-v2's tree (``cross``, ``deep`` lists): ``adamw_update_`` writes
    ``adamw_update``'s values bit for bit, no leaf moved, and both agree
    with the reference's ``adamw_update``."""
    _, tcfg = _cfgs("dcn-v2")
    rng = np.random.default_rng(11)
    shapes = trs.init_recsys(prng.prng_key(0), tcfg, device="meta")

    def draw(positive=False):
        return topt.tree_map(lambda s: torch.from_numpy(
            (np.abs if positive else np.asarray)(rng.standard_normal(
                tuple(s.shape))).astype(np.float32)), shapes)
    params, grads = draw(), topt.tree_map(lambda g: g * scale, draw())
    state = {"m": draw(), "v": topt.tree_map(lambda v: v * 1e-3,
                                            draw(positive=True)),
             "step": torch.tensor(9, dtype=torch.int32)}
    ocfg = topt.AdamWConfig(warmup_steps=10, total_steps=100)
    want_p, want_s, want_info = topt.adamw_update(grads, state, params, ocfg)
    got_p, got_s = (topt.tree_map(torch.clone, params),
                    topt.tree_map(torch.clone, state))
    ptrs = [t.data_ptr() for t in topt.tree_leaves(got_p)
            + topt.tree_leaves(got_s)]
    topt.adamw_update_(topt.tree_map(torch.clone, grads), got_s, got_p,
                       ocfg)
    assert ptrs == [t.data_ptr() for t in topt.tree_leaves(got_p)
                    + topt.tree_leaves(got_s)]
    for got, want in zip(topt.tree_leaves(got_p) + topt.tree_leaves(got_s),
                         topt.tree_leaves(want_p) + topt.tree_leaves(want_s)):
        assert torch.equal(got, want)
    np_tree = lambda t: jax.tree.map(jnp.asarray, topt.tree_map(
        interop.to_numpy, t))
    ref_p, ref_s, ref_info = jadamw(np_tree(grads), np_tree(state),
                                    np_tree(params), jopt.AdamWConfig(
                                        warmup_steps=10, total_steps=100))
    np.testing.assert_allclose(float(want_info["grad_norm"]),
                               float(ref_info["grad_norm"]), rtol=1e-6)
    _close_trees(got_p, ref_p, rtol=1e-6, atol=1e-7)
    _close_trees(got_s["m"], ref_s["m"], rtol=1e-6, atol=1e-7)


def test_launcher_trains_dlrm_and_resumes_bit_equal(tmp_path):
    """``launch/train --arch dlrm-mlperf`` (the reference launcher's own
    example): 6 steps then resumed to 10 equal 10 uninterrupted."""
    import contextlib
    import io
    run = lambda steps, d: ttrain.main(
        ["--arch", "dlrm-mlperf", "--steps", str(steps), "--device", "cpu",
         "--checkpoint-dir", str(tmp_path / d)])
    with contextlib.redirect_stdout(io.StringIO()):
        first, second, whole = run(6, "a"), run(10, "a"), run(10, "b")
    assert len(first) == 6 and len(second) == 4
    assert first + second == whole and np.isfinite(whole).all()
