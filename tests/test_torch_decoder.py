"""The port's LM decoder and RAG serving against the JAX package on the CPU:
the LM configs, init, ``moe_ffn``, ``lm_loss``, ``prefill``,
``decode_step``, ``ServeEngine`` and ``RagEngine``, at the reduced configs
of the five LM architectures (f32).

The same numpy inputs go through both packages; weights and caches are
carried across with ``interop``. Tolerances, with their reasons:

* initial parameters, configs, accounting, greedy and sampled tokens,
  cache ``pos``, retrieved ids and request outputs: equal;
* logits, hidden values and caches: rtol 1e-5, atol 1e-5 (f32 values of
  order 1; XLA and torch sum the products, and take softmax, cos, sin and
  rsqrt, to within a few ulps of each other);
* ``moe_ffn``'s output and auxiliary loss: the same (its routing
  decisions are held equal, its sums are f32);
* losses and gradients: rtol 1e-4, atol 1e-5 (backward passes sum in
  other orders too); the port's gradient under ``remat="full"`` equal to
  its own under ``"none"`` bit for bit (the checkpoint recomputes the same
  operations).

The reference's serving engine jits ``decode_step`` through a fresh lambda
per engine; here each reference engine steps through one shared jit of
the same function (the same values, one compile).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import msmarco_windtunnel as jmsmarco
from repro.data.synthetic import generate_corpus as jgenerate_corpus
from repro.models import transformer as jtf
from repro.retrieval import search_core as jsc
from repro.retrieval.tfidf import tfidf_vectors as jtfidf
from repro.serve import engine as jeng
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.configs import msmarco_windtunnel as tmsmarco
from repro_torch.core import prng
from repro_torch.data.synthetic import generate_corpus
from repro_torch.device import default_engine
from repro_torch.models import transformer as ttf
from repro_torch.obs import REGISTRY
from repro_torch.retrieval import search_core as tsc
from repro_torch.retrieval.tfidf import tfidf_vectors
from repro_torch.serve import engine as teng
from repro_torch.train import optimizer as topt

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
LM_ARCHS = [a for a in jconfigs.ARCH_IDS
            if jconfigs.get_arch(a).family == "lm"]
CPU = dict(device="cpu")

_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}

# the reference's functions, jitted here once per config
jprefill = jax.jit(jtf.prefill, static_argnums=2)
jdecode = jax.jit(jtf.decode_step, static_argnums=3)
jmoe = jax.jit(jtf.moe_ffn, static_argnums=4)
jloss_grad = jax.jit(jax.value_and_grad(jtf.lm_loss), static_argnums=2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's ops on one thread here: these tensors are small, and
    torch's CPU thread pool beside XLA's (and other test workers') spends
    far longer waiting than computing on them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_cfg(jcfg):
    """The reference's TransformerConfig as the port's, field for field."""
    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(jtf.TransformerConfig)}
    for name in ("dtype", "param_dtype"):
        kw[name] = _DTYPES[kw[name]]
    if kw["moe"] is not None:
        kw["moe"] = ttf.MoEConfig(**dataclasses.asdict(kw["moe"]))
    return ttf.TransformerConfig(**kw)


def _reduced(arch):
    jcfg = jconfigs.get_arch(arch).make_reduced()
    return jcfg, tconfigs.get_arch(arch).make_reduced()


@functools.lru_cache(maxsize=None)
def _arch(arch):
    """The reduced config's (jcfg, tcfg, jparams, tparams), each package's
    tree drawn by its own init from seed 3 (held bit-equal by
    ``test_init_is_the_references_bit_for_bit``), once per arch."""
    jcfg, tcfg = _reduced(arch)
    jparams = jtf.init_transformer(jax.random.PRNGKey(3), jcfg)
    tparams = ttf.init_transformer(prng.prng_key(3), tcfg, **CPU)
    return jcfg, tcfg, jparams, tparams


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, **tol):
    np.testing.assert_allclose(interop.to_numpy(got), np.asarray(want),
                               **(tol or FWD_TOL))


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


# --------------------------------------------------------------------------
# configs and accounting
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_arch_config_matches_reference(arch):
    """Every field of the published and the reduced config, and the spec's
    own fields, equal the reference's (dtypes as their torch names)."""
    jspec, tspec = jconfigs.get_arch(arch), tconfigs.get_arch(arch)
    for make in ("make_config", "make_reduced"):
        assert getattr(tspec, make)() == _port_cfg(getattr(jspec, make)())
    for f in dataclasses.fields(jconfigs.ArchSpec):
        if not f.name.startswith("make_"):
            assert getattr(tspec, f.name) == getattr(jspec, f.name), f.name


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_accounting_matches_reference(arch):
    """count_params, active_params and param_logical_axes of the published
    and the reduced config; the reduced tree's elements add up to
    count_params."""
    for make in ("make_config", "make_reduced"):
        jcfg = getattr(jconfigs.get_arch(arch), make)()
        tcfg = getattr(tconfigs.get_arch(arch), make)()
        assert ttf.count_params(tcfg) == jtf.count_params(jcfg)
        assert ttf.active_params(tcfg) == jtf.active_params(jcfg)
        assert ttf.param_logical_axes(tcfg) == jtf.param_logical_axes(jcfg)
    params = _arch(arch)[3]
    assert sum(t.numel() for t in topt.tree_leaves(params)) == \
        ttf.count_params(tcfg)
    if arch == "gemma-2b":
        assert ttf.count_params(tconfigs.get_arch(arch).make_config()) == \
            2_506_172_416


def test_registry_matches_reference():
    """Every id resolves, in the reference's family, and ``iter_cells``
    yields the reference's cells, the non-LM archs' included."""
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs.list_archs() == jconfigs.list_archs()
    for table in ("LM_SHAPES", "RECSYS_SHAPES", "GNN_SHAPES"):
        assert getattr(tconfigs, table) == getattr(jconfigs, table)
    for arch in tconfigs.ARCH_IDS:
        got, want = tconfigs.get_arch(arch), jconfigs.get_arch(arch)
        assert (got.arch_id, got.family, got.shapes, got.skip_shapes,
                got.notes) == (want.arch_id, want.family, want.shapes,
                               want.skip_shapes, want.notes)
    for skipped in (False, True):
        assert list(tconfigs.iter_cells(include_skipped=skipped)) == \
            list(jconfigs.iter_cells(include_skipped=skipped))
    assert len(LM_ARCHS) == 5


def test_msmarco_config_matches_reference():
    """Field for field; the port's ``WindTunnelConfig.engine`` None is the
    device's default engine, the reference's ``sort`` on the CPU."""
    got, want = tmsmarco.CONFIG, jmsmarco.CONFIG
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(w):
            for ff in dataclasses.fields(w):
                gv, wv = getattr(g, ff.name), getattr(w, ff.name)
                if ff.name == "engine" and gv is None:
                    gv = default_engine(torch.device("cpu"))
                assert gv == _DTYPES.get(wv, wv), ff.name
        else:
            assert g == w, f.name


# --------------------------------------------------------------------------
# init, interop
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_init_is_the_references_bit_for_bit(arch):
    jcfg, tcfg, jparams, tparams = _arch(arch)
    want = _np_tree(jparams)
    assert jax.tree.structure(want) == jax.tree.structure(
        jax.tree.map(lambda t: 0, tparams))
    for g, w in zip(topt.tree_leaves(tparams), jax.tree.leaves(want)):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert np.array_equal(g.numpy(), w)
    # interop carries the tree (MoE leaves too) leaf for leaf
    carried = interop.transformer_params(want)
    for g, t in zip(topt.tree_leaves(carried), topt.tree_leaves(tparams)):
        assert torch.equal(g, t)


def test_chunked_draw_equals_the_whole_draw(monkeypatch):
    """A draw made in pieces of flat positions (``start``) equals the whole
    draw, and so does init's chunked leaf draw."""
    key = prng.prng_key(11)
    whole = prng.normal(key, (7, 129))
    flat = whole.reshape(-1)
    for cuts in ([0, 1, 903], [0, 500, 501, 903], [0, 64, 128, 903]):
        pieces = [prng.normal(key, (b - a,), start=a)
                  for a, b in zip(cuts, cuts[1:])]
        assert torch.equal(torch.cat(pieces), flat)
    scale = torch.tensor(np.float32(np.sqrt(129)))
    monkeypatch.setattr(ttf, "DRAW_CHUNK", 100)
    got = ttf._dense_init(key, (7, 129), 1, torch.float32, "cpu")
    assert torch.equal(got, (whole.double() / scale.double()).float())


def test_kv_cache_interop_and_sharding_options_raise():
    """The reference's KV cache carried across, and the port's empty one
    shaped alike. (The activation-sharding options no longer raise: each
    is held to leave every value as it is by
    ``test_sharding_option_leaves_values_as_they_are``.)"""
    jcfg, tcfg = _reduced("gemma-2b")
    jc = jtf.init_kv_cache(jcfg, 2, 8, dtype=jnp.bfloat16)
    jc = dict(jc, k=jc["k"] + 1.5, pos=jnp.asarray([3, 5], jnp.int32))
    tc = interop.kv_cache(_np_tree(jc))
    assert tc["k"].dtype == torch.bfloat16 and tc["pos"].dtype == torch.int32
    assert tc["k"].shape == jc["k"].shape and bool((tc["k"] == 1.5).all())
    assert tc["pos"].tolist() == [3, 5]
    empty = ttf.init_kv_cache(tcfg, 2, 8, **CPU)
    assert {k: (tuple(v.shape), v.dtype) for k, v in empty.items()} == {
        "k": (tuple(jc["k"].shape), torch.float32),
        "v": (tuple(jc["k"].shape), torch.float32),
        "pos": ((2,), torch.int32)}


@pytest.mark.parametrize("opt", [
    dict(act_batch_axes=("data",)), dict(act_model_axis="model"),
    dict(attn_shard="dh"), dict(seq_parallel=True)],
    ids=["act_batch_axes", "act_model_axis", "attn_shard_dh",
         "seq_parallel"])
def test_sharding_option_leaves_values_as_they_are(opt):
    """In the reference these are sharding constraints (where a value
    lives); on one rank ``init_transformer``, ``lm_loss`` and ``prefill``
    with the option set are bit-equal to the same calls without it."""
    _, tcfg = _reduced("gemma-2b")
    cfg = dataclasses.replace(tcfg, **opt)
    params = ttf.init_transformer(prng.prng_key(0), cfg, **CPU)
    base = ttf.init_transformer(prng.prng_key(0), tcfg, **CPU)
    for got, want in zip(topt.tree_leaves(params), topt.tree_leaves(base)):
        assert torch.equal(got, want)
    toks = torch.from_numpy(_tokens(tcfg.vocab_size, (2, 12), seed=4))
    with torch.no_grad():
        assert torch.equal(ttf.lm_loss(params, toks, cfg),
                           ttf.lm_loss(base, toks, tcfg))
        (lg, cg), (lb, cb) = (ttf.prefill(params, toks, cfg),
                              ttf.prefill(base, toks, tcfg))
    assert torch.equal(lg, lb)
    for name in ("k", "v", "pos"):
        assert torch.equal(cg[name], cb[name])


# --------------------------------------------------------------------------
# moe_ffn, lm_loss
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mixtral-8x22b", "llama4-scout-17b-a16e"])
def test_moe_ffn_matches_reference(arch):
    """Output and auxiliary loss at capacity factor 0.5, where tokens drop
    (their count checked from the routing); top-2 and top-1."""
    jcfg, tcfg, jparams, tparams = _arch(arch)
    cf = 0.5
    jcfg = dataclasses.replace(jcfg, moe=jtf.MoEConfig(
        jcfg.moe.num_experts, jcfg.moe.top_k, cf))
    tcfg = dataclasses.replace(tcfg, moe=ttf.MoEConfig(
        tcfg.moe.num_experts, tcfg.moe.top_k, cf))
    x = np.random.default_rng(1).standard_normal((3, 20, 64)).astype(
        np.float32)
    lp = {k: v[0] for k, v in tparams["layers"].items()}
    got, got_aux = ttf.moe_ffn(torch.from_numpy(x), lp["router"], lp["wi"],
                               lp["wo_ff"], tcfg)
    jl = jax.tree.map(lambda v: v[0], jparams["layers"])
    want, want_aux = jmoe(jnp.asarray(x), jl["router"], jl["wi"],
                          jl["wo_ff"], jcfg)
    _close(got, want)
    np.testing.assert_allclose(float(got_aux), float(want_aux), **FWD_TOL)
    # the capacity dropped assignments
    e, k = tcfg.moe.num_experts, tcfg.moe.top_k
    cap = max(1, int(20 * k * cf / e))
    probs = torch.softmax(torch.from_numpy(x) @ lp["router"], -1)
    topi = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    load = torch.nn.functional.one_hot(topi[..., :k], e).sum((1, 2))
    assert int(torch.clamp(load - cap, min=0).sum()) > 0


def _vocab_510(params, cfg):
    """The tree cut to the first 510 tokens of the vocabulary (the blocked
    loss at 4 chunks then pads 2)."""
    params = dict(params, embed=params["embed"][:510])
    if "lm_head" in params:
        params["lm_head"] = params["lm_head"][:, :510]
    return params, dataclasses.replace(cfg, vocab_size=510)


@pytest.mark.parametrize("arch", ["gemma-2b", "mixtral-8x22b"])
def test_lm_loss_and_remat_gradient_match_reference(arch):
    """The port's loss at vocab_chunks 1 and 4 (510 tokens: 4 chunks of
    128, 2 padded) against the reference's blocked loss, and its gradient
    under remat="full" against the reference's (whose remat changes what
    is saved, not the values); the port's gradient under remat="full"
    equals its own under "none" bit for bit."""
    jcfg, tcfg, jparams, tparams = _arch(arch)
    jparams, jcfg = _vocab_510(jparams, jcfg)
    tparams, tcfg = _vocab_510(tparams, tcfg)
    toks = _tokens(510, (2, 17), seed=4)
    want, want_g = jloss_grad(jparams, jnp.asarray(toks), dataclasses.replace(
        jcfg, vocab_chunks=4))
    leaves = topt.tree_leaves(tparams)
    grads = {}
    for chunks, remat in ((1, "none"), (4, "none"), (4, "full")):
        p = topt.tree_unflatten(tparams, [t.clone().requires_grad_()
                                          for t in leaves])
        loss = ttf.lm_loss(p, torch.from_numpy(toks), dataclasses.replace(
            tcfg, vocab_chunks=chunks, remat=remat))
        np.testing.assert_allclose(loss.item(), float(want), **GRAD_TOL)
        grads[chunks, remat] = torch.autograd.grad(loss, topt.tree_leaves(p))
    for a, b in zip(grads[4, "none"], grads[4, "full"]):
        assert torch.equal(a, b)
    for g, w in zip(grads[4, "full"], jax.tree.leaves(want_g)):
        _close(g, w, **GRAD_TOL)


# --------------------------------------------------------------------------
# prefill, decode_step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma-2b", "mixtral-8x22b",
                                  "llama4-scout-17b-a16e"])
def test_prefill_matches_reference(arch):
    """24-token prompts: mixtral's window and llama4's chunk (16) are
    shorter, so their caches hold the rolled tail; gemma's is the whole
    prompt (MQA, a tied head, scaled embeddings). The other two archs'
    layers run in the decode test."""
    jcfg, tcfg, jparams, tparams = _arch(arch)
    toks = _tokens(jcfg.vocab_size, (2, 24), seed=7)
    got, cache = ttf.prefill(tparams, torch.from_numpy(toks), tcfg)
    want, jcache = jprefill(jparams, jnp.asarray(toks), jcfg)
    _close(got, want)
    assert cache["k"].shape == jcache["k"].shape
    assert cache["k"].shape[2] == ttf.cache_length(tcfg, 24)
    _close(cache["k"], jcache["k"])
    _close(cache["v"], jcache["v"])
    assert cache["pos"].tolist() == np.asarray(jcache["pos"]).tolist()


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_sequence_matches_reference(arch):
    """20 steps over 3 rows from positions 0, 4 and 9 (windowed caches
    wrap); row 2 is fed a constant token, as an idle slot is, and its
    ``pos`` advances like the others'. The given cache is left as it
    was."""
    jcfg, tcfg, jparams, tparams = _arch(arch)
    jcache = jtf.init_kv_cache(jcfg, 3, 20)
    jcache["pos"] = jnp.asarray([0, 4, 9], jnp.int32)
    cache = interop.kv_cache(_np_tree(jcache))
    toks = _tokens(jcfg.vocab_size, (20, 3, 1), seed=8)
    toks[:, 2] = 0
    for t in range(20):
        before = {k: v.clone() for k, v in cache.items()}
        got, new = ttf.decode_step(tparams, cache, torch.from_numpy(toks[t]),
                                   tcfg)
        for k in before:
            assert torch.equal(cache[k], before[k])
        cache = new
        want, jcache = jdecode(jparams, jcache, jnp.asarray(toks[t]), jcfg)
        _close(got, want)
        assert got.argmax(-1).tolist() == np.asarray(
            want.argmax(-1)).tolist()
    assert cache["pos"].tolist() == [20, 24, 29]
    assert cache["pos"].tolist() == np.asarray(jcache["pos"]).tolist()
    _close(cache["k"], jcache["k"])
    _close(cache["v"], jcache["v"])


# --------------------------------------------------------------------------
# ServeEngine, RagEngine
# --------------------------------------------------------------------------

TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=48)


@pytest.fixture(scope="module")
def tiny():
    """The reference serve tests' model and weights (its init from
    ``PRNGKey(0)``, which the port draws bit for bit): (jcfg, tcfg,
    jparams, tparams)."""
    jcfg = jtf.TransformerConfig(**TINY, dtype=jnp.float32)
    tcfg = ttf.TransformerConfig(**TINY, dtype=torch.float32)
    tparams = ttf.init_transformer(prng.prng_key(0), tcfg, **CPU)
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tparams)
    return jcfg, tcfg, jparams, tparams


def _engines(tiny, **scfg):
    jcfg, tcfg, jparams, tparams = tiny
    jeng_ = jeng.ServeEngine(jparams, jcfg, jeng.ServeConfig(**scfg))
    jeng_._step = lambda p, c, t: jdecode(p, c, t, jcfg)
    return jeng_, teng.ServeEngine(tparams, tcfg, teng.ServeConfig(**scfg))


def _submit(engines, prompt):
    return [e.submit(np.array(prompt, np.int32)) for e in engines]


def _outs(reqs):
    return [None if r is None else list(r.out) for r in reqs]


def _case_continuous_batching(tiny):
    engines = _engines(tiny, max_batch=2, max_seq=32, max_new_tokens=4)
    r1, r2 = _submit(engines, [1, 2, 3]), _submit(engines, [4, 5])
    assert _submit(engines, [6]) == [None, None]       # batch full
    steps = [e.drain() for e in engines]
    r3 = _submit(engines, [7, 8])                      # a freed slot
    steps += [e.drain() for e in engines]
    return [r1, r2, r3], steps, engines


def _case_greedy_matches_decode_loop(tiny):
    """The port's engine, the reference's, and the reference's own
    token-by-token greedy loop agree."""
    jcfg, tcfg, jparams, tparams = tiny
    prompt = [3, 9, 27]
    engines = _engines(tiny, max_batch=1, max_seq=32, max_new_tokens=5)
    req = _submit(engines, prompt)
    steps = [e.drain() for e in engines]
    cache, toks, out = jtf.init_kv_cache(jcfg, 1, 32), list(prompt), []
    for t in range(len(prompt) + 4):
        cur = jnp.asarray([[toks[t] if t < len(toks) else out[-1]]],
                          jnp.int32)
        logits, cache = jdecode(jparams, cache, cur, jcfg)
        if t >= len(prompt) - 1:
            out.append(int(jnp.argmax(logits[0, 0])))
    assert req[1].out == out[:5]
    return [req], steps, engines


def _case_slot_reuse(tiny):
    """A reused slot starts from a clean position: its output equals a
    fresh engine's."""
    scfg = dict(max_batch=1, max_seq=32, max_new_tokens=4)
    engines = _engines(tiny, **scfg)
    r1 = _submit(engines, [5, 11, 2])
    steps = [e.drain() for e in engines]
    r2 = _submit(engines, [9, 3])
    steps += [e.drain() for e in engines]
    fresh = _engines(tiny, **scfg)
    rf = _submit(fresh, [9, 3])
    steps += [e.drain() for e in fresh]
    assert r2[1].out == rf[1].out
    return [r1, r2, rf], steps, engines


def _case_simultaneous_finish(tiny):
    engines = _engines(tiny, max_batch=3, max_seq=32, max_new_tokens=3)
    reqs = [_submit(engines, [i + 1, i + 2]) for i in range(3)]
    steps = [e.drain() for e in engines]
    for e in engines:
        assert all(s is None for s in e.slots)
    last = _submit(engines, [7])
    assert None not in last
    return reqs, steps, engines


@pytest.mark.parametrize("case", [_case_continuous_batching,
                                  _case_greedy_matches_decode_loop,
                                  _case_slot_reuse,
                                  _case_simultaneous_finish],
                         ids=lambda c: c.__name__[len("_case_"):])
def test_serve_engine_matches_reference(tiny, case):
    """The reference's four serve tests, each run on both engines: equal
    tokens, drain steps and cache positions."""
    reqs, steps, (je, te) = case(tiny)
    for pair in reqs:
        assert pair[0] is not None and len(pair[0].out) == je.cfg.max_new_tokens
        assert _outs([pair[1]]) == _outs([pair[0]])
        assert pair[1].done == pair[0].done
    assert steps[1::2] == steps[0::2]
    assert te.cache["pos"].tolist() == np.asarray(je.cache["pos"]).tolist()
    assert te.cache["k"].device.type == "cpu"


def test_serve_metrics_drain_bound_and_guard(tiny):
    """The reference's metric names, its derived drain bound and its drain
    guard (``RuntimeError`` with ``.engine_state``, the engine steppable
    after it)."""
    hist = REGISTRY.histogram("serve.request_latency_s")
    done0, count0 = REGISTRY.counter("serve.completed").value, hist.count
    sub0 = REGISTRY.counter("serve.submitted").value
    _, eng = _engines(tiny, max_batch=2, max_seq=32, max_new_tokens=4)
    r1, r2 = (eng.submit(np.array(p, np.int32)) for p in ([1, 2, 3], [4, 5]))
    rej0 = REGISTRY.counter("serve.rejected").value
    assert eng.submit(np.array([6], np.int32)) is None
    assert REGISTRY.counter("serve.rejected").value == rej0 + 1
    bound = sum(r.remaining_prompt + eng.cfg.max_new_tokens
                for r in (r1, r2))
    steps = eng.drain()
    assert r1.done and r2.done and 0 < steps <= bound
    assert REGISTRY.counter("serve.submitted").value == sub0 + 2
    assert REGISTRY.counter("serve.completed").value == done0 + 2
    assert hist.count == count0 + 2
    p = hist.percentiles()
    assert 0.0 < p["p50"] <= p["p99"]
    assert REGISTRY.counter("serve.tokens").value > 0
    assert REGISTRY.histogram("serve.tokens_per_step").count > 0
    assert 0.0 <= REGISTRY.gauge("serve.slot_occupancy").value <= 1.0

    _, eng = _engines(tiny, max_batch=1, max_seq=32, max_new_tokens=4)
    eng.submit(np.array([1, 2, 3, 4], np.int32))
    with pytest.raises(RuntimeError, match="step bound") as ei:
        eng.drain(max_steps=2)
    state = ei.value.engine_state
    assert state["max_batch"] == 1
    slot = state["slots"][0]
    assert slot is not None and not slot["done"]
    assert eng.drain() > 0
    assert eng.slots == [None]


def test_sampled_tokens_match_reference(tiny):
    """temperature > 0: jax.random.categorical's draw, bit for bit, from
    the one key every step of a drain is handed."""
    engines = _engines(tiny, max_batch=3, max_seq=32, max_new_tokens=6,
                       temperature=0.8)
    reqs = [_submit(engines, p) for p in ([1, 2, 3], [4, 5], [9])]
    engines[0].drain(jax.random.PRNGKey(7))
    engines[1].drain(prng.prng_key(7))
    for pair in reqs:
        assert pair[1].out == pair[0].out
    greedy = _engines(tiny, max_batch=1, max_seq=32, max_new_tokens=6)[1]
    g = greedy.submit(np.array([1, 2, 3], np.int32))
    greedy.drain()
    assert g.out != reqs[0][1].out          # the noise changed something


def test_rag_engine_matches_reference(tiny):
    """A tiny tf-idf corpus indexed on half its passages (an ids map), the
    exact engine: the same retrieved ids, prompts and tokens."""
    jcfg, tcfg, jparams, tparams = tiny
    kw = dict(num_queries=48, qrels_per_query=6, num_topics=6, vocab_size=64,
              query_len=8, seed=0)
    corpus, jcorpus = generate_corpus(**kw), jgenerate_corpus(**kw)
    assert np.array_equal(corpus.passage_tokens, jcorpus.passage_tokens)
    kept = np.arange(0, corpus.num_entities, 2)
    vecs, df = tfidf_vectors(corpus.passage_tokens[kept], corpus.vocab_size)
    jvecs, jdf = jtfidf(jcorpus.passage_tokens[kept], jcorpus.vocab_size)
    scfg = dict(max_batch=3, max_seq=64, max_new_tokens=4)
    t_rag = teng.RagEngine(
        teng.RetrievalFrontend(
            vecs, lambda toks: tfidf_vectors(np.asarray(toks),
                                             corpus.vocab_size, df)[0],
            config=tsc.SearchConfig(engine="exact"), ids_map=kept, **CPU),
        teng.ServeEngine(tparams, tcfg, teng.ServeConfig(**scfg)),
        lambda gid: corpus.passage_tokens[gid], ctx_tokens=12)
    j_serve = jeng.ServeEngine(jparams, jcfg, jeng.ServeConfig(**scfg))
    j_serve._step = lambda p, c, t: jdecode(p, c, t, jcfg)
    j_rag = jeng.RagEngine(
        jeng.RetrievalFrontend(
            jvecs, lambda toks: jtfidf(np.asarray(toks),
                                       jcorpus.vocab_size, jdf)[0],
            config=jsc.SearchConfig(engine="exact"), ids_map=kept),
        j_serve, lambda gid: jcorpus.passage_tokens[gid], ctx_tokens=12)
    hit0 = REGISTRY.counter("serve.rag.ctx_hit").value
    got, want = [], []
    for qi in range(6):
        q = corpus.query_tokens[qi]
        for rag, out in ((t_rag, got), (j_rag, want)):
            req, ids = rag.submit_query(q, q, k=3)
            out.append((req, ids))
        if qi % 3 == 2:
            t_rag.engine.drain()
            j_rag.engine.drain()
    for (tr, tids), (jr, jids) in zip(got, want):
        assert np.array_equal(tids, np.asarray(jids))
        assert np.isin(tids, kept).all()
        assert np.array_equal(tr.prompt, jr.prompt)
        assert len(tr.prompt) == 8 + 12
        assert tr.out == jr.out and len(tr.out) == 4
    assert REGISTRY.counter("serve.rag.ctx_hit").value == hit0 + 6
