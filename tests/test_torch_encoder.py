"""The port's retrieval-encoder slice against the JAX package on the CPU:
the plain flash attention, the transformer's forward path, the encoder
(init, forward, loss and gradients), AdamW and Adafactor, ``TokenBatcher``,
``evaluate_sample``, ``train_encoder`` and ``run_table1_experiment``.

The same numpy inputs go through both packages; weights are carried across
with ``interop.transformer_params``. Tolerances, with their reasons:

* attention f32: rtol 1e-5, atol 2e-5, the reference's own kernel
  tolerance (softmax sums and products in other orders); bf16 2e-2, the
  reference's;
* forward, hidden states and embeddings: rtol 1e-5, atol 1e-5 (f32 values
  of order 1; XLA and torch sum the products, and take cos, sin, tanh and
  rsqrt, to within a few ulps of each other);
* loss and gradients: rtol 1e-4, atol 1e-5 (backward passes sum in other
  orders too);
* initial parameters: rtol 1e-6 (``prng.normal`` is bit-equal to
  ``jax.random.normal``; the scaling by the fan-in is not);
* optimizer updates: rtol 1e-6, and 2 ulps of the leaf's largest old
  value absolute (the global norms differ by an ulp or two, being sums
  in other orders, and where a step nearly cancels a parameter the
  result keeps the operands' absolute rounding, not a relative one);
* training losses: rtol 1e-4 at every step;
* samples, masks and counts are held equal; p@3 of the Table I run within
  one hit, since the two encoders' embeddings differ in their last bits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import QRelTable as JQRelTable
from repro.core import WindTunnelConfig, run_windtunnel
from repro.data.batching import TokenBatcher as JTokenBatcher
from repro.data.synthetic import generate_corpus as jgenerate_corpus
from repro.kernels.flash_attention.ops import flash_attention as jflash
from repro.kernels.flash_attention.ref import flash_attention_ref as jflash_ref
from repro.models import transformer as jtf
from repro.retrieval import encoder as jenc
from repro.retrieval import experiment as jexp
from repro.train import optimizer as jopt
from repro_torch import interop
from repro_torch.core import prng
from repro_torch.data.batching import TokenBatcher
from repro_torch.data.synthetic import generate_corpus
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models import transformer as ttf
from repro_torch.retrieval import encoder as tenc
from repro_torch.retrieval import experiment as texp
from repro_torch.train import optimizer as topt

ATTN_TOL = dict(rtol=1e-5, atol=2e-5)
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
SMALL = dict(d_model=32, n_layers=2, n_heads=2, d_ff=64)


# the reference's functions that it does not jit itself, jitted here: one
# XLA compile in place of one per operation
jforward = jax.jit(jtf.transformer_forward, static_argnums=2,
                   static_argnames="return_hidden")
jencode = jax.jit(jtf.encode, static_argnums=2)
jloss_and_grad = jax.jit(jax.value_and_grad(jenc.contrastive_loss),
                         static_argnums=2)
jadamw = jax.jit(jopt.adamw_update, static_argnums=3)
jadafactor = jax.jit(jopt.adafactor_update, static_argnums=3)
jattn_ref = jax.jit(jflash_ref, static_argnames=("causal", "window"))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_close(got, want, **tol):
    got_leaves = topt.tree_leaves(got)
    want_leaves = jax.tree.leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(interop.to_numpy(g), np.asarray(w), **tol)


# --------------------------------------------------------------------------
# attention: the plain version against the reference's kernel and oracle
# --------------------------------------------------------------------------

def _qkv(b, sq, h, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, sq, hkv, d)).astype(np.float32),
            rng.standard_normal((b, sq, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("b,s,h,hkv,d", [
    (2, 64, 4, 2, 32), (1, 128, 8, 8, 64), (2, 96, 4, 1, 32),
    (1, 200, 4, 2, 16), (3, 24, 4, 4, 32)])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 40),
                                           (False, None)])
def test_plain_attention_matches_reference_kernel_and_oracle(
        b, s, h, hkv, d, causal, window):
    """The Pallas kernel runs in interpret mode; s = 24 bidirectional pads
    24 keys to 32 behind the reference's sentinel dimension, which the
    port's exact mask agrees with."""
    q, k, v = _qkv(b, s, h, hkv, d, seed=s * d + h)
    got = flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                              causal=causal, window=window).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_kernel = jflash(jq, jk, jv, causal=causal, window=window,
                         block_q=32, block_kv=32)
    want_ref = jattn_ref(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(want_kernel), **ATTN_TOL)
    np.testing.assert_allclose(got, np.asarray(want_ref), **ATTN_TOL)


def test_plain_attention_bf16_matches_reference():
    q, k, v = _qkv(2, 64, 4, 2, 32, seed=3)
    got = flash_attention_ref(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
        causal=True)
    want = jflash(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                  causal=True, block_q=32, block_kv=32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)


def test_flash_wrapper_raises_when_asked_for_a_gradient():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 8, 2, 2, 16, seed=0))
    with pytest.raises(RuntimeError, match="no gradient"):
        flash_attention(q.requires_grad_(), k, v, causal=False)
    with torch.no_grad():
        out = flash_attention(q, k, v, causal=False)
    assert torch.equal(out, flash_attention_ref(q.detach(), k, v,
                                                causal=False))


# --------------------------------------------------------------------------
# the transformer and the encoder, weights carried across
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def encoder_pair():
    """(reference config, port config, reference params, the same params
    as the port's tensors)."""
    jcfg = jenc.EncoderConfig(vocab_size=64, **SMALL)
    tcfg = tenc.EncoderConfig(vocab_size=64, **SMALL)
    jparams = jenc.init_encoder(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jparams, interop.transformer_params(
        _np_tree(jparams))


def _tokens(b, s, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def test_split_matches_jax_for_many_keys():
    want = jax.random.split(jax.random.PRNGKey(3), 12)
    assert prng.split(prng.prng_key(3), 12) == tuple(
        tuple(int(x) for x in np.asarray(k)) for k in want)


def test_init_encoder_matches_reference(encoder_pair):
    jcfg, tcfg, jparams, _ = encoder_pair
    got = tenc.init_encoder(prng.prng_key(0), tcfg, device="cpu")
    assert set(got) == set(jparams) and set(got["layers"]) == set(
        jparams["layers"])
    _assert_tree_close(got, jparams, rtol=1e-6, atol=0)


def test_encoder_forward_and_embeddings_match_reference(encoder_pair):
    jcfg, tcfg, jparams, tparams = encoder_pair
    toks = _tokens(5, 12, 64, seed=1)
    want_h, _ = jforward(jparams, jnp.asarray(toks),
                                        jcfg.transformer(),
                                        return_hidden=True)
    got_h, aux = ttf.transformer_forward(tparams, torch.from_numpy(toks),
                                         tcfg.transformer(),
                                         return_hidden=True)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **FWD_TOL)
    assert float(aux) == 0.0
    want_logits, _ = jforward(jparams, jnp.asarray(toks),
                                             jcfg.transformer())
    got_logits, _ = ttf.transformer_forward(tparams, torch.from_numpy(toks),
                                            tcfg.transformer())
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               **FWD_TOL)
    want_e = jencode(jparams, jnp.asarray(toks), jcfg.transformer())
    got_e = ttf.encode(tparams, torch.from_numpy(toks), tcfg.transformer())
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), **FWD_TOL)
    valid = np.arange(12)[None, :] < np.array([12, 3, 7, 1, 12])[:, None]
    want_v = jencode(jparams, jnp.asarray(toks), jcfg.transformer(),
                        valid=jnp.asarray(valid))
    got_v = ttf.encode(tparams, torch.from_numpy(toks), tcfg.transformer(),
                       valid=torch.from_numpy(valid))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), **FWD_TOL)
    # embed_corpus: a ragged last batch (the reference pads it, the port
    # does not need to)
    corpus_toks = _tokens(11, 12, 64, seed=2)
    want_c = jenc.embed_corpus(jparams, corpus_toks, jcfg, batch_size=4)
    got_c = tenc.embed_corpus(tparams, corpus_toks, tcfg, batch_size=4,
                              device="cpu")
    assert got_c.dtype == np.float32 and got_c.shape == want_c.shape
    np.testing.assert_allclose(got_c, want_c, **FWD_TOL)


@pytest.mark.parametrize("negatives", [False, True])
def test_contrastive_loss_and_gradients_match_reference(encoder_pair,
                                                        negatives):
    jcfg, tcfg, jparams, tparams = encoder_pair
    batch = {"query_tokens": _tokens(6, 8, 64, seed=3),
             "passage_tokens": _tokens(6, 12, 64, seed=4)}
    if negatives:
        batch["negative_tokens"] = _tokens(6, 12, 64, seed=5)
    want_loss, want_grads = jloss_and_grad(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    leaves = [p.clone().requires_grad_() for p in topt.tree_leaves(tparams)]
    params = topt.tree_unflatten(tparams, leaves)
    loss = tenc.contrastive_loss(
        params, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    grads = topt.tree_unflatten(params, torch.autograd.grad(loss, leaves))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               **GRAD_TOL)
    _assert_tree_close(grads, want_grads, **GRAD_TOL)


@pytest.mark.parametrize("route", ["naive", "blocked", "flash"])
def test_causal_window_gqa_forward_matches_reference(route):
    """A decoder config (GQA 4 over 2 kv heads, window 5, SwiGLU, untied
    head, embed scale) through each attention route of both packages: the
    flash route runs the reference's Pallas kernel in interpret mode and
    the port's plain version."""
    opts = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                n_kv_heads=2, d_ff=48, window=5, causal=True,
                activation="swiglu", embed_scale=True)
    if route == "blocked":
        opts.update(block_q=8, block_kv=8)
    jcfg = jtf.TransformerConfig(dtype=jnp.float32,
                                 use_flash_kernel=route == "flash", **opts)
    tcfg = ttf.TransformerConfig(dtype=torch.float32,
                                 use_flash_kernel=route == "flash", **opts)
    jparams = jtf.init_transformer(jax.random.PRNGKey(1), jcfg)
    tparams = interop.transformer_params(_np_tree(jparams))
    toks = _tokens(3, 20, 64, seed=6)
    want, _ = jforward(jparams, jnp.asarray(toks), jcfg)
    with torch.no_grad():
        got, _ = ttf.transformer_forward(tparams, torch.from_numpy(toks),
                                         tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def test_configs_the_port_leaves_out_raise():
    """The activation-sharding options wait for item 15(b) and raise; MoE,
    remat and the blocked loss are ported and build."""
    base = dict(vocab_size=8, d_model=8, n_layers=1, n_heads=2,
                n_kv_heads=2, d_ff=8)
    for extra in (dict(act_batch_axes=("data",)), dict(attn_shard="dh"),
                  dict(seq_parallel=True)):
        with pytest.raises(NotImplementedError, match=r"item 15\(b\)"):
            ttf.init_transformer(prng.prng_key(0),
                                 ttf.TransformerConfig(**base, **extra))
    for extra in (dict(moe=ttf.MoEConfig(4, 1)), dict(remat="full"),
                  dict(vocab_chunks=4)):
        params = ttf.init_transformer(
            prng.prng_key(0), ttf.TransformerConfig(**base, **extra),
            device="cpu")
        assert ("router" in params["layers"]) == ("moe" in extra)


# --------------------------------------------------------------------------
# optimizers
# --------------------------------------------------------------------------

def _assert_update_close(got, want, old):
    """rtol 1e-6, atol two ulps of the largest old value of each leaf."""
    for g, w, o in zip(topt.tree_leaves(got), jax.tree.leaves(want),
                       jax.tree.leaves(old)):
        atol = 2.0 ** -22 * float(np.abs(np.asarray(o)).max())
        np.testing.assert_allclose(interop.to_numpy(g), np.asarray(w),
                                   rtol=1e-6, atol=atol)


def _random_tree(rng, like, positive=False):
    def leaf(x):
        a = rng.standard_normal(np.shape(x)).astype(np.float32)
        return np.abs(a) * 1e-3 if positive else a
    return jax.tree.map(leaf, like)


@pytest.mark.parametrize("step", [0, 7, 25, 299])
def test_adamw_update_matches_reference(encoder_pair, step):
    """Warm-up (0, 7), cosine decay (25) and the last step (299); the
    gradients are large enough that clipping by the global norm bites."""
    _, _, jparams, _ = encoder_pair
    rng = np.random.default_rng(step)
    grads = _random_tree(rng, jparams)
    state = {"m": _random_tree(rng, jparams),
             "v": _random_tree(rng, jparams, positive=True),
             "step": np.int32(step)}
    cfg = dict(lr=1e-3, warmup_steps=20, total_steps=300, weight_decay=0.01)
    want_p, want_s, want_info = jadamw(
        jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, state),
        jax.tree.map(jnp.asarray, jparams), jopt.AdamWConfig(**cfg))
    got_p, got_s, got_info = topt.adamw_update(
        interop.transformer_params(grads), interop.adamw_state(state),
        interop.transformer_params(_np_tree(jparams)),
        topt.AdamWConfig(**cfg))
    tol = dict(rtol=1e-6, atol=0)
    _assert_update_close(got_p, want_p, jparams)
    _assert_update_close(got_s["m"], want_s["m"], state["m"])
    _assert_update_close(got_s["v"], want_s["v"], state["v"])
    assert int(got_s["step"]) == int(want_s["step"]) == step + 1
    for key in ("lr", "grad_norm"):
        np.testing.assert_allclose(float(got_info[key]),
                                   float(want_info[key]), **tol)
    assert float(want_info["grad_norm"]) > 1.0


def test_adamw_init_matches_reference(encoder_pair):
    _, _, jparams, tparams = encoder_pair
    want = jopt.adamw_init(jparams)
    got = topt.adamw_init(tparams)
    _assert_tree_close(got["m"], want["m"], rtol=0, atol=0)
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 0


@pytest.mark.parametrize("step", [0, 150])
def test_adafactor_update_matches_reference(encoder_pair, step):
    _, _, jparams, _ = encoder_pair
    rng = np.random.default_rng(step + 1)
    grads = _random_tree(rng, jparams)
    jstate = jopt.adafactor_init(jax.tree.map(jnp.asarray, jparams))
    jstate = {"slots": jax.tree.map(
        lambda x: jnp.asarray(np.abs(rng.standard_normal(x.shape))
                              .astype(np.float32) * 1e-3),
        jstate["slots"]), "step": jnp.int32(step)}
    tstate = {"slots": interop.transformer_params(_np_tree(jstate["slots"])),
              "step": torch.tensor(step, dtype=torch.int32)}
    cfg = dict(lr=1e-2, warmup_steps=20, total_steps=300,
               weight_decay=0.001)
    want_p, want_s, want_info = jadafactor(
        jax.tree.map(jnp.asarray, grads), jstate,
        jax.tree.map(jnp.asarray, jparams), jopt.AdafactorConfig(**cfg))
    got_p, got_s, got_info = topt.adafactor_update(
        interop.transformer_params(grads), tstate,
        interop.transformer_params(_np_tree(jparams)),
        topt.AdafactorConfig(**cfg))
    tol = dict(rtol=1e-6, atol=0)
    _assert_update_close(got_p, want_p, jparams)
    _assert_update_close(got_s["slots"], want_s["slots"], jstate["slots"])
    np.testing.assert_allclose(float(got_info["lr"]),
                               float(want_info["lr"]), **tol)
    init = topt.adafactor_init(interop.transformer_params(_np_tree(jparams)))
    assert init["slots"]["layers"]["wq"]["vr"].shape == (2, 32)
    assert init["slots"]["ln_f"]["v"].shape == (32,)


# --------------------------------------------------------------------------
# batching and the slice as a whole
# --------------------------------------------------------------------------

CORPUS = dict(num_queries=48, qrels_per_query=6, num_topics=4,
              vocab_size=128, passage_len=16, query_len=8, seed=3)


@pytest.fixture(scope="module")
def corpora():
    t, j = generate_corpus(**CORPUS), jgenerate_corpus(**CORPUS)
    for a, b in zip(t.qrels, j.qrels):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert np.array_equal(t.passage_tokens, j.passage_tokens)
    return t, j


def test_token_batcher_matches_reference_across_epochs(corpora):
    t, j = corpora
    tb, jb = TokenBatcher(t, 32, seed=2), JTokenBatcher(j, 32, seed=2)
    n_pairs = jb._pairs.shape[0]
    steps = range(2 * n_pairs // 32 + 2)     # two epoch boundaries
    assert len(steps) > 2
    for step in steps:
        got, want = tb.contrastive_batch(step), jb.contrastive_batch(step)
        assert set(got) == set(want)
        for key in want:
            assert np.array_equal(got[key], want[key]), (step, key)
    assert np.array_equal(tb.lm_batch(3, 40)["tokens"],
                          jb.lm_batch(3, 40)["tokens"])


ENC = dict(d_model=32, n_layers=2, n_heads=2, d_ff=64)


def test_train_encoder_losses_match_reference(corpora):
    t, j = corpora
    jcfg = jenc.EncoderConfig(vocab_size=t.vocab_size, **ENC)
    tcfg = tenc.EncoderConfig(vocab_size=t.vocab_size, **ENC)
    _, want = jexp.train_encoder(j, jcfg, steps=5, batch_size=16, seed=4,
                                 log_every=0)
    params, got = texp.train_encoder(t, tcfg, steps=5, batch_size=16,
                                     seed=4, log_every=0, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert not any(p.requires_grad for p in topt.tree_leaves(params))


@pytest.fixture(scope="module")
def reference_vectors(corpora):
    """The reference encoder's embeddings (random init), its WindTunnel
    mask at Table I's default size, and a uniform mask of the judged
    entities of the same size (Table I size-matches the two)."""
    _, j = corpora
    jcfg = jenc.EncoderConfig(vocab_size=j.vocab_size, **ENC)
    params = jenc.init_encoder(jax.random.PRNGKey(1), jcfg)
    ev = jenc.embed_corpus(params, j.passage_tokens, jcfg)
    qv = jenc.embed_corpus(params, j.query_tokens, jcfg)
    wt = run_windtunnel(
        JQRelTable(*(jnp.asarray(x) for x in j.qrels)),
        num_queries=j.num_queries, num_entities=j.num_entities,
        config=WindTunnelConfig(target_size=int(0.15 * j.num_primary),
                                seed=0))
    wt_mask = np.asarray(wt.sample.entity_mask)
    uni_mask = np.zeros(j.num_entities, bool)
    uni_mask[np.random.default_rng(0).choice(
        j.num_primary, int(wt_mask.sum()), replace=False)] = True
    return ev, qv, {"full": None, "uniform": uni_mask, "windtunnel": wt_mask}


@pytest.mark.parametrize("which", ["full", "uniform", "windtunnel"])
def test_evaluate_sample_matches_reference(corpora, reference_vectors,
                                           which):
    t, j = corpora
    ev, qv, masks = reference_vectors
    want = jexp.evaluate_sample(which, j, ev, qv, masks[which], seed=1)
    got = texp.evaluate_sample(which, t, ev, qv, masks[which], seed=1,
                               device="cpu")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert 0 < want.n_queries and 0 < want.n_entities


def test_run_table1_experiment_matches_reference(corpora):
    """Both packages end to end with 3 encoder steps: equal samples (sizes,
    associated queries, rho_q) and p@3 within one hit."""
    t, j = corpora
    jcfg = jenc.EncoderConfig(vocab_size=t.vocab_size, **ENC)
    tcfg = tenc.EncoderConfig(vocab_size=t.vocab_size, **ENC)
    want = jexp.run_table1_experiment(j, encoder_cfg=jcfg, encoder_steps=3,
                                      seed=0, verbose=False)
    got = texp.run_table1_experiment(t, encoder_cfg=tcfg, encoder_steps=3,
                                     seed=0, verbose=False, device="cpu")
    assert list(got) == list(want) == ["full", "uniform", "windtunnel"]
    for name in want:
        g, w = got[name], want[name]
        assert (g.name, g.n_entities, g.n_queries) == (
            w.name, w.n_entities, w.n_queries)
        assert g.rho_q == w.rho_q
        assert abs(g.p_at_3 - w.p_at_3) <= 1.0 / (3 * w.n_queries)
