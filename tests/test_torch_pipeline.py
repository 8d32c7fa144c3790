"""The port's legacy one-shot pipeline (``core/pipeline.py``) against the
JAX package on the CPU: ``run_windtunnel`` and ``run_uniform_baseline``
bit-equal to the reference's on the same numpy QRels (edges, degrees,
labels, changes, the cluster sample, masks and the reconstruction), the
wrappers bit-equal to the session they wrap, as
``tests/test_sampling_core.py`` holds the reference's, and the Table I
experiment driven by the reference's ``wt_config``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import QRelTable as JQRels
from repro.core import WindTunnelConfig as JConfig
from repro.core import reconstruct as jreconstruct
from repro.core import run_uniform_baseline as jrun_uniform
from repro.core import run_windtunnel as jrun_windtunnel
from repro.core import sampler as jsm
from repro_torch import interop
from repro_torch.core import (SamplerSession, SamplerSpec, WindTunnelConfig,
                              prng, reconstruct, run_uniform_baseline,
                              run_windtunnel)
from repro_torch.core import sampler as tsm
from repro_torch.data.synthetic import generate_corpus


@pytest.fixture(scope="module")
def corpus():
    return generate_corpus(num_queries=96, qrels_per_query=8, num_topics=10,
                           aux_fraction=0.3, seed=0, vocab_size=256)


@pytest.fixture(scope="module")
def jqrels(corpus):
    return JQRels(*(jnp.asarray(x) for x in corpus.qrels))


def _eq(got, want):
    return np.array_equal(interop.to_numpy(got), np.asarray(want))


def _assert_recon_equal(got, want):
    for g, w in zip(got.qrels, want.qrels):
        assert _eq(g, w)
    assert _eq(got.entity_mask, want.entity_mask)
    assert _eq(got.query_mask, want.query_mask)


# fanout, lp_rounds, max_degree (None: every entity), target, seed, engine
CONFIGS = [
    (8, 4, None, 0.3, 0, "sort"),
    (8, 4, None, 0.2, 2, "ell"),
    (16, 5, 32, None, 1, "sort"),
    (16, 5, 4, 0.4, 3, "ell"),
]


@pytest.mark.parametrize("fanout,rounds,max_degree,target,seed,engine",
                         CONFIGS)
def test_run_windtunnel_bit_equal_to_the_reference(
        corpus, jqrels, fanout, rounds, max_degree, target, seed, engine):
    kw = dict(fanout=fanout, lp_rounds=rounds,
              max_degree=max_degree or corpus.num_entities,
              target_size=(None if target is None
                           else target * corpus.num_primary), seed=seed)
    got = run_windtunnel(corpus.qrels, num_queries=corpus.num_queries,
                         num_entities=corpus.num_entities,
                         config=WindTunnelConfig(engine=engine, **kw),
                         device="cpu")
    want = jrun_windtunnel(jqrels, num_queries=corpus.num_queries,
                           num_entities=corpus.num_entities,
                           config=JConfig(engine=engine, **kw))
    for g, w in zip(got.edges, want.edges):
        assert _eq(g, w)
    assert _eq(got.degrees, want.degrees)
    assert _eq(got.labels, want.labels)
    assert _eq(got.changes_per_round, want.changes_per_round)
    for g, w in zip(got.sample, want.sample):
        assert _eq(g, w)
    _assert_recon_equal(got.reconstructed, want.reconstructed)


@pytest.mark.parametrize("rate,seed", [(0.2, 3), (0.45, 7), (0.05, 0)])
def test_run_uniform_baseline_bit_equal_to_the_reference(corpus, jqrels,
                                                         rate, seed):
    got = run_uniform_baseline(corpus.qrels, num_queries=corpus.num_queries,
                               num_entities=corpus.num_entities, rate=rate,
                               seed=seed, device="cpu")
    want = jrun_uniform(jqrels, num_queries=corpus.num_queries,
                        num_entities=corpus.num_entities, rate=rate,
                        seed=seed)
    _assert_recon_equal(got, want)
    # and the legacy whole-corpus Bernoulli draw of both packages
    legacy = tsm.uniform_sample(corpus.num_entities, prng.prng_key(seed),
                                rate=rate, device="cpu")
    assert _eq(got.entity_mask, legacy)
    assert _eq(legacy, jsm.uniform_sample(
        corpus.num_entities, jax.random.PRNGKey(seed), rate=rate))
    ref = reconstruct(interop.qrel_table(corpus.qrels), legacy,
                      num_queries=corpus.num_queries)
    assert _eq(got.query_mask, ref.query_mask)
    assert _eq(ref.query_mask, jreconstruct(
        jqrels, jnp.asarray(legacy.numpy()),
        num_queries=corpus.num_queries).query_mask)
    assert "deprecated" in run_uniform_baseline.__doc__


def test_run_windtunnel_wrapper_matches_a_session_sweep(corpus):
    """Each (size, seed) cell of a session's sweep equals a fresh one-shot
    run_windtunnel at the same config bit for bit."""
    spec = SamplerSpec(fanout=8, lp_rounds=4, max_degree=corpus.num_entities,
                       engine="ell")
    session = SamplerSession(corpus.qrels, num_queries=corpus.num_queries,
                             num_entities=corpus.num_entities, spec=spec,
                             device="cpu")
    sizes = [0.2 * corpus.num_primary, 0.4 * corpus.num_primary]
    sweep = session.sweep(sizes, [0, 1])
    for size in sizes:
        for seed in (0, 1):
            cfg = dataclasses.replace(spec, target_size=size,
                                      seed=seed).to_config()
            res = run_windtunnel(corpus.qrels,
                                 num_queries=corpus.num_queries,
                                 num_entities=corpus.num_entities,
                                 config=cfg, device="cpu")
            draw = sweep.draws[(float(size), seed)]
            assert _eq(draw.entity_mask, res.sample.entity_mask.numpy())
            assert _eq(draw.reconstructed.query_mask,
                       res.reconstructed.query_mask.numpy())
    assert session.stage_counts()["labels"][0] == 1
    assert "deprecated" in run_windtunnel.__doc__


def test_spec_and_config_round_trip():
    cfg = WindTunnelConfig(tau_quantile=0.25, fanout=4, lp_rounds=3,
                           max_degree=7, target_size=0.5, engine="ell",
                           seed=9)
    spec = SamplerSpec.from_config(cfg, strategy="uniform")
    assert spec.strategy == "uniform" and spec.engine == "ell"
    assert spec.to_config() == cfg
    assert SamplerSpec.from_config(WindTunnelConfig()) == SamplerSpec()
    assert {f.name for f in dataclasses.fields(WindTunnelConfig)} == \
        {f.name for f in dataclasses.fields(JConfig)}


def test_table1_experiment_takes_the_references_wt_config():
    """``wt_config`` and the same settings as a ``sampler`` spec give the
    same rows, whose WindTunnel sample is ``run_windtunnel``'s for that
    config; both at once is an error."""
    from repro_torch.retrieval.encoder import EncoderConfig
    from repro_torch.retrieval.experiment import run_table1_experiment
    c = generate_corpus(num_queries=48, qrels_per_query=6, num_topics=4,
                        vocab_size=32, passage_len=8, query_len=4, seed=0)
    enc = EncoderConfig(vocab_size=32, d_model=16, n_layers=1, n_heads=1,
                        d_ff=16)
    cfg = WindTunnelConfig(target_size=0.3 * c.num_primary, seed=1)
    run = lambda **kw: run_table1_experiment(
        c, encoder_cfg=enc, encoder_steps=2, seed=1, verbose=False,
        device="cpu", **kw)
    by_config = run(wt_config=cfg)
    by_spec = run(sampler=SamplerSpec.from_config(cfg))
    assert by_config == by_spec
    assert list(by_config) == ["full", "uniform", "windtunnel"]
    wt = run_windtunnel(c.qrels, num_queries=c.num_queries,
                        num_entities=c.num_entities, config=cfg,
                        device="cpu")
    assert by_config["windtunnel"].n_entities == \
        int(wt.sample.entity_mask.sum())
    with pytest.raises(ValueError, match="not both"):
        run(wt_config=cfg, sampler=SamplerSpec())
