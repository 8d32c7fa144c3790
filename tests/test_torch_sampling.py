"""The port's sampling side against the JAX package on the CPU: the entity
masks of all four strategies, the session's sweep counters, the Yule-Simon
fit, reconstruction, and both packages' ``launch/sample.py`` outputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import QRelTable as JQRels
from repro.core import SamplerSession as JSession
from repro.core import SamplerSpec as JSpec
from repro.core import reconstructor as jrc
from repro.core import samplers as jsamplers
from repro.core.yule_simon import fit_em as jfit
from repro.launch import sample as jsample
from repro_torch import interop
from repro_torch.core import SamplerSession, SamplerSpec, available_samplers
from repro_torch.core import reconstructor as trc
from repro_torch.core import samplers as tsamplers
from repro_torch.core.yule_simon import fit_em
from repro_torch.data.synthetic import generate_corpus
from repro_torch.launch import sample as tsample

PORT_TO_REF_ENGINE = {"sort": "sort", "ell": "ell", "cuda": "pallas"}


@pytest.fixture(scope="module")
def corpus():
    return generate_corpus(num_queries=200, qrels_per_query=8, num_topics=10,
                           aux_fraction=0.5, seed=4)


@pytest.fixture(scope="module")
def sessions(corpus):
    """One session per package on the same corpus (sort engine)."""
    spec = dict(target_size=0.15 * corpus.num_primary, seed=0)
    t = SamplerSession(corpus.qrels, num_queries=corpus.num_queries,
                       num_entities=corpus.num_entities,
                       spec=SamplerSpec(engine="sort", **spec), device="cpu")
    j = JSession(JQRels(*(jnp.asarray(x) for x in corpus.qrels)),
                 num_queries=corpus.num_queries,
                 num_entities=corpus.num_entities,
                 spec=JSpec(engine="sort", **spec))
    return t, j


def test_registry_matches_reference():
    assert available_samplers() == ("degree_stratified", "full", "uniform",
                                    "windtunnel")


@pytest.mark.parametrize("strategy", ["windtunnel", "uniform", "full",
                                      "degree_stratified"])
@pytest.mark.parametrize("target", [None, 0.05, 0.3, 1.0, 40.0])
@pytest.mark.parametrize("seed", [0, 3])
def test_masks_bit_equal(sessions, strategy, target, seed):
    t, j = sessions        # target None: the spec's default target
    td = t.draw(target_size=target, seed=seed, strategy=strategy)
    jd = j.draw(target_size=target, seed=seed, strategy=strategy)
    assert np.array_equal(interop.to_numpy(td.entity_mask),
                          np.asarray(jd.entity_mask))
    assert np.array_equal(interop.to_numpy(td.reconstructed.query_mask),
                          np.asarray(jd.reconstructed.query_mask))
    assert np.array_equal(interop.to_numpy(td.reconstructed.qrels.valid),
                          np.asarray(jd.reconstructed.qrels.valid))
    if strategy == "windtunnel":
        for name in ("entity_mask", "label_kept", "community_sizes"):
            assert np.array_equal(interop.to_numpy(getattr(td.sample, name)),
                                  np.asarray(getattr(jd.sample, name)))
        # keep_prob carries the calibrated scale c, bisected on an f32 sum
        # taken in XLA's order (core/sampler.xla_sum): bit-equal
        assert np.array_equal(interop.to_numpy(td.sample.keep_prob),
                              np.asarray(jd.sample.keep_prob))


def test_baselines_without_a_target_raise(corpus):
    t = SamplerSession(corpus.qrels, num_queries=corpus.num_queries,
                       num_entities=corpus.num_entities, device="cpu")
    for strategy in ("uniform", "degree_stratified"):
        with pytest.raises(ValueError, match="needs a target_size"):
            t.draw(strategy=strategy)


def test_default_draw_is_the_calibrated_windtunnel_draw(sessions):
    t, j = sessions
    assert np.array_equal(interop.to_numpy(t.draw().entity_mask),
                          np.asarray(j.draw().entity_mask))


@pytest.mark.parametrize("opts", [{"universe": "all", "salt": 0},
                                  {"num_strata": 3}])
def test_strategy_opts_bit_equal(corpus, opts):
    strategy = "uniform" if "universe" in opts else "degree_stratified"
    kw = dict(strategy=strategy, target_size=0.2, seed=1, strategy_opts=opts)
    t = SamplerSession(corpus.qrels, num_queries=corpus.num_queries,
                       num_entities=corpus.num_entities,
                       spec=SamplerSpec(engine="sort", **kw), device="cpu")
    j = JSession(JQRels(*(jnp.asarray(x) for x in corpus.qrels)),
                 num_queries=corpus.num_queries,
                 num_entities=corpus.num_entities,
                 spec=JSpec(engine="sort", **kw))
    assert np.array_equal(interop.to_numpy(t.draw().entity_mask),
                          np.asarray(j.draw().entity_mask))


def test_sweep_counters_equal(corpus):
    kw = dict(target_size=0.1, seed=0)
    t = SamplerSession(corpus.qrels, num_queries=corpus.num_queries,
                       num_entities=corpus.num_entities,
                       spec=SamplerSpec(engine="ell", **kw), device="cpu")
    j = JSession(JQRels(*(jnp.asarray(x) for x in corpus.qrels)),
                 num_queries=corpus.num_queries,
                 num_entities=corpus.num_entities,
                 spec=JSpec(engine="ell", **kw))
    ts = t.sweep([0.05, 0.1, 60.0], [0, 1])
    js = j.sweep([0.05, 0.1, 60.0], [0, 1])
    assert ts.stage_counts == js.stage_counts
    assert ts.to_json() == js.to_json()
    t.draw(strategy="uniform", target_size=0.1)
    j.draw(strategy="uniform", target_size=0.1)
    assert t.stage_counts() == j.stage_counts()
    assert t.summary() == j.summary()


def test_degree_strata_match_jnp_log2():
    deg = np.arange(0, 5000, dtype=np.int32)
    t = torch.floor(torch.log2(torch.clamp(torch.from_numpy(deg), min=1)
                               .float())).int()
    j = jnp.floor(jnp.log2(jnp.maximum(jnp.asarray(deg), 1)
                           .astype(jnp.float32))).astype(jnp.int32)
    assert np.array_equal(t.numpy(), np.asarray(j))


def test_judged_entities_and_reconstruction(corpus):
    tq = interop.qrel_table(corpus.qrels)
    jq = JQRels(*(jnp.asarray(x) for x in corpus.qrels))
    rng = np.random.default_rng(0)
    mask = rng.random(corpus.num_entities) < 0.3
    assert np.array_equal(
        interop.to_numpy(tsamplers.judged_entities(tq, corpus.num_entities)),
        np.asarray(jsamplers.judged_entities(jq, corpus.num_entities)))
    tr = trc.reconstruct(tq, torch.from_numpy(mask),
                         num_queries=corpus.num_queries)
    jr = jrc.reconstruct(jq, jnp.asarray(mask), num_queries=corpus.num_queries)
    assert np.array_equal(interop.to_numpy(tr.query_mask),
                          np.asarray(jr.query_mask))
    assert int(tr.num_queries) == int(jr.num_queries)
    assert int(tr.num_entities) == int(jr.num_entities)
    ta, tids = trc.associated_queries(tq, mask, num_queries=corpus.num_queries,
                                      max_queries=20, seed=3)
    ja, jids = jrc.associated_queries(jq, mask, num_queries=corpus.num_queries,
                                      max_queries=20, seed=3)
    assert np.array_equal(ta, ja) and np.array_equal(tids, jids)
    rho_t = trc.query_density(tq, torch.from_numpy(mask), tr.query_mask,
                              num_queries=corpus.num_queries,
                              num_entities=corpus.num_entities)
    rho_j = jrc.query_density(jq, jnp.asarray(mask), jr.query_mask,
                              num_queries=corpus.num_queries,
                              num_entities=corpus.num_entities)
    np.testing.assert_allclose(float(rho_t), float(rho_j), rtol=1e-6)


def test_yule_simon_fit_close(sessions):
    t, _ = sessions
    deg = interop.to_numpy(t.graph()[1])
    deg = deg[deg > 0]
    tf = fit_em(torch.from_numpy(deg), max_iters=300)
    jf = jfit(jnp.asarray(deg), max_iters=300)
    # digamma/polygamma differ between the two libraries in the last bits
    np.testing.assert_allclose(float(tf.rho), float(jf.rho), rtol=1e-5)
    np.testing.assert_allclose(float(tf.stderr), float(jf.stderr), rtol=1e-4)
    np.testing.assert_allclose(float(tf.log_lik), float(jf.log_lik),
                               rtol=1e-5)


@pytest.mark.parametrize("engine", ["sort", "ell", "cuda"])
def test_sample_clis_write_equal_npz(tmp_path, engine):
    """Both packages' launch/sample.py on the same corpus and seed. The
    port's ``cuda`` engine is the kernel engine and needs the card, so on
    the CPU its row runs the port's ``ell`` engine (the kernel's plain
    version) against the reference's ``pallas``."""
    args = ["--queries", "160", "--qrels-per-query", "8", "--topics", "10",
            "--quiet"]
    port_engine = "ell" if engine == "cuda" else engine
    jsample.main(args + ["--engine", PORT_TO_REF_ENGINE[engine],
                         "--out", str(tmp_path / "jax")])
    tsample.main(args + ["--engine", port_engine, "--device", "cpu",
                         "--out", str(tmp_path / "torch")])
    a = np.load(tmp_path / "jax" / "sample.npz")
    b = np.load(tmp_path / "torch" / "sample.npz")
    for key in ("entity_mask", "labels", "qrel_valid"):
        assert np.array_equal(a[key], b[key]), key


def test_sample_cli_sweep_matches_reference(tmp_path):
    args = ["--queries", "160", "--qrels-per-query", "8", "--topics", "10",
            "--sweep-sizes", "0.05,0.2", "--sweep-seeds", "0,2", "--quiet",
            "--engine", "sort"]
    jsample.main(args + ["--out", str(tmp_path / "jax")])
    tsample.main(args + ["--device", "cpu", "--out", str(tmp_path / "torch")])
    a = np.load(tmp_path / "jax" / "sample.npz")
    b = np.load(tmp_path / "torch" / "sample.npz")
    for key in ("entity_mask", "labels", "qrel_valid"):
        assert np.array_equal(a[key], b[key]), key
    import json
    sa = json.load(open(tmp_path / "jax" / "stats.json"))
    sb = json.load(open(tmp_path / "torch" / "stats.json"))
    assert sa["sweep"] == sb["sweep"]
