"""The port's package surface and the small functions of its core modules,
against the JAX package on the CPU.

Each package's ``__all__`` is the reference's, less the names that wait
for a later item of ROADMAP.md queue 1 (``NOT_YET_PORTED``); every name it
lists resolves. The functions are held bit-equal to the reference's on the
same numpy inputs: labels, masks, counts and histograms are integers, and
the float sums run in the reference's order."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph_builder as jgb
from repro.core import label_prop as jlp
from repro.core import sampler as jsm
from repro.core import segment_utils as jsu
from repro.core import yule_simon as jys
from repro_torch import interop
from repro_torch.core import graph_builder as tgb
from repro_torch.core import label_prop as tlp
from repro_torch.core import prng
from repro_torch.core import sampler as tsm
from repro_torch.core import segment_utils as tsu
from repro_torch.core import yule_simon as tys

# names of the reference's __all__ that the port has not yet, each with the
# ROADMAP.md queue 1 item that ports it
NOT_YET_PORTED = {
    "retrieval": {},
    "data": {},
    "models": {},
    "train": {},
    "core": {},
    "obs": {},
    "eval": {},
    "distributed": {},
    "serve": {},
}


@pytest.mark.parametrize("pkg", sorted(NOT_YET_PORTED))
def test_package_all_is_the_references_less_the_named_rest(pkg):
    ref = importlib.import_module(f"repro.{pkg}")
    port = importlib.import_module(f"repro_torch.{pkg}")
    waiting = set(NOT_YET_PORTED[pkg])
    assert waiting <= set(ref.__all__)
    assert set(port.__all__) == set(ref.__all__) - waiting
    assert len(port.__all__) == len(set(port.__all__))
    for name in port.__all__:
        assert getattr(port, name) is not None, name
    for name in waiting:
        assert not hasattr(port, name), f"{name} is ported: export it"


def test_reexports_are_the_modules_objects():
    from repro_torch.retrieval import SearchSession, search_core
    from repro_torch.serve import (LiveIndex, MicrobatchScheduler,
                                   SearchServer, engine, ingest, scheduler)
    from repro_torch.train import AdamWConfig, optimizer
    assert SearchSession is search_core.SearchSession
    assert AdamWConfig is optimizer.AdamWConfig
    assert SearchServer is engine.SearchServer
    assert LiveIndex is ingest.LiveIndex
    assert MicrobatchScheduler is scheduler.MicrobatchScheduler


# -- label propagation ---------------------------------------------------------

def _tie_graph(seed, n=60, m=240, isolated=8):
    """Undirected edges with weights that are multiples of 0.25 or random,
    plus isolated nodes."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n - isolated, m).astype(np.int32)
    v = rng.integers(0, n - isolated, m).astype(np.int32)
    w = (rng.integers(1, 5, m) * 0.25 if seed % 2 else
         rng.random(m)).astype(np.float32)
    valid = (u != v) & (rng.random(m) < 0.9)
    return (np.minimum(u, v), np.maximum(u, v), w, valid), n


@pytest.mark.parametrize("seed", range(3))
def test_propagate_bit_equal(seed):
    edges, n = _tie_graph(seed)
    src, dst, w, valid = tgb.symmetrize(interop.edge_list(edges))
    got = tlp.propagate(src, dst, w, valid, num_nodes=n, rounds=5)
    j = jgb.symmetrize(jgb.EdgeList(*(jnp.asarray(x) for x in edges)))
    want = jlp.propagate(*j, num_nodes=n, rounds=5)
    assert np.array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert np.array_equal(got.changes_per_round.numpy(),
                          np.asarray(want.changes_per_round))


@pytest.mark.parametrize("seed,max_degree", [(0, 64), (1, 64), (2, 4)])
def test_propagate_ell_bit_equal(seed, max_degree):
    edges, n = _tie_graph(seed)
    src, dst, w, valid = tgb.symmetrize(interop.edge_list(edges))
    nbr, wgt = tlp.edges_to_ell(src, dst, w, valid, num_nodes=n,
                                max_degree=max_degree)
    got = tlp.propagate_ell(nbr, wgt, rounds=5)
    want = jlp.propagate_ell(jnp.asarray(nbr.numpy()),
                             jnp.asarray(wgt.numpy()), rounds=5)
    assert got.labels.dtype == torch.int32
    assert np.array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert np.array_equal(got.changes_per_round.numpy(),
                          np.asarray(want.changes_per_round))


def test_propagate_ell_dispatches_through_the_kernel_wrapper(monkeypatch):
    """On any device ``propagate_ell`` runs ``label_prop_round``: the CUDA
    kernel on CUDA tensors, its plain version here."""
    from repro_torch.kernels.label_prop import ops
    calls = []
    real = ops.label_prop_round

    def spy(labels, nbr, wgt):
        calls.append(labels.device.type)
        return real(labels, nbr, wgt)

    monkeypatch.setattr(ops, "label_prop_round", spy)
    nbr = torch.tensor([[1, -1], [0, -1], [-1, -1]], dtype=torch.int32)
    wgt = torch.tensor([[1.0, 0.0], [1.0, 0.0], [0.0, 0.0]])
    res = tlp.propagate_ell(nbr, wgt, rounds=3)
    assert calls == ["cpu"] * 3
    assert res.labels.tolist() == [1, 0, 2]


# -- sampler -------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 5, -3])
@pytest.mark.parametrize("n,rate", [(1, 0.5), (1000, 0.1), (4099, 0.3),
                                    (20000, 0.015)])
def test_uniform_sample_bit_equal(seed, n, rate):
    got = tsm.uniform_sample(n, prng.prng_key(seed), rate=rate,
                             device="cpu")
    want = jsm.uniform_sample(n, jax.random.PRNGKey(seed), rate=rate)
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_entry_points_default_to_the_card(monkeypatch):
    """``uniform_sample`` and ``init_transformer`` run on the card unless
    asked for the CPU: with no card they raise, never fall back."""
    from repro_torch.models import TransformerConfig, init_transformer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TransformerConfig(vocab_size=8, d_model=8, n_layers=1, n_heads=2,
                            n_kv_heads=2, d_ff=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsm.uniform_sample(10, prng.prng_key(0), rate=0.5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_transformer(prng.prng_key(0), cfg)
    params = init_transformer(prng.prng_key(0), cfg, device="cpu")
    assert params["embed"].device.type == "cpu"


@pytest.mark.parametrize("n", [1, 17, 500])
def test_community_sizes_bit_equal(n):
    labels = np.random.default_rng(n).integers(0, max(n // 3, 1), n) \
        .astype(np.int32)
    got = tsm.community_sizes(torch.from_numpy(labels), n)
    want = jsm.community_sizes(jnp.asarray(labels), n)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


# -- segment utils -------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("axis", [None, 0, 1])
def test_masked_min_bit_equal(dtype, axis):
    rng = np.random.default_rng(3)
    values = (rng.standard_normal((7, 9)) * 100).astype(dtype)
    mask = rng.random((7, 9)) < 0.4
    mask[2] = False                 # a row with nothing kept
    mask[:, 4] = False              # and a column
    got = tsu.masked_min(torch.from_numpy(values), torch.from_numpy(mask),
                         axis=axis)
    want = jsu.masked_min(jnp.asarray(values), jnp.asarray(mask), axis=axis)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert got.numpy().dtype == np.asarray(want).dtype


@pytest.mark.parametrize("seed", range(3))
def test_reduce_by_key_sum_bit_equal(seed):
    rng = np.random.default_rng(seed)
    n = 400
    k1 = rng.integers(0, 6, n).astype(np.int32)
    k2 = rng.integers(0, 9, n).astype(np.int32)
    vals = rng.standard_normal(n).astype(np.float32)
    valid = rng.random(n) < 0.8
    got = tsu.reduce_by_key_sum((torch.from_numpy(k1), torch.from_numpy(k2)),
                                torch.from_numpy(vals),
                                torch.from_numpy(valid))
    want = jsu.reduce_by_key_sum((jnp.asarray(k1), jnp.asarray(k2)),
                                 jnp.asarray(vals), jnp.asarray(valid))
    (gk, gs, gsum, gseg, gval), (wk, ws, wsum, wseg, wval) = got, want
    for a, b in zip(gk, wk):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert np.array_equal(gs.numpy(), np.asarray(ws))
    assert np.array_equal(gsum.numpy(), np.asarray(wsum))
    assert np.array_equal(gseg.numpy(), np.asarray(wseg))
    assert np.array_equal(gval.numpy(), np.asarray(wval))


# -- Yule-Simon ----------------------------------------------------------------

@pytest.mark.parametrize("max_degree", [1, 8, 64])
def test_degree_histogram_bit_equal(max_degree):
    deg = np.random.default_rng(max_degree).integers(0, 90, 3000) \
        .astype(np.int32)
    got = tys.degree_histogram(torch.from_numpy(deg), max_degree)
    want = jys.degree_histogram(jnp.asarray(deg), max_degree)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("rho", [1e-3, 0.5, 1.94, 3.3, 7.77, 25.0])
def test_theoretical_pmf_bit_equal(rho):
    """XLA's lgamma, log and exp reproduced op by op (core/xla_f32.py),
    subnormal results flushed as XLA:CPU flushes them."""
    ks = np.arange(1, 20001, dtype=np.int32)
    got = tys.theoretical_pmf(torch.from_numpy(ks), rho)
    want = jys.theoretical_pmf(jnp.asarray(ks), jnp.float32(rho))
    assert np.array_equal(got.numpy().view(np.int32),
                          np.asarray(want).view(np.int32))


def test_xla_f32_math_bit_equal():
    """log, exp and lgamma as XLA:CPU computes them, each on its own."""
    from jax.scipy.special import gammaln
    from repro_torch.core import xla_f32
    rng = np.random.default_rng(0)
    x = np.concatenate([
        np.float32(2.0) ** np.arange(-60, 60, dtype=np.float32),
        rng.uniform(1e-3, 3e3, 100_000).astype(np.float32)])
    t = torch.from_numpy(x)
    for got, want in ((xla_f32.logf(t), jnp.log(x)),
                      (xla_f32.expf(-t / 40), jnp.exp(-x / 40)),
                      (xla_f32.lgamma(t + 0.5 - 1.0), gammaln(x + 0.5))):
        assert np.array_equal(got.numpy().view(np.int32),
                              np.asarray(want).view(np.int32))
