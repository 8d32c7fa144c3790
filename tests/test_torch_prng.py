"""The port's threefry PRNG (repro_torch.core.prng) against JAX, bit for bit:
``PRNGKey``, ``fold_in`` with the samplers' salts, and ``uniform``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import prng

SEEDS = [0, 1, 42, 2 ** 31 - 1, -1, -7]


def _key_words(key) -> tuple:
    return tuple(int(x) for x in np.asarray(key))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    assert prng.prng_key(seed) == _key_words(jax.random.PRNGKey(seed))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("salt", [7, 13, 0, 2 ** 32 - 1])
def test_fold_in_matches_jax(seed, salt):
    want = jax.random.fold_in(jax.random.PRNGKey(seed), salt)
    assert prng.fold_in(prng.prng_key(seed), salt) == _key_words(want)


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("shape", [(0,), (1,), (7,), (1000,), (3, 5),
                                   (2 ** 20 + 3,)])
def test_uniform_bits_match_jax(seed, shape):
    key = prng.fold_in(prng.prng_key(seed), 13)
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), 13)
    got = prng.uniform(key, shape).numpy()
    want = np.asarray(jax.random.uniform(jkey, shape))
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_uniform_range_and_device_argument():
    u = prng.uniform(prng.prng_key(3), (4096,), device=torch.device("cpu"))
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0


def test_prng_key_rejects_seed_outside_int32():
    with pytest.raises(OverflowError):
        prng.prng_key(2 ** 31)
    with pytest.raises(OverflowError):
        jnp.asarray(2 ** 31, dtype=jnp.int32)
