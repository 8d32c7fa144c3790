"""Counter-based threefry2x32 in torch integer ops, bit-equal to JAX.

The reference draws its samples with ``jax.random.PRNGKey``, ``fold_in``
and ``uniform`` (``core/sampling_core.py``, ``core/sampler.py``,
``core/samplers.py``). Reproducing those bits exactly is what lets the
port's sample masks equal the reference's, not merely match in
distribution. This module follows JAX's threefry implementation with
``jax_threefry_partitionable=True`` (``jax/_src/prng.py``) and the
mantissa trick of ``jax/_src/random.py::_uniform``:

* a key is a pair of uint32 words, here two Python ints;
* ``PRNGKey(seed)`` with 32-bit ints is ``(0, seed mod 2**32)``;
* ``fold_in(key, data)`` hashes the counter pair ``(0, data)``;
* ``random_bits(key, shape)`` hashes the 64-bit iota over the flattened
  shape, split into ``(hi, lo)`` words, and xors the two output words;
* ``uniform`` keeps the top 23 bits as the mantissa of a float in [1, 2)
  and subtracts 1.

Words are held in int64 tensors masked to 32 bits, so the same code runs
on any device, and on Python ints for the scalar key operations.
"""
from __future__ import annotations

from typing import Tuple

import torch

Key = Tuple[int, int]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1: int, k2: int, x1, x2):
    """Threefry-2x32 with 20 rounds on a pair of 32-bit words (ints or
    int64 tensors holding values in [0, 2**32))."""
    ks = (k1 & _M32, k2 & _M32, (k1 ^ k2 ^ 0x1BD11BDA) & _M32)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M32
    return x1, x2


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for a seed that fits in int32."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise OverflowError(f"seed {seed} does not fit in int32")
    return (0, seed & _M32)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``."""
    return threefry2x32(key[0], key[1], 0, int(data) & _M32)


def random_bits(key: Key, shape, device="cpu") -> torch.Tensor:
    """32 random bits per element (int64 holding [0, 2**32))."""
    shape = tuple(int(s) for s in shape)
    numel = 1
    for s in shape:
        numel *= s
    iota = torch.arange(numel, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(key[0], key[1], iota >> 32, iota & _M32)
    return (b1 ^ b2).reshape(shape)


def uniform(key: Key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: float32 in [0, 1)."""
    bits = random_bits(key, shape, device)
    one = 0x3F800000
    fbits = ((bits >> 9) | one).to(torch.int32)
    return fbits.view(torch.float32) - 1.0
