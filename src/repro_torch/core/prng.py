"""Counter-based threefry2x32 in torch integer ops, bit-equal to JAX
(``normal`` to a few ulps).

The reference draws its samples with ``jax.random.PRNGKey``, ``fold_in``
and ``uniform`` (``core/sampling_core.py``, ``core/sampler.py``,
``core/samplers.py``), its k-means seeds with ``jax.random.choice(...,
replace=False)`` (``retrieval/ivfflat.py``) and its LSH projection with
``jax.random.normal`` (``retrieval/lsh.py``). Reproducing those bits
exactly is what lets the port's sample masks and k-means seeds equal the
reference's, not merely match in distribution. This module follows JAX's
threefry implementation with ``jax_threefry_partitionable=True`` (``jax/_src/prng.py``) and the
mantissa trick of ``jax/_src/random.py::_uniform``:

* a key is a pair of uint32 words, here two Python ints;
* ``PRNGKey(seed)`` with 32-bit ints is ``(0, seed mod 2**32)``;
* ``fold_in(key, data)`` hashes the counter pair ``(0, data)``;
* ``random_bits(key, shape)`` hashes the 64-bit iota over the flattened
  shape, split into ``(hi, lo)`` words, and xors the two output words;
* ``uniform`` keeps the top 23 bits as the mantissa of a float in [1, 2)
  and subtracts 1;
* ``split(key)`` hashes the counter pairs ``(0, 0)`` and ``(0, 1)``;
* ``permutation(key, n)`` is ``jax.random._shuffle``: ``ceil(3 ln n /
  ln(2**32 - 1))`` rounds, each splitting the key and stably sorting the
  values by 32 fresh random bits; ``choice(..., replace=False)`` is its
  prefix;
* ``normal`` is ``sqrt(2) * _erf_inv(u)`` for ``u`` uniform on
  ``[nextafter(-1, 0), 1)``, with XLA's f32 ``erf_inv`` (Giles'
  polynomial). Each Horner step here runs in f64 and rounds once to f32,
  as a fused multiply-add does, which matches XLA's values more often
  than f32 steps; ``log1p`` is torch's, whose last bit differs from XLA's
  on some inputs. So the values agree to a few ulps (the tests state the
  bound), not bit for bit.

Words are held in int64 tensors masked to 32 bits, so the same code runs
on any device, and on Python ints for the scalar key operations.
"""
from __future__ import annotations

import math
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


def split(key: Key) -> Tuple[Key, Key]:
    """``jax.random.split(key)`` (two keys)."""
    return (threefry2x32(key[0], key[1], 0, 0),
            threefry2x32(key[0], key[1], 0, 1))


def permutation(key: Key, n: int, device="cpu") -> torch.Tensor:
    """``jax.random.permutation(key, n)``: a permutation of ``arange(n)``
    as int64."""
    x = torch.arange(n, dtype=torch.int64, device=device)
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(_M32))
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(random_bits(sub, (n,), device), stable=True)[1]
        x = x[order]
    return x


def choice(key: Key, n: int, size: int, device="cpu") -> torch.Tensor:
    """``jax.random.choice(key, n, (size,), replace=False)`` as int64."""
    if not 0 <= size <= n:
        raise ValueError(f"cannot draw {size} of {n} without replacement")
    return permutation(key, n, device)[:size]


# XLA's f32 erf_inv (Giles, "Approximating the erfinv function"): two
# degree-8 polynomials in w = -log1p(-x*x), split at w = 5; row 0 for
# w < 5, row 1 above.
_ERFINV_COEFFS = (
    (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
     0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
     1.50140941),
    (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
     0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))


def _erf_inv(x: torch.Tensor) -> torch.Tensor:
    """f32 ``erf_inv`` on (-1, 1) as XLA computes it, each Horner step one
    rounding to f32 of an exact f64 product and sum, as a fused
    multiply-add."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    # the square root of the w >= 5 tail only (|x| > 0.9966), in f64 and
    # rounded once: exactly XLA's f32 sqrt. torch's f32 sqrt on a large CPU
    # tensor is not correctly rounded on every element.
    t = w - 2.5
    t[~lt] = torch.sqrt(w[~lt].double()).to(torch.float32) - 3.0
    w = t.double()
    coeffs = torch.tensor(_ERFINV_COEFFS, dtype=torch.float32,
                          device=x.device).double()[(~lt).long()]
    p = coeffs[..., 0]
    for i in range(1, coeffs.shape[-1]):
        p = (coeffs[..., i] + p * w).to(torch.float32).double()
    return p.to(torch.float32) * x


def normal(key: Key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.normal(key, shape)``: float32 standard normals."""
    lo = torch.tensor(-1.0).nextafter(torch.tensor(0.0)).item()
    u = uniform(key, shape, device) * 2.0 + lo
    u = torch.clamp(u, min=lo)
    return torch.tensor(math.sqrt(2), device=device) * _erf_inv(u)
