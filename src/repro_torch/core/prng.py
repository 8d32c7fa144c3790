"""Counter-based threefry2x32 in torch integer ops, bit-equal to JAX.

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
  shape, split into ``(hi, lo)`` words, and xors the two output words; so
  any run of flat positions can be hashed on its own (``start``), and a
  large draw made in bounded pieces equals the whole draw;
* ``uniform`` keeps the top 23 bits as the mantissa of a float in [1, 2)
  and subtracts 1;
* ``split(key, num)`` hashes the counter pairs ``(0, i)``, i < num;
* ``randint`` combines two 32-bit draws modulo the span (``_randint``);
* ``permutation(key, n)`` is ``jax.random._shuffle``: ``ceil(3 ln n /
  ln(2**32 - 1))`` rounds, each splitting the key and stably sorting the
  values by 32 fresh random bits; ``choice(..., replace=False)`` is its
  prefix;
* ``normal`` is ``sqrt(2) * erf_inv(u)`` for ``u`` uniform on
  ``[nextafter(-1, 0), 1)``, with XLA's f32 ``erf_inv`` (Giles'
  polynomial) and, inside it, XLA's f32 ``log1p``, both operation by
  operation as the installed XLA:CPU compiles them (``core/xla_f32.py``),
  so ``normal`` is the reference's bit for bit, on either device.

Words are held in int64 tensors masked to 32 bits, so the same code runs
on any device, and on Python ints for the scalar key operations.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.core import xla_f32

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


def random_bits(key: Key, shape, device="cpu", start: int = 0
                ) -> torch.Tensor:
    """32 random bits per element (int64 holding [0, 2**32)): those of the
    flat positions ``start .. start + numel`` of a draw of any shape that
    holds them (``start`` 0: the draw of ``shape`` itself)."""
    shape = tuple(int(s) for s in shape)
    numel = 1
    for s in shape:
        numel *= s
    iota = torch.arange(start, start + numel, dtype=torch.int64,
                        device=device)
    b1, b2 = threefry2x32(key[0], key[1], iota >> 32, iota & _M32)
    return (b1 ^ b2).reshape(shape)


def uniform(key: Key, shape, device="cpu", start: int = 0) -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: float32 in [0, 1) (``start`` as
    in :func:`random_bits`)."""
    bits = random_bits(key, shape, device, start)
    one = 0x3F800000
    fbits = ((bits >> 9) | one).to(torch.int32)
    return fbits.view(torch.float32) - 1.0


def split(key: Key, num: int = 2) -> Tuple[Key, ...]:
    """``jax.random.split(key, num)``: key i hashes the counter pair
    ``(0, i)``."""
    return tuple(threefry2x32(key[0], key[1], 0, i) for i in range(num))


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


def randint(key: Key, shape, minval: int, maxval: int, device="cpu"
            ) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32): two
    draws of 32 random bits from ``split(key)``, the high one times
    ``2**32 mod span`` plus the low one, in uint32 arithmetic (wrapping),
    modulo ``span = maxval - minval`` (1 where ``maxval <= minval``)."""
    lo32, hi32 = -2 ** 31, 2 ** 31 - 1
    minval = min(max(int(minval), lo32), hi32)
    maxval_c = min(max(int(maxval), lo32), hi32)
    span = (maxval_c - minval) & _M32 if maxval_c > minval else 1
    if int(maxval) > hi32 and maxval_c > minval:
        span = (span + 1) & _M32
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape, device), random_bits(k2, shape,
                                                                 device)
    if span == 0:                       # the whole uint32 range
        offset = lower
    else:
        m = 2 ** 16 % span
        mult = ((m * m) & _M32) % span    # uint32: 2**32 wraps to 0
        offset = (((higher % span) * mult) & _M32) + lower % span
        offset = (offset & _M32) % span
    out = (offset + minval) & _M32               # int32 wrap, as uint32
    return torch.where(out < 2 ** 31, out, out - 2 ** 32).to(torch.int32)


def normal(key: Key, shape, device="cpu", start: int = 0) -> torch.Tensor:
    """``jax.random.normal(key, shape)``: float32 standard normals
    (``start`` as in :func:`random_bits`: a draw too large to hold its
    intermediates at once is made piece by piece, bit-equal)."""
    lo = torch.tensor(-1.0).nextafter(torch.tensor(0.0)).item()
    u = uniform(key, shape, device, start) * 2.0 + lo
    u = torch.clamp(u, min=lo)
    return torch.tensor(math.sqrt(2), device=device) * xla_f32.erf_inv(u)


# jax.random's uniform draws bits of a width from its dtype: the width of
# the random bits (8 where the mantissa is narrower than 8 bits) and the
# mantissa bits of a float in [1, 2) they fill. float16 is left out: XLA
# keeps its intermediates in another precision, so its bits are not
# reproduced.
_FLOAT_BITS = {torch.float32: (32, 23), torch.bfloat16: (8, 7)}
_INT_OF = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def gumbel(key: Key, shape, dtype=torch.float32, device="cpu"
           ) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, dtype)`` in its default mode
    ("low"): ``-log(-log(u))`` for ``u`` uniform on ``[tiny, 1)`` in
    ``dtype``, each operation rounded to ``dtype``, each log XLA:CPU's f32
    ``log`` (``jax.random.categorical`` is the argmax of logits plus
    these). ``dtype`` float32 or bfloat16."""
    if dtype not in _FLOAT_BITS:
        raise ValueError(f"gumbel draws float32 or bfloat16, not {dtype}")
    rng_bits, nmant = _FLOAT_BITS[dtype]
    bits = random_bits(key, shape, device) & ((1 << rng_bits) - 1)
    one = torch.tensor(1.0, dtype=dtype).view(_INT_OF[dtype]).item()
    fbits = ((bits >> (rng_bits - nmant)) | one).to(_INT_OF[dtype])
    floats = fbits.view(dtype) - torch.tensor(1.0, dtype=dtype)
    tiny = torch.tensor(torch.finfo(dtype).tiny, dtype=dtype, device=device)
    u = torch.maximum(floats * (1.0 - tiny) + tiny, tiny)
    inner = (-xla_f32.logf(u.float())).to(dtype)
    return (-xla_f32.logf(inner.float())).to(dtype)
