"""SO(3) machinery for E(3)-equivariant message passing (port of
``repro/models/so3.py``): the reference's numpy code, kept here so the port
imports nothing of the JAX package.

Real spherical harmonics (l <= 2 closed-form, Condon-Shortley-consistent)
and real-basis Clebsch-Gordan coefficients computed at import time from
Racah's formula + the complex->real unitary.

Conventions: m-index order is m = -l..l; the l=1 components are (y, z, x).
Real CG tensors are either purely real or purely imaginary; the nonzero part
is taken (a global phase per (l1,l2,l3) path is absorbed by the learnable
path weights and does not affect equivariance, whose D-matrices are real in
this basis).
"""

from __future__ import annotations

import functools
import math

import numpy as np

L_MAX = 2


# ---------------------------------------------------------------------------
# Complex CG via Racah's formula
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _fact(n: int) -> float:
    return float(math.factorial(n))


def clebsch_gordan_complex(l1, m1, l2, m2, l3, m3) -> float:
    if m3 != m1 + m2:
        return 0.0
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        return 0.0
    if abs(m1) > l1 or abs(m2) > l2 or abs(m3) > l3:
        return 0.0
    pref = math.sqrt(
        (2 * l3 + 1) * _fact(l3 + l1 - l2) * _fact(l3 - l1 + l2)
        * _fact(l1 + l2 - l3) / _fact(l1 + l2 + l3 + 1))
    pref *= math.sqrt(_fact(l3 + m3) * _fact(l3 - m3) * _fact(l1 - m1)
                      * _fact(l1 + m1) * _fact(l2 - m2) * _fact(l2 + m2))
    s = 0.0
    for k in range(0, l1 + l2 - l3 + 1):
        denom_terms = [k, l1 + l2 - l3 - k, l1 - m1 - k, l2 + m2 - k,
                       l3 - l2 + m1 + k, l3 - l1 - m2 + k]
        if any(t < 0 for t in denom_terms):
            continue
        denom = 1.0
        for t in denom_terms:
            denom *= _fact(t)
        s += (-1.0) ** k / denom
    return pref * s


def _real_unitary(l: int) -> np.ndarray:
    """U[m_real, m_complex]: real SH = U @ complex SH (C-S phase)."""
    dim = 2 * l + 1
    u = np.zeros((dim, dim), np.complex128)
    for m in range(-l, l + 1):
        i = m + l
        if m == 0:
            u[i, l] = 1.0
        elif m > 0:
            u[i, -m + l] = 1.0 / math.sqrt(2)
            u[i, m + l] = (-1.0) ** m / math.sqrt(2)
        else:  # m < 0
            am = -m
            u[i, m + l] = 1j / math.sqrt(2)
            u[i, am + l] = -1j * (-1.0) ** am / math.sqrt(2)
    return u


@functools.lru_cache(maxsize=None)
def real_clebsch_gordan(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real-basis CG tensor C[(2l1+1), (2l2+1), (2l3+1)]."""
    c = np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1), np.complex128)
    for m1 in range(-l1, l1 + 1):
        for m2 in range(-l2, l2 + 1):
            m3 = m1 + m2
            if abs(m3) <= l3:
                c[m1 + l1, m2 + l2, m3 + l3] = clebsch_gordan_complex(
                    l1, m1, l2, m2, l3, m3)
    u1, u2, u3 = _real_unitary(l1), _real_unitary(l2), _real_unitary(l3)
    cr = np.einsum("am,bn,co,mno->abc", u1, u2, np.conj(u3), c)
    re, im = np.real(cr), np.imag(cr)
    out = re if np.abs(re).max() >= np.abs(im).max() else im
    assert min(np.abs(re).max(), np.abs(im).max()) < 1e-10, (l1, l2, l3)
    return np.ascontiguousarray(out.astype(np.float32))


def valid_paths(l_max: int = L_MAX):
    """All (l1, l2, l3) coupling paths with every l <= l_max."""
    paths = []
    for l1 in range(l_max + 1):
        for l2 in range(l_max + 1):
            for l3 in range(abs(l1 - l2), min(l1 + l2, l_max) + 1):
                paths.append((l1, l2, l3))
    return paths


# ---------------------------------------------------------------------------
# Real spherical harmonics l <= 2 (orthonormal, unit vectors)
# ---------------------------------------------------------------------------

_C1 = math.sqrt(3.0 / (4.0 * math.pi))
_C2a = 0.5 * math.sqrt(15.0 / math.pi)    # xy, yz, xz
_C2b = 0.25 * math.sqrt(5.0 / math.pi)    # 3z^2 - 1
_C2c = 0.25 * math.sqrt(15.0 / math.pi)   # x^2 - y^2
_C0 = 0.5 / math.sqrt(math.pi)


def spherical_harmonics(vec, xp):
    """vec: (..., 3) unit vectors -> dict {l: (..., 2l+1)} for l = 0..2.

    ``xp`` is ``numpy`` (host arrays) or ``torch`` (tensors on any
    device), so the same code serves both the model and host-side tests.
    """
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    y0 = xp.ones_like(x)[..., None] * _C0
    y1 = xp.stack([_C1 * y, _C1 * z, _C1 * x], -1)
    y2 = xp.stack([
        _C2a * x * y,
        _C2a * y * z,
        _C2b * (3.0 * z * z - 1.0),
        _C2a * x * z,
        _C2c * (x * x - y * y),
    ], -1)
    return {0: y0, 1: y1, 2: y2}
