"""XLA:CPU's f32 elementwise math in plain torch ops, bit for bit.

The reference draws and fits with ``jax.random.normal`` (``erf_inv`` and,
inside it, ``log1p``) and ``jax.scipy.special.gammaln``, ``log`` and
``exp``. XLA:CPU writes each inline, as the installed version compiles it
(read from the LLVM IR and the machine code it dumps under
``XLA_FLAGS=--xla_dump_to=<dir>``): Cephes' logf and expf, a rational fit
of log1p near 0, Giles' erf_inv, and a Lanczos lgamma. Each is reproduced
here operation by operation: the multiply-adds that LLVM fuses (a multiply
whose one use is an add) are fused here too (:func:`fma`, one rounding),
the rest are single f32 operations, and divisions and square roots run in
f64 and round once, which is exactly the f32 result. Separate torch ops,
so no device contracts them further: the same bits on the CPU and the
card.
"""
from __future__ import annotations

import torch


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once, as a fused multiply-add: the product
    is exact in f64, the f64 sum is rounded to odd (an inexact sum moves
    to its odd neighbour, toward the exact value, found by TwoSum), and
    that rounds to f32 exactly as the exact value would. Separate torch
    ops, so no device contracts them further."""
    p = a.double() * torch.as_tensor(b, dtype=torch.float32).double()
    c = torch.as_tensor(c, dtype=torch.float32, device=p.device).double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    bits = s.view(torch.int64)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    bits = torch.where((err != 0) & (bits & 1 == 0), bits + step, bits)
    return bits.view(torch.float64).to(torch.float32)


def div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 ``a / b`` correctly rounded (in f64, rounded once)."""
    return (a.double() / b.double()).to(torch.float32)


# XLA's f32 log1p: the rational fit of log1p(y) for |y| < sqrt(2) - 1 (P
# over Q, each six multiply-adds from a leading 1 and B0), and log(1 + y)
# by Cephes' logf otherwise (a mantissa m in [sqrt(1/2), sqrt(2)) as
# x = m - 1, its polynomial in x and x^3, and the exponent e times ln 2 in
# two parts), which is also XLA's f32 log. All f32 values.
_LOG1P_SMALL = 0.4142135679721832
_LOG1P_Q = (15.062909126281738, 83.04756927490234, 221.7624053955078,
            309.0987243652344, 216.42788696289062, 60.11865997314453)
_LOG1P_P = (4.527000055531971e-05, 0.4985410273075104, 6.578732490539551,
            29.91191864013672, 60.949668884277344, 57.11296463012695,
            20.039552688598633)
_LOGF_SQRTHF = 0.7071067690849304
_LOGF_A = (0.07037683576345444, -0.11514610052108765,    # x * A0 + A1
           -0.12420140951871872, 0.14249323308467865,    # x * A2 + A3
           0.2000071406364441, -0.24999994039535522,     # x * A4 + A5
           0.11676998436450958, -0.16668057441711426,    # then + A6, A7,
           0.3333333134651184)                           # A8
_LOGF_LN2 = (-0.00021219444170128554, 0.693359375)
_F32_MIN_NORMAL = 1.1754943508222875e-38


def logf(v: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's f32 ``log`` of ``v`` > 0, operation by operation (Cephes'
    logf; its cases for 0, infinity, negatives and NaN are left out)."""
    one, half = 1.0, 0.5
    bits = torch.clamp(v, min=_F32_MIN_NORMAL).view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + one
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    lt = m < _LOGF_SQRTHF
    x = (m - one) + torch.where(lt, m, 0.0)
    e = torch.where(lt, e - one, e)
    z = x * x
    x3 = z * x
    a = _LOGF_A
    q1 = fma(fma(x, a[0], a[1]), x, a[6])
    q2 = fma(fma(x, a[2], a[3]), x, a[7])
    q3 = fma(fma(x, a[4], a[5]), x, a[8])
    r = fma(fma(fma(q1, x3, q2), x3, q3), x3, e * _LOGF_LN2[0])
    return fma(e, _LOGF_LN2[1], (x - half * z) + r)


def log1p(y: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's f32 ``log1p`` of ``y`` > -1, operation by operation: the
    rational fit near 0, else :func:`logf` of 1 + y."""
    one, half = 1.0, 0.5
    big = logf(y + one)
    y2 = y * y
    q = y * 0.0 + one
    for c in _LOG1P_Q:
        q = fma(q, y, c)
    p = y * 0.0 + _LOG1P_P[0]
    for c in _LOG1P_P[1:]:
        p = fma(p, y, c)
    small = y + ((y * y2) * div(p, q) - half * y2)
    return torch.where(y.abs() < _LOG1P_SMALL, small, big)


# XLA's f32 erf_inv (Giles, "Approximating the erfinv function"): two
# degree-8 polynomials in w = -log1p(-x*x), split at w = 5; row 0 for
# w < 5, row 1 above.
_ERFINV_COEFFS = (
    (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
     0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
     1.50140941),
    (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
     0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """f32 ``erf_inv`` on (-1, 1) as XLA computes it: each Horner step a
    fused multiply-add."""
    w = -log1p(-x * x)
    lt = w < 5.0
    # the square root of the w >= 5 tail only (|x| > 0.9966), in f64 and
    # rounded once: exactly XLA's f32 sqrt. torch's f32 sqrt on a large CPU
    # tensor is not correctly rounded on every element.
    t = w - 2.5
    t[~lt] = torch.sqrt(w[~lt].double()).to(torch.float32) - 3.0
    coeffs = torch.tensor(_ERFINV_COEFFS, dtype=torch.float32,
                          device=x.device)[(~lt).long()]
    p = coeffs[..., 0]
    for i in range(1, coeffs.shape[-1]):
        p = fma(p, t, coeffs[..., i])
    return p * x


def flush_denormal(x: torch.Tensor) -> torch.Tensor:
    """x with subnormal values set to zero: XLA:CPU runs its kernels with
    subnormal results flushed."""
    return torch.where(x.abs() < _F32_MIN_NORMAL, x * 0.0, x)


# XLA's f32 exp: Cephes' expf. x clamped, n = floor(x log2(e) + 1/2) in
# [-127, 127], r = x - n ln 2 (ln 2 in two parts), a degree-5 polynomial
# in r, times 2^n built in the exponent bits.
_EXPF_CLAMP = (-87.80000305175781, 88.80000305175781)
_EXPF_LOG2E = 1.4426950216293335
_EXPF_P = (0.00019875691214110702, 0.001398199936375022,
           0.008333452045917511, 0.04166579619050026, 0.1666666567325592,
           0.5)


def expf(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's f32 ``exp``, operation by operation."""
    x = torch.clamp(x, _EXPF_CLAMP[0], _EXPF_CLAMP[1])
    n = torch.clamp(torch.floor(fma(x, _EXPF_LOG2E, 0.5)), -127.0, 127.0)
    r = fma(-n, _LOGF_LN2[1], x)
    r = fma(-n, _LOGF_LN2[0], r)
    p = fma(r, _EXPF_P[0], _EXPF_P[1])
    for c in _EXPF_P[2:]:
        p = fma(p, r, c)
    y = fma(p, r * r, r) + 1.0
    scale = ((n.to(torch.int32) << 23) + 0x3F800000).view(torch.float32)
    return y * scale


# XLA's f32 lgamma for x >= 1/2: Lanczos with g = 7 on z (x - 1, or what
# XLA's simplifier folds it to), the sum's leading coefficient rounding to
# 1 in f32, log(t) as log(7.5) + log1p(z / 7.5).
_LANCZOS = (676.520368121885098567009190444019,
            -1259.13921672240287047156078755283,
            771.3234287776530788486528258894,
            -176.61502916214059906584551354,
            12.507343278686904814458936853,
            -0.13857109526572011689554707,
            9.984369578019570859563e-6,
            1.50563273514931155834e-7)
_LANCZOS_F32 = tuple(float(torch.tensor(c, dtype=torch.float32))
                     for c in _LANCZOS)
_INV_7_5, _LOG_7_5, _LOG_SQRT_2PI = (
    float(torch.tensor(x, dtype=torch.float64).to(torch.float32))
    for x in (1 / 7.5, 2.0149030205422647, 0.9189385332046727))


def lgamma(z: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's f32 ``lgamma`` of x = z + 1 >= 1/2, given z, operation by
    operation (its reflection below 1/2 and its infinity case are left
    out)."""
    log_t = log1p(z * _INV_7_5) + _LOG_7_5
    u = fma((z + 0.5) - div(z + 7.5, log_t), log_t, _LOG_SQRT_2PI)
    s = div(torch.full_like(z, _LANCZOS_F32[0]), z + 1.0) + 1.0
    for i, c in enumerate(_LANCZOS_F32[1:], start=2):
        s = s + div(torch.full_like(z, c), z + float(i))
    return u + logf(s)
