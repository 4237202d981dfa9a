"""float32 log-gamma, bit-equal to the JAX package's `gammaln` on the CPU.

`jax.scipy.special.gammaln` lowers to XLA's Lanczos expansion (the `Lgamma`
of XLA's math library, g = 7, eight coefficients, Euler's reflection below
0.5). XLA's CPU backend then emits its own elementwise functions for it:

  * `log`: the Cephes polynomial with the mantissa split at sqrt(1/2),
    multiply-adds fused;
  * `log1p`: a Cephes rational function below sqrt(2) - 1, else
    log(1 + x), its Horner steps fused;
  * `sin`: a call to the C library's `sinf` (glibc: a double-precision
    polynomial after a reduction by pi/2);

and it fuses a multiply into the add that consumes it. `lgamma_f32` runs the
same operations in the same order on any torch device: a fused
multiply-add is one float64 multiply-add rounded once to float32 (the
product of two float32 values is exact in float64), and `sinf` runs in
float64 as the C library's does. `torch.lgamma` differs from it in the last
bit on most inputs, which moves a PL by 1 now and then.

Where the argument is a compile-time constant, XLA folds the expression
instead, op by op in float32 with the C library's logf, log1pf and sinf and
no fused multiply-add: `lgamma_folded` computes those values on the host.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math

import numpy as np
import torch

_F32 = torch.float32
_F64 = torch.float64


def _c(v: float) -> float:
    """A constant as float32 rounds it."""
    return float(np.float32(v))


def _fma(a, b, c):
    """a * b + c rounded once to float32."""
    return (a.to(_F64) * b.to(_F64) + c.to(_F64)).to(_F32)


def _fma_s(a, b: float, c: float):
    """_fma with float32 constants b and c."""
    return (a.to(_F64) * b + c).to(_F32)


_LOG_P = [_c(v) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1)]
_LOG_Q1 = _c(-2.12194440e-4)
_LOG_Q2 = _c(0.693359375)
_SQRTHF = _c(0.707106781186547524)


def _log(x: torch.Tensor) -> torch.Tensor:
    """XLA CPU's float32 log (Cephes; denormals as the least normal)."""
    v = x.clamp_min(1.1754943508222875e-38)  # 2**-126, the least normal
    bits = v.view(torch.int32)
    e = ((bits >> 23) - 0x7F).to(_F32) + 1.0
    m = ((bits & 0x807FFFFF) | 0x3F000000).view(_F32)
    small = m < _SQRTHF
    tmp = torch.where(small, m, torch.zeros_like(m))
    m = m - 1.0
    e = e - small.to(_F32)
    m = m + tmp
    x2 = m * m
    x3 = x2 * m
    p = _LOG_P
    y = _fma_s(m, p[0], p[1])
    y1 = _fma_s(m, p[3], p[4])
    y2 = _fma_s(m, p[6], p[7])
    y = _fma(y, m, torch.full_like(m, p[2]))
    y1 = _fma(y1, m, torch.full_like(m, p[5]))
    y2 = _fma(y2, m, torch.full_like(m, p[8]))
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, e * _LOG_Q1)
    m = _fma(torch.full_like(m, -0.5), x2, m)
    m = m + y
    m = _fma(torch.full_like(m, _LOG_Q2), e, m)
    inf = torch.full_like(m, math.inf)
    m = torch.where(x == math.inf, inf, m)
    m = torch.where(x == 0, -inf, m)
    return torch.where((x < 0) | torch.isnan(x), torch.full_like(m, math.nan), m)


_LOG1P_DEN = [_c(v) for v in (
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
    2.2176239823732856465394e2, 3.0909872225312059774938e2,
    2.1642788614495947685003e2, 6.0118660497603843919306e1)]
_LOG1P_NUM = [_c(v) for v in (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
    6.5787325942061044846969e0, 2.9911919328553073277375e1,
    6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1)]


def _horner(x, coeffs):
    p = torch.zeros_like(x)
    for c in coeffs:
        p = _fma(p, x, torch.full_like(x, c))
    return p


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA CPU's float32 log1p."""
    large = _log(x + 1.0)
    x2 = x * x
    small = _horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)
    small = (x * x2) * small
    small = _fma(torch.full_like(x, -0.5), x2, small)
    small = x + small
    return torch.where(x.abs() < _c(0.41421356237309504880), small, large)


_HPI_INV = float.fromhex("0x1.45F306DC9C883p+23")  # 2/pi * 2^24
_HPI = float.fromhex("0x1.921FB54442D18p0")  # pi/2
_SIN_S = (-float.fromhex("0x1.555545995a603p-3"),
          float.fromhex("0x1.1107605230bc4p-7"),
          -float.fromhex("0x1.994eb3774cf24p-13"))
_COS_C = (1.0, -float.fromhex("0x1.ffffffd0c621cp-2"),
          float.fromhex("0x1.55553e1068f19p-5"),
          -float.fromhex("0x1.6c087e89a359dp-10"),
          float.fromhex("0x1.99343027bf8c3p-16"))


def _sinf(y: torch.Tensor) -> torch.Tensor:
    """glibc's sinf for 0 <= y < 120 (the reflection's y lies in [0, pi/2]):
    a reduction by pi/2 in float64, then the sine or the cosine polynomial
    of the quadrant, each step rounded in float64."""
    x = y.to(_F64)
    n = ((x * _HPI_INV).to(torch.int32) + 0x800000) >> 24
    direct = y < 0.75  # glibc compares the top 12 bits with those of pi/4
    n = torch.where(direct, torch.zeros_like(n), n)
    r = torch.where(direct, x, x - n.to(_F64) * _HPI)
    sign = torch.where((n & 3) >= 2, -1.0, 1.0).to(_F64)
    r2 = r * r
    s1, s2, s3 = _SIN_S
    xs = r * sign
    x2s = xs * xs
    x3 = xs * x2s
    sin_v = (xs + x3 * s1) + (x3 * x2s) * (s2 + x2s * s3)
    csign = torch.where((n & 2) != 0, -1.0, 1.0).to(_F64)
    c0, c1, c2, c3, c4 = _COS_C
    x4 = r2 * r2
    cos_v = ((csign * c0 + r2 * (csign * c1)) + x4 * (csign * c2)) + \
        (x4 * r2) * (csign * c3 + r2 * (csign * c4))
    return torch.where((n & 1) == 0, sin_v, cos_v).to(_F32)


_LANCZOS = [_c(v) for v in (
    676.520368121885098567009190444019, -1259.13921672240287047156078755283,
    771.3234287776530788486528258894, -176.61502916214059906584551354,
    12.507343278686904814458936853, -0.13857109526572011689554707,
    9.984369578019570859563e-6, 1.50563273514931155834e-7)]
_BASE_COEFF = _c(0.99999999999980993227684700473478)
_INV_G_HALF = _c(1.0 / 7.5)
_LOG_G_HALF = _c(math.log(7.5))
_LOG_SQRT_2PI = _c((math.log(2.0) + math.log(math.pi)) / 2.0)
_LOG_PI = _c(math.log(math.pi))
_PI = _c(math.pi)


def lgamma_f32(x: torch.Tensor) -> torch.Tensor:
    """log|Gamma(x)| of a float32 tensor, in XLA's CPU order of operations
    (see the module docstring)."""
    x = x.to(_F32)
    abs_x = x.abs()
    reflect = x < 0.5
    frac = abs_x - torch.floor(abs_x)
    reduced = torch.where(frac > 0.5, 1.0 - frac, frac)
    denom = _log(_sinf(reduced * _PI))

    z = torch.where(reflect, -x, x + (-1.0))
    t = z + 7.5
    log_t = _log1p(z * _INV_G_HALF) + _LOG_G_HALF
    head = _fma(((z + 0.5) - t / log_t), log_t,
                torch.full_like(z, _LOG_SQRT_2PI))
    acc = torch.full_like(z, _LANCZOS[0]).div(z + 1.0) + _BASE_COEFF
    for i, coeff in enumerate(_LANCZOS[1:], start=2):
        acc = acc + torch.full_like(z, coeff).div(z + float(i))
    log_y = head + _log(acc)

    reflection = torch.where(torch.isfinite(denom),
                             (_LOG_PI - denom) - log_y, -denom)
    out = torch.where(reflect, reflection, log_y)
    return torch.where(abs_x == math.inf, torch.full_like(out, math.inf), out)


@functools.cache
def _libm():
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    for name in ("logf", "log1pf", "sinf"):
        fn = getattr(libm, name)
        fn.restype = ctypes.c_float
        fn.argtypes = [ctypes.c_float]
    return libm


def lgamma_folded(v: float) -> np.float32:
    """log|Gamma(v)| as XLA's constant folder computes it where the argument
    is a compile-time constant: the same Lanczos expression, evaluated op by
    op in float32 with the C library's logf, log1pf and sinf and no fused
    multiply-add."""
    f = np.float32
    libm = _libm()
    x = f(v)
    reflect = x < f(0.5)
    z = -x if reflect else x + f(-1.0)
    t = z + f(7.5)
    log_t = f(libm.log1pf(float(z * f(_INV_G_HALF)))) + f(_LOG_G_HALF)
    head = ((z + f(0.5)) - t / log_t) * log_t + f(_LOG_SQRT_2PI)
    acc = f(_LANCZOS[0]) / (z + f(1.0)) + f(_BASE_COEFF)
    for i, coeff in enumerate(_LANCZOS[1:], start=2):
        acc = acc + f(coeff) / (z + f(i))
    log_y = head + f(libm.logf(float(acc)))
    if not reflect:
        return log_y
    abs_x = abs(x)
    frac = abs_x - f(math.floor(abs_x))
    reduced = f(1.0) - frac if frac > f(0.5) else frac
    denom = f(libm.logf(float(libm.sinf(float(reduced * f(_PI))))))
    return (f(_LOG_PI) - denom) - log_y if math.isfinite(denom) else -denom
