"""Float32 transcendental functions as XLA's CPU backend compiles them.

``jax.random.normal`` and the workload models of
:mod:`repro_torch.core.workloads` reach ``log1p``, ``erf_inv`` and
``exp`` through XLA, and the SSM family's init reaches ``log`` and
``expm1``; XLA emits its own polynomials for them (Cephes ``logf`` and
``expf``, Giles' ``erfinv``, Eigen's ``tanh`` inside ``expm1``) rather
than calling the C library, and
lets LLVM contract a multiply feeding an add into one fused
multiply-add.  The functions here write those sequences out op for op
(:func:`_fma` where the compiled code fuses), each step one correctly
rounded IEEE operation, so the results agree with the reference bit
for bit on the CPU and on the GPU alike.  ``pow`` is the exception: XLA
calls the C library's ``powf`` for it, which :func:`powf` reproduces on
the card with a kernel that computes glibc's algorithm.
"""
from __future__ import annotations

import numpy as np
import torch


def _fma(a, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to float32, as a fused multiply-add.
    The product of two float32 values is exact in float64; the float64
    sum is made round-to-odd (its rounding error, from TwoSum, nudges an
    even last bit toward the true value), which makes the final rounding
    to float32 exact."""
    p = torch.as_tensor(a).double() * torch.as_tensor(b).double()
    c = torch.as_tensor(c).double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    bits = s.view(torch.int64)
    toward = torch.where((err > 0) == (s > 0), 1, -1)
    bits = bits + torch.where((err != 0) & ((bits & 1) == 0), toward, 0)
    return bits.view(torch.float64).float()


def _f32(*values) -> tuple:
    return tuple(float(np.float32(v)) for v in values)


# Cephes ``logf`` as XLA's CPU backend emits it (``log_f32``).
_LOG_SQRTHF = _f32(0.707106781)
_LOG_P = _f32(7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
              -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
              2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = _f32(-2.12194440e-4, 0.693359375)


def _log(y: torch.Tensor) -> torch.Tensor:
    """XLA's float32 natural log: ``y = m * 2**e`` with ``m`` in
    ``[sqrt(1/2), sqrt(2))``, a degree-9 polynomial in ``m - 1`` split
    into three interleaved Horner chains, and ``e * ln 2`` in two parts."""
    yc = torch.clamp_min(y, float(np.finfo(np.float32).tiny))
    bits = yc.view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    low = m < _LOG_SQRTHF[0]
    e = torch.where(low, e - 1.0, e)
    x = (m - 1.0) + torch.where(low, m, 0.0)
    x2 = x * x
    x3 = x2 * x
    p0, p1, p2, p3, p4, p5, p6, p7, p8 = _LOG_P
    a = _fma(_fma(p0, x, p1), x, p2)
    b = _fma(_fma(p3, x, p4), x, p5)
    c = _fma(_fma(p6, x, p7), x, p8)
    poly = _fma(_fma(_fma(a, x3, b), x3, c), x3, e * _LOG_Q1)
    r = _fma(x2, -0.5, x) + poly
    r = _fma(e, _LOG_Q2, r)
    r = torch.where(y == 0, -torch.inf, r)
    r = torch.where(y == torch.inf, torch.inf, r)
    return torch.where((y < 0) | torch.isnan(y), torch.nan, r)


_LOG1P_SMALL = _f32(0.41421356237309504880)
_LOG1P_NUM = _f32(4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
                  6.5787325942061044846969e0, 2.9911919328553073277375e1,
                  6.0949667980987787057556e1, 5.7112963590585538103336e1,
                  2.0039553499201281259648e1)
_LOG1P_DEN = _f32(1.0, 1.5062909083469192043167e1,
                  8.3047565967967209469434e1, 2.2176239823732856465394e2,
                  3.0909872225312059774938e2, 2.1642788614495947685003e2,
                  6.0118660497603843919306e1)


def log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log1p``: the Cephes rational approximation for
    ``|x| < sqrt(2) - 1``, :func:`_log` of ``1 + x`` elsewhere."""
    x2 = x * x
    num = torch.full_like(x, _LOG1P_NUM[0])
    for c in _LOG1P_NUM[1:]:
        num = _fma(num, x, c)
    den = torch.full_like(x, _LOG1P_DEN[0])
    for c in _LOG1P_DEN[1:]:
        den = _fma(den, x, c)
    small = x + _fma(x2, -0.5, (x * x2) * (num / den))
    return torch.where(x.abs() < _LOG1P_SMALL[0], small, _log(x + 1.0))


# Giles' single-precision erfinv polynomials, highest degree first:
# one for w = -log(1 - x*x) < 5 (in w - 2.5), one beyond (in sqrt(w) - 3).
_ERFINV_LO = _f32(2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_HI = _f32(-0.000200214257, 0.000100950558, 0.00134934322,
                  -0.00367342844, 0.00573950773, -0.0076224613,
                  0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """``jax.lax.erf_inv`` in float32, as XLA lowers it: Giles'
    polynomial over ``w = -log1p(-x*x)``, ``+-inf`` at ``x = +-1``."""
    w = -log1p(x * -x)
    lt = w < 5.0
    # torch's CPU sqrt (SLEEF) is not always correctly rounded; the
    # float64 root rounded once to float32 is.
    t = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    p = torch.where(lt, _ERFINV_LO[0], _ERFINV_HI[0])
    for lo, hi in zip(_ERFINV_LO[1:], _ERFINV_HI[1:]):
        p = _fma(p, t, torch.where(lt, lo, hi))
    return x * torch.where(x.abs() == 1.0, torch.inf, p)


# Cephes ``expf`` as XLA's CPU backend emits it (``exp_f32``).
_EXP_LO, _EXP_HI = _f32(-87.8, 88.8)
_EXP_LOG2E = _f32(1.44269504088896341)[0]
_EXP_P = _f32(1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
              4.1665795894e-2, 1.6666665459e-1, 0.5)


def exp(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``exp``: ``x`` clamped, ``n = floor(x log2 e + 1/2)``,
    ``z = x - n ln 2`` in two parts, a degree-5 polynomial, times
    ``2**n`` built from its exponent bits."""
    x = torch.clamp(x, _EXP_LO, _EXP_HI)
    n = torch.floor(_fma(x, _EXP_LOG2E, 0.5)).clamp(-127.0, 127.0)
    z = _fma(n, -_LOG_Q2, x)
    z = _fma(n, -_LOG_Q1, z)
    p = torch.full_like(z, _EXP_P[0])
    for c in _EXP_P[1:]:
        p = _fma(p, z, c)
    y = _fma(p, z * z, z) + 1.0
    scale = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return y * scale


# Eigen's float32 ``tanh`` rational approximation as XLA's CPU backend
# emits it (``xla.tanh.f32``): odd numerator in t^2, highest degree first,
# and the even denominator; the input is clamped to +-7.998811721801758,
# below 0.0004 in magnitude tanh(t) is t, and from 20 on it is +-1.
_TANH_NUM = _f32(-2.76076847742355e-16, 2.00018790482477e-13,
                 -8.60467152213735e-11, 5.12229709037114e-08,
                 1.48572235717979e-05, 6.37261928875436e-04,
                 4.89352455891786e-03)
_TANH_DEN = _f32(1.19825839466702e-06, 1.18534705686654e-04,
                 2.26843463243900e-03, 4.89352518554385e-03)
_TANH_CLAMP, _TANH_SMALL = _f32(7.99881172180175781, 0.0004)


def _tanh(t: torch.Tensor) -> torch.Tensor:
    tc = torch.clamp(t, -_TANH_CLAMP, _TANH_CLAMP)
    t2 = tc * tc
    num = torch.full_like(t, _TANH_NUM[0])
    for c in _TANH_NUM[1:]:
        num = _fma(num, t2, c)
    den = torch.full_like(t, _TANH_DEN[0])
    for c in _TANH_DEN[1:]:
        den = _fma(den, t2, c)
    r = torch.where(t.abs() < _TANH_SMALL, t, (tc * num) / den)
    return torch.where(t.abs() >= 20.0, torch.copysign(torch.ones_like(t), t),
                       r)


def expm1(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``expm1``: ``exp(x) - 1`` where ``|x| > 1/2``, else
    ``tanh(x / 2) * (exp(x) + 1)`` with :func:`exp` and XLA's ``tanh``,
    and ``x`` itself where ``x / 2`` is zero."""
    e = exp(x)
    h = x * 0.5
    r = torch.where(x.abs() > 0.5, e - 1.0, _tanh(h) * (e + 1.0))
    return torch.where(h == 0, x, r)


def powf(x: torch.Tensor, y: float) -> torch.Tensor:
    """``x ** y`` in float32 as the C library's ``powf`` computes it, the
    call XLA's CPU backend emits for ``pow``: the hand-written kernel of
    :mod:`repro_torch.kernels.powf` for a tensor on a card, one C loop
    over the host's ``powf`` for a tensor on the CPU."""
    from ..kernels.powf import powf as _powf
    return _powf(x, y)
