"""Public wrappers of the port's kernels (port of the ``fft4``,
``matmul``, ``dotp`` and ``axpy`` wrappers of ``repro.kernels.ops``).

``fft4`` chains log4(n) :func:`~repro_torch.kernels.fft4.fft4_stage`
launches and returns the digit-reversed spectrum; ``matmul`` is the
beamforming product; ``dotp`` is the dot product as a central
accumulator or a k-ary reduction tree; ``axpy`` is ``a * x + y``.  The
reference's TPU-only layout steps are gone (the 128-lane padding of 1-D
operands, the (8, 128) padding of ragged matmul shapes): the CUDA
kernels mask ragged edges themselves.  All run where their inputs lie:
the kernels for CUDA tensors, the plain versions for CPU tensors.
"""
from __future__ import annotations

import functools
import math

import torch

from . import axpy as _axpy
from . import dotp as _dotp
from . import fft4 as _fft4
from . import matmul as _mm


@functools.lru_cache(maxsize=None)
def _stage_twiddles(n: int, stage: int, device: torch.device) -> tuple:
    """(3, q) float32 planes of W^k, W^2k, W^3k for one stage, built as
    the reference builds them: float32 angles, complex64 exponentials."""
    m = n // (4 ** stage)
    q = m // 4
    k = torch.arange(q, dtype=torch.float32)
    ang = -2.0 * math.pi * k / m
    ws = [torch.exp(1j * ang * j) for j in (1, 2, 3)]
    wr = torch.stack([w.real for w in ws]).to(torch.float32)
    wi = torch.stack([w.imag for w in ws]).to(torch.float32)
    return wr.to(device), wi.to(device)


def fft4(re: torch.Tensor, im: torch.Tensor) -> tuple:
    """Radix-4 DIF FFT over rows; returns the digit-reversed spectrum
    (re, im) as float32.  One stage launch per radix-4 digit, as the
    paper schedules one partially synchronized stage at a time
    (Fig. 3)."""
    n = re.shape[-1]
    stages = int(round(math.log(n, 4)))
    if 4 ** stages != n:
        raise ValueError(f"fft4 needs a power-of-4 length, got {n}")
    re = re.to(torch.float32)
    im = im.to(torch.float32)
    for s in range(stages):
        wr, wi = _stage_twiddles(n, s, re.device)
        re, im = _fft4.fft4_stage(re, im, wr, wi)
    return re, im


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with float32 output, for float32 or bfloat16 inputs."""
    return _mm.matmul(x, w)


def dotp(x: torch.Tensor, y: torch.Tensor, *, radix: int = 0
         ) -> torch.Tensor:
    """``sum(x * y)`` as a float32 scalar, with the paper's barrier-radix
    knob: ``radix <= 1`` is the central accumulator (one launch);
    ``radix = k > 1`` a k-ary tree — one leaf launch, then one
    :func:`~repro_torch.kernels.dotp.combine_partials` launch per level
    until one partial is left."""
    if radix <= 1:
        return _dotp.dotp_central(x, y)
    parts = _dotp.dotp_partials(x, y)
    while parts.numel() > 1:
        parts = _dotp.combine_partials(parts, radix)
    return parts[0]


def dotp_levels(n: int, radix: int) -> int:
    """Tree levels :func:`dotp` runs over ``n`` elements at ``radix``
    (0 for the central accumulator)."""
    if radix <= 1:
        return 0
    parts, levels = _dotp.leaf_count(n), 0
    while parts > 1:
        parts, levels = -(-parts // radix), levels + 1
    return levels


def axpy(a, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``a * x + y`` in the operands' dtype."""
    return _axpy.axpy(a, x, y)
