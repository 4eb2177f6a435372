"""Public wrappers of the 5G pipeline's kernels (port of the ``fft4`` and
``matmul`` wrappers of ``repro.kernels.ops``).

``fft4`` chains log4(n) :func:`~repro_torch.kernels.fft4.fft4_stage`
launches and returns the digit-reversed spectrum; ``matmul`` is the
beamforming product.  The reference's TPU-only padding of ragged matmul
shapes to (8, 128) multiples is gone: the CUDA kernel masks ragged
edges itself.  Both run where their inputs lie: the kernels for CUDA
tensors, the plain versions for CPU tensors.
"""
from __future__ import annotations

import functools
import math

import torch

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
