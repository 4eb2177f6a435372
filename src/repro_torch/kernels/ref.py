"""Plain PyTorch versions of the 5G pipeline's kernels (port of the
``matmul`` and ``fft4`` oracles of ``repro.kernels.ref``).

These are the mathematical truth the CUDA kernels are held against:
the kernel wrappers run them for tensors that lie on the CPU, and
``chip_smoke.py`` compares each kernel with them on the card.  None of
them calls a library product: the plain matmul is an explicit
broadcast multiply and sum.
"""
from __future__ import annotations

import torch

from .._device import resolve_device

# Elements of one (m, k-chunk, n) broadcast product held at a time.
_MM_CHUNK_ELEMS = 1 << 24


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with float32 inputs and accumulation: chunks of the
    contraction axis are multiplied out as (m, k_chunk, n) broadcasts
    and summed, so memory stays bounded at any shape."""
    m, k = x.shape
    k2, n = w.shape
    if k != k2:
        raise ValueError(f"inner dimensions differ: {x.shape} @ {w.shape}")
    x = x.to(torch.float32)
    w = w.to(torch.float32)
    out = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    step = max(1, _MM_CHUNK_ELEMS // max(1, m * n))
    for k0 in range(0, k, step):
        k1 = min(k, k0 + step)
        out += (x[:, k0:k1, None] * w[None, k0:k1, :]).sum(dim=1)
    return out


def _fft4_stage(re: torch.Tensor, im: torch.Tensor, stage: int, n: int):
    """One radix-4 DIF butterfly stage over rows of length n, in complex
    arithmetic."""
    q = n // (4 ** (stage + 1))
    m = n // (4 ** stage)          # current sub-transform length
    x = torch.complex(re, im).reshape(re.shape[0], -1, 4, q)
    a, b, c, d = x[:, :, 0], x[:, :, 1], x[:, :, 2], x[:, :, 3]
    t0, t1 = a + c, a - c
    t2, t3 = b + d, -1j * (b - d)
    k = torch.arange(q, dtype=torch.float32, device=re.device)
    w1 = torch.exp(-2j * torch.pi * k / m)
    y0 = t0 + t2
    y1 = (t1 + t3) * w1
    y2 = (t0 - t2) * w1 ** 2
    y3 = (t1 - t3) * w1 ** 3
    y = torch.stack([y0, y1, y2, y3], dim=2).reshape(re.shape)
    return y.real.contiguous(), y.imag.contiguous()


def fft4(re: torch.Tensor, im: torch.Tensor):
    """Full radix-4 DIF FFT (digit-reversed output order); re/im
    (rows, n) float32 with n a power of 4."""
    n = re.shape[-1]
    stages = 0
    m = n
    while m > 1:
        m //= 4
        stages += 1
    for s in range(stages):
        re, im = _fft4_stage(re, im, s, n)
    return re, im


def digit_reverse_indices(n: int, *, device="cuda") -> torch.Tensor:
    """Base-4 digit reversal permutation: ``fft4(x)[..., idx]`` is the
    natural-order spectrum."""
    digits = 0
    m = n
    while m > 1:
        m //= 4
        digits += 1
    idx = torch.arange(n, dtype=torch.int64)
    out = torch.zeros(n, dtype=torch.int64)
    for _ in range(digits):
        out = out * 4 + idx % 4
        idx = idx // 4
    return out.to(resolve_device(device))
