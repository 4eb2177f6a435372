"""Public wrappers of the port's kernels (port of the ``fft4``,
``matmul``, ``dotp``, ``axpy``, ``conv2d``, ``dct`` and
``flash_attention`` wrappers of ``repro.kernels.ops``).

``fft4`` runs every stage of a row in one
:func:`~repro_torch.kernels.fft4.fft4_fused` launch (rows longer than
its shared memory first take
:func:`~repro_torch.kernels.fft4.fft4_stage` launches) and returns the
digit-reversed spectrum; ``matmul`` is the
beamforming product; ``dotp`` is the dot product as a central
accumulator or a k-ary reduction tree; ``axpy`` is ``a * x + y``;
``conv2d`` the 3x3 "same" convolution; ``dct`` the row-wise DCT-II;
``flash_attention`` attention over (B, H, S, D) heads.  The
reference's TPU-only layout steps are gone (the 128-lane padding of 1-D
operands, the (8, 128) padding of ragged matmul shapes, the padded copy
of the conv2d images): the CUDA kernels mask ragged edges and halos
themselves.  All run where their inputs lie:
the kernels for CUDA tensors, the plain versions for CPU tensors.
"""
from __future__ import annotations

import functools
import math

import torch

from . import axpy as _axpy
from . import conv2d as _conv2d
from . import dct as _dct
from . import dotp as _dotp
from . import fft4 as _fft4
from . import flash_attn as _fa
from . import matmul as _mm
from . import ref


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


@functools.lru_cache(maxsize=None)
def fused_twiddles(L: int, device: torch.device) -> tuple:
    """The fused kernel's twiddle table for rows of length ``L``: every
    stage's :func:`_stage_twiddles` planes back to back, ``L - 1``
    float32 values each for re and im, built once per (L, device)."""
    planes = [_stage_twiddles(L, s, device) for s in range(_fft4.log4(L))]
    return (torch.cat([wr.reshape(-1) for wr, _ in planes]),
            torch.cat([wi.reshape(-1) for _, wi in planes]))


def fft4(re: torch.Tensor, im: torch.Tensor) -> tuple:
    """Radix-4 DIF FFT over rows; returns the digit-reversed spectrum
    (re, im) as float32.  Rows of up to
    :data:`~repro_torch.kernels.fft4.L_MAX` points run every stage in one
    fused launch; a longer row first runs stage launches until its
    sub-transforms fit (:func:`~repro_torch.kernels.fft4.fft4_plan`).
    Each stage is one partially synchronized step of the paper's Fig. 3,
    a block-wide barrier inside the fused kernel."""
    rows, n = re.shape
    lead, L = _fft4.fft4_plan(n, _fft4.L_MAX)
    re = re.to(torch.float32)
    im = im.to(torch.float32)
    if n == 1:                  # no stage: the spectrum is the sample
        return re, im
    for s in range(lead):
        wr, wi = _stage_twiddles(n, s, re.device)
        re, im = _fft4.fft4_stage(re, im, wr, wi)
    wr, wi = fused_twiddles(L, re.device)
    re, im = _fft4.fft4_fused(re.reshape(-1, L), im.reshape(-1, L), wr, wi)
    return re.reshape(rows, n), im.reshape(rows, n)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with float32 output, for float32 or bfloat16 inputs."""
    return _mm.matmul(x, w)


def dotp(x: torch.Tensor, y: torch.Tensor, *, radix: int = 0
         ) -> torch.Tensor:
    """``sum(x * y)`` as a float32 scalar, with the paper's barrier-radix
    knob: ``radix <= 1`` is the central accumulator (one launch);
    ``radix = k > 1`` a k-ary tree — one leaf launch, then every level
    in one :func:`~repro_torch.kernels.dotp.combine_tree` launch, its
    levels separated by a block-wide barrier (above
    :data:`~repro_torch.kernels.dotp.TREE_MAX` leaves, one
    :func:`~repro_torch.kernels.dotp.combine_partials` launch per level
    first, until the count fits)."""
    if radix <= 1:
        return _dotp.dotp_central(x, y)
    return _dotp.combine_tree(_dotp.dotp_partials(x, y), radix)


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


def conv2d(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """3x3 zero-padded "same" convolution: (B, H, W) -> float32
    (B, H, W)."""
    return _conv2d.conv2d(img, kernel)


@functools.lru_cache(maxsize=None)
def dct_basis_t(n: int, device: torch.device) -> torch.Tensor:
    """The transposed orthonormal DCT-II basis (n, n), built once per
    (n, device)."""
    return ref.dct_basis(n, device=device).T.contiguous()


def dct(x: torch.Tensor) -> torch.Tensor:
    """Row-wise DCT-II: (T, n) -> float32 (T, n)."""
    return _dct.dct(x, dct_basis_t(x.shape[-1], x.device))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q, k, v: (B, H, S, D) -> (B, H, S, D) in q's dtype."""
    return _fa.flash_attention(q, k, v, causal=causal)
