"""Plain PyTorch versions of the port's kernels (port of the ``matmul``,
``fft4``, ``dotp``, ``axpy``, ``conv2d``, ``dct`` and ``flash_attention``
oracles of ``repro.kernels.ref``).

These are the mathematical truth the CUDA kernels are held against:
the kernel wrappers run them for tensors that lie on the CPU, and
``chip_smoke.py`` compares each kernel with them on the card.  None of
them calls a library product: the plain matmul is an explicit
broadcast multiply and sum, the plain dot product a multiply and sum,
the plain convolution nine shifted multiplies and adds, the plain DCT
the plain matmul against the basis.  The exception is attention, whose
(S, S) score products would not fit as broadcasts at the serving
path's shape: it uses ``torch.einsum`` in float32, as the reference
uses ``jnp.einsum``.
"""
from __future__ import annotations

import numpy as np
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


# Elements per leaf of the dot-product reduction tree: the reference's
# (256, 128) tile.
DOTP_LEAF = 256 * 128


def dotp(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``sum(x * y)`` in float32 (inputs widened to float32 first)."""
    return (x.reshape(-1).to(torch.float32)
            * y.reshape(-1).to(torch.float32)).sum()


def dotp_partials(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The leaves of the reduction tree: one float32 partial sum per
    :data:`DOTP_LEAF` consecutive elements, the last leaf ragged."""
    prod = x.reshape(-1).to(torch.float32) * y.reshape(-1).to(torch.float32)
    pad = (-prod.numel()) % DOTP_LEAF
    return torch.cat([prod, prod.new_zeros(pad)]).reshape(
        -1, DOTP_LEAF).sum(dim=1)


def dotp_central(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The central-counter dot product: every leaf's partial sum added
    into one accumulator."""
    return dotp_partials(x, y).sum()


def combine_partials(parts: torch.Tensor, radix: int) -> torch.Tensor:
    """One k-ary tree level: groups of ``radix`` partials summed into
    one, the last group zero-padded."""
    pad = (-parts.numel()) % radix
    return torch.cat([parts, parts.new_zeros(pad)]).reshape(
        -1, radix).sum(dim=1)


def axpy(a, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``a * x + y`` computed in float32 and returned in ``x.dtype``."""
    out = float(a) * x.to(torch.float32) + y.to(torch.float32)
    return out.to(x.dtype)


def conv2d(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """3x3 "same" convolution with zero padding over (B, H, W) images,
    float32 out: nine shifted multiply-adds, di outer and dj inner, each
    a float32 multiply and then an add."""
    h, w = img.shape[1:]
    pad = torch.nn.functional.pad(img.to(torch.float32), (1, 1, 1, 1))
    k = kernel.to(device=img.device, dtype=torch.float32)
    out = torch.zeros(img.shape, dtype=torch.float32, device=img.device)
    for di in range(3):
        for dj in range(3):
            out = out + k[di, dj] * pad[:, di:di + h, dj:dj + w]
    return out


def dct_basis(n: int, *, device="cuda") -> torch.Tensor:
    """Orthonormal DCT-II basis (n x n) in float32, built in the
    reference's operation order: the float32 angle ``pi * (2i + 1) * k /
    (2n)`` (it reaches about 1.3e4 rad at n = 4096, so its rounding is
    part of the basis), its cosine, then the row scale ``sqrt(1/n)`` or
    ``sqrt(2/n)``."""
    dev = resolve_device(device)
    k = torch.arange(n, dtype=torch.float32, device=dev)[:, None]
    i = torch.arange(n, dtype=torch.float32, device=dev)[None, :]
    # The divisor is a tensor on the device: CUDA torch divides by a Python
    # number as a multiply by its float32 reciprocal, which at n not a
    # power of two rounds some angles one ulp off the reference's quotient.
    two_n = torch.full((), 2 * n, dtype=torch.float32, device=dev)
    angle = float(np.float32(np.pi)) * (2 * i + 1) * k / two_n
    # The float64 cosine of each float32 angle, rounded once.
    basis = torch.cos(angle.double()).float()
    scale = torch.where(k == 0, float(np.sqrt(np.float32(1.0 / n))),
                        float(np.sqrt(np.float32(2.0 / n))))
    return basis * scale


def dct(x: torch.Tensor) -> torch.Tensor:
    """Row-wise DCT-II of (T, n) rows, float32 out."""
    return matmul(x.to(torch.float32),
                  dct_basis(x.shape[-1], device=x.device).T)


NEG_INF = -1e30


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    window: int = 0) -> torch.Tensor:
    """O(S^2) reference attention, float32 out.  q (B, H, S, D); k (B, Hk,
    T, D) and v (B, Hk, T, Dv) with ``H`` a multiple of ``Hk`` (query head
    ``h`` reads KV head ``h // (H // Hk)``); out (B, H, S, Dv).  Scores
    are float32 products scaled by ``scale`` (default ``D ** -0.5``);
    causal masking keeps key ``t <= s``, a sliding ``window > 0`` keeps
    ``s - t < window`` (the models' mask), and masked scores are the
    finite ``-1e30``; the softmax is rounded to v's dtype before the PV
    product, as the reference does."""
    b, h, s, _ = q.shape
    hk, dv = k.shape[1], v.shape[3]
    sc = _scores(q, k, causal, scale, window)
    p = torch.softmax(sc, dim=-1).to(v.dtype).to(torch.float32)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.to(torch.float32))
    return out.reshape(b, h, s, dv)


def _scores(q, k, causal, scale, window) -> torch.Tensor:
    """The (B, Hk, H / Hk, S, T) float32 scores ``q.k * scale``, masked
    keys the finite ``NEG_INF``."""
    b, h, s, d = q.shape
    hk, t = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    qg = q.to(torch.float32).reshape(b, hk, h // hk, s, d)
    sc = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.to(torch.float32))
    sc = sc * scale
    if causal or window > 0:
        lag = (torch.arange(s, device=q.device)[:, None]
               - torch.arange(t, device=q.device)[None, :])
        keep = torch.ones_like(lag, dtype=torch.bool)
        if causal:
            keep &= lag >= 0
        if window > 0:
            keep &= lag < window
        sc = torch.where(keep, sc, NEG_INF)
    return sc


def attention_lse(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
                  scale: float | None = None,
                  window: int = 0) -> torch.Tensor:
    """Each query row's log-sum-exp of its scaled, masked float32 scores
    (masked scores the finite ``-1e30``, as :func:`flash_attention`'s):
    (B, H, S) float32, what the forward kernel writes beside its output
    for the backward."""
    b, h, s, _ = q.shape
    return torch.logsumexp(_scores(q, k, causal, scale, window),
                           dim=-1).reshape(b, h, s)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        scale: float | None = None) -> tuple:
    """The gradients ``(dq, dk, dv)`` of :func:`flash_attention` against
    the output gradient ``dout``, float32: autograd through it on float32
    copies of the operands (the softmax then needs no rounding before the
    PV product)."""
    ops = [t.detach().to(torch.float32).requires_grad_(True)
           for t in (q, k, v)]
    with torch.enable_grad():
        out = flash_attention(*ops, causal=causal, scale=scale)
        return torch.autograd.grad(out, ops, dout.to(torch.float32))
