"""Radix-4 DIF FFT (the paper's 5G OFDM kernel): one butterfly stage,
and every stage of a row in one launch.

:func:`fft4_stage` replaces ``src/repro/kernels/fft4.py::fft4_stage``
(Pallas kernel ``_stage_kernel``).  Its CUDA kernel
(``csrc/fft4_stage.cu``) runs one thread per butterfly, out of place,
float32 only; it is memory-bound: every stage reads and writes each
complex point once (32 bytes a point) for about 8.5 flops.
:func:`fft4_stage_plain` is the same stage in plain PyTorch on re/im
planes, the path for CPU tensors and the kernel's oracle on the card.

:func:`fft4_fused` replaces the chain of those stages that
``src/repro/kernels/ops.py::fft4`` launches: one block holds whole rows
of length ``L <= L_MAX`` in shared memory and runs all their stages
there, so the planes are read and written once.  Its plain version,
:func:`fft4_fused_plain`, is the plain stage chain.  :func:`fft4_plan`
splits a longer row: leading stages as stage launches until each
sub-transform fits, then the fused kernel over the sub-transforms.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

# Kernel launches made by fft4_stage and by fft4_fused; the plain paths
# never count.
LAUNCHES = 0
FUSED_LAUNCHES = 0

# The longest row the fused kernel takes: the largest power of 4 whose
# float32 re/im planes (8 L bytes, 128 KB) fit one block's shared memory.
L_MAX = 4 ** 7

_SIGNATURES = {"fft4_stage_f32": [ctypes.c_void_p] * 6
               + [ctypes.c_int] * 3 + [ctypes.c_void_p],
               "fft4_fused_f32": [ctypes.c_void_p] * 6
               + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]}


def log4(n: int) -> int:
    """``s`` with ``4 ** s == n``; raises for other lengths."""
    s = max(0, n.bit_length() - 1) // 2
    if n < 1 or 4 ** s != n:
        raise ValueError(f"fft4 needs a power-of-4 length, got {n}")
    return s


def fft4_plan(n: int, l_max: int = L_MAX) -> tuple:
    """How a row of ``n`` points runs: ``(lead, L)``.  Stages
    ``0 .. lead - 1`` are :func:`fft4_stage` launches over the whole
    rows; after them each contiguous block of ``L = n / 4 ** lead``
    points is an independent transform, which one :func:`fft4_fused`
    launch finishes as ``(rows * n / L, L)``.  ``L`` is the largest
    power of 4 that is at most ``min(n, l_max)``."""
    stages, fit = log4(n), log4(l_max)
    if fit < 1:
        raise ValueError(f"l_max must be a power of 4 >= 4, got {l_max}")
    lead = max(0, stages - fit)
    return lead, n // 4 ** lead


def fft4_stage_plain(re: torch.Tensor, im: torch.Tensor, wr: torch.Tensor,
                     wi: torch.Tensor) -> tuple:
    """One DIF stage in plain PyTorch, op for op the reference kernel:
    re/im (rows, n), wr/wi (3, q) twiddles for W^k, W^2k, W^3k."""
    rows, n = re.shape
    q = wr.shape[1]
    re4 = re.reshape(rows, -1, 4, q)
    im4 = im.reshape(rows, -1, 4, q)
    ar, ai = re4[:, :, 0], im4[:, :, 0]
    br, bi = re4[:, :, 1], im4[:, :, 1]
    cr, ci = re4[:, :, 2], im4[:, :, 2]
    dr, di = re4[:, :, 3], im4[:, :, 3]
    t0r, t0i = ar + cr, ai + ci
    t1r, t1i = ar - cr, ai - ci
    t2r, t2i = br + dr, bi + di
    t3r, t3i = bi - di, -(br - dr)    # -j*(b-d)

    def cmul(xr, xi, yr, yi):
        return xr * yr - xi * yi, xr * yi + xi * yr

    y0r, y0i = t0r + t2r, t0i + t2i
    y1r, y1i = cmul(t1r + t3r, t1i + t3i, wr[0], wi[0])
    y2r, y2i = cmul(t0r - t2r, t0i - t2i, wr[1], wi[1])
    y3r, y3i = cmul(t1r - t3r, t1i - t3i, wr[2], wi[2])
    return (torch.stack([y0r, y1r, y2r, y3r], dim=2).reshape(rows, n),
            torch.stack([y0i, y1i, y2i, y3i], dim=2).reshape(rows, n))


def _check_args(re, im, wr, wi) -> None:
    if re.dim() != 2 or re.shape != im.shape:
        raise ValueError(f"re/im must be matching (rows, n), got "
                         f"{tuple(re.shape)} and {tuple(im.shape)}")
    n = re.shape[1]
    if wr.dim() != 2 or wr.shape[0] != 3 or wr.shape != wi.shape \
            or n % (4 * wr.shape[1]):
        raise ValueError(f"twiddles must be (3, q) with 4q dividing n={n}, "
                         f"got {tuple(wr.shape)} and {tuple(wi.shape)}")
    tensors = (re, im, wr, wi)
    if any(t.device != re.device for t in tensors):
        raise ValueError("fft4_stage operands must share one device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("fft4_stage takes float32 operands")


def fft4_stage(re: torch.Tensor, im: torch.Tensor, wr: torch.Tensor,
               wi: torch.Tensor) -> tuple:
    """One DIF stage.  re/im: (rows, n) float32; wr/wi: (3, q) twiddles
    with q = current sub-transform length / 4.  CUDA tensors launch the
    kernel, CPU tensors take :func:`fft4_stage_plain`."""
    global LAUNCHES
    _check_args(re, im, wr, wi)
    if re.device.type == "cpu":
        return fft4_stage_plain(re, im, wr, wi)
    if re.device.type != "cuda":
        raise ValueError(f"fft4_stage runs on cuda or cpu, not {re.device}")
    re, im, wr, wi = (t.contiguous() for t in (re, im, wr, wi))
    rows, n = re.shape
    out_re = torch.empty_like(re)
    out_im = torch.empty_like(im)
    lib = _build.load("fft4_stage", _SIGNATURES)
    _build.call(lib, "fft4_stage", lib.fft4_stage_f32, re.device,
                re.data_ptr(), im.data_ptr(), wr.data_ptr(), wi.data_ptr(),
                out_re.data_ptr(), out_im.data_ptr(), rows, n, wr.shape[1])
    LAUNCHES += 1
    return out_re, out_im


def fft4_fused_plain(re: torch.Tensor, im: torch.Tensor, wr: torch.Tensor,
                     wi: torch.Tensor) -> tuple:
    """Every stage of rows of length L in plain PyTorch: the plain stage
    chain, its twiddles cut from the table ``wr``/``wi`` (each stage's
    (3, q) planes back to back, ``L - 1`` values)."""
    L = re.shape[1]
    off, q = 0, L // 4
    while q >= 1:
        re, im = fft4_stage_plain(re, im, wr[off:off + 3 * q].view(3, q),
                                  wi[off:off + 3 * q].view(3, q))
        off, q = off + 3 * q, q // 4
    return re, im


def fft4_fused(re: torch.Tensor, im: torch.Tensor, wr: torch.Tensor,
               wi: torch.Tensor) -> tuple:
    """All log4(L) DIF stages over re/im (rows, L) float32, ``L`` a power
    of 4 up to :data:`L_MAX`, with the stage twiddle table ``wr``/``wi``
    (``L - 1`` values each, see :func:`fft4_fused_plain`).  Returns the
    digit-reversed spectra.  CUDA tensors launch the fused kernel, CPU
    tensors take :func:`fft4_fused_plain`."""
    global FUSED_LAUNCHES
    if re.dim() != 2 or re.shape != im.shape:
        raise ValueError(f"re/im must be matching (rows, L), got "
                         f"{tuple(re.shape)} and {tuple(im.shape)}")
    L = re.shape[1]
    log4(L)
    if not 4 <= L <= L_MAX:
        raise ValueError(f"fft4_fused takes 4 <= L <= {L_MAX}, got {L}")
    if wr.shape != (L - 1,) or wi.shape != (L - 1,):
        raise ValueError(f"twiddle table must be ({L - 1},), got "
                         f"{tuple(wr.shape)} and {tuple(wi.shape)}")
    tensors = (re, im, wr, wi)
    if any(t.device != re.device for t in tensors):
        raise ValueError("fft4_fused operands must share one device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("fft4_fused takes float32 operands")
    if re.device.type == "cpu":
        return fft4_fused_plain(re, im, wr, wi)
    if re.device.type != "cuda":
        raise ValueError(f"fft4_fused runs on cuda or cpu, not {re.device}")
    # The kernel's 16-byte loads need contiguous planes on aligned bases
    # (a fresh allocation always is).
    re, im, wr, wi = (t if t.is_contiguous() and t.data_ptr() % 16 == 0
                      else t.clone(memory_format=torch.contiguous_format)
                      for t in tensors)
    out_re = torch.empty_like(re)
    out_im = torch.empty_like(im)
    lib = _build.load("fft4_stage", _SIGNATURES)
    _build.call(lib, "fft4_stage", lib.fft4_fused_f32, re.device,
                re.data_ptr(), im.data_ptr(), wr.data_ptr(), wi.data_ptr(),
                out_re.data_ptr(), out_im.data_ptr(), re.shape[0], L)
    FUSED_LAUNCHES += 1
    return out_re, out_im
