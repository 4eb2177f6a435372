"""Radix-4 DIF FFT butterfly stage (the paper's 5G OFDM kernel).

Replaces ``src/repro/kernels/fft4.py::fft4_stage`` (Pallas kernel
``_stage_kernel``).  The CUDA kernel (``csrc/fft4_stage.cu``) runs one
thread per butterfly, out of place, float32 only; it is memory-bound:
every stage reads and writes each complex point once (32 bytes a point)
for about 8.5 flops.  :func:`fft4_stage_plain` is the same stage in
plain PyTorch on re/im planes, the path for CPU tensors and the kernel's
oracle on the card.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

# Kernel launches made by fft4_stage; the plain path never counts.
LAUNCHES = 0

_SIGNATURES = {"fft4_stage_f32": [ctypes.c_void_p] * 6
               + [ctypes.c_int] * 3 + [ctypes.c_void_p]}


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
    with torch.cuda.device(re.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fft4_stage_f32(
            re.data_ptr(), im.data_ptr(), wr.data_ptr(), wi.data_ptr(),
            out_re.data_ptr(), out_im.data_ptr(), rows, n, wr.shape[1],
            stream)
    _build.check(lib, "fft4_stage", err)
    LAUNCHES += 1
    return out_re, out_im
