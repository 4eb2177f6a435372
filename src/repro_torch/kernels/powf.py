"""``x ** y`` in float32, bit for bit the C library's ``powf``.

The Pareto straggler model (``core/workloads.py``) draws its tail through
an inverse CDF with a ``pow``, for which XLA's CPU backend calls the C
library's ``powf``; glibc's is not correctly rounded, so no other
``pow`` reproduces the reference's draws.  The CUDA kernel
(``csrc/powf.cu``) computes glibc's algorithm (2.28 and later) with its
tables and its fused multiply-adds, elementwise on the card.  The plain
version, :func:`powf_plain`, is the host's C library itself, called once
over a whole buffer through a C helper (``csrc/powf_host.c``): the path
for CPU tensors and the kernel's oracle on the card.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

# Kernel launches made by powf; the plain path never counts.
LAUNCHES = 0

_SIGNATURES = {"powf_f32": [ctypes.c_void_p, ctypes.c_float,
                            ctypes.c_void_p, ctypes.c_longlong,
                            ctypes.c_void_p]}
_HOST_SIGNATURES = {"powf_host": [ctypes.c_void_p, ctypes.c_float,
                                  ctypes.c_void_p, ctypes.c_longlong]}


def _check(x: torch.Tensor) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"powf takes float32 bases, got {x.dtype}")


def powf_plain(x: torch.Tensor, y: float) -> torch.Tensor:
    """``x ** y`` through the host's C library ``powf``, one C loop over
    the buffer; the result returns to ``x``'s device."""
    _check(x)
    base = np.ascontiguousarray(x.detach().cpu().numpy().reshape(-1))
    out = np.empty_like(base)
    lib = _build.load("powf_host", _HOST_SIGNATURES)
    lib.powf_host(base.ctypes.data, float(np.float32(y)), out.ctypes.data,
                  base.size)
    return torch.from_numpy(out).reshape(x.shape).to(x.device)


def powf(x: torch.Tensor, y: float) -> torch.Tensor:
    """``x ** y`` for float32 ``x`` and a scalar exponent (rounded to
    float32), equal to the C library's ``powf``.  CUDA tensors launch the
    kernel; CPU tensors take the plain version."""
    global LAUNCHES
    _check(x)
    if x.device.type == "cpu":
        return powf_plain(x, y)
    if x.device.type != "cuda":
        raise ValueError(f"powf runs on cuda or cpu, not {x.device}")
    xc = x.contiguous()
    out = torch.empty_like(xc)
    lib = _build.load("powf", _SIGNATURES)
    _build.call(lib, "powf", lib.powf_f32, x.device, xc.data_ptr(),
                float(np.float32(y)), out.data_ptr(), xc.numel())
    LAUNCHES += 1
    return out
