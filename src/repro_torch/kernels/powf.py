"""``x ** y`` in float32, bit for bit the C library's ``powf``.

The Pareto straggler model (``core/workloads.py``) draws its tail through
an inverse CDF with a ``pow``, for which XLA's CPU backend calls the C
library's ``powf``; glibc's is not correctly rounded, so no other
``pow`` reproduces the reference's draws.  The CUDA kernel
(``csrc/powf.cu``) computes glibc's algorithm (2.28 and later) with its
tables and its fused multiply-adds, elementwise on the card: large
arrays two 16-byte packs of bases a thread, small ones one base a
thread.  The plain version, :func:`powf_plain`, is the host's C library
itself, called once over a whole buffer through a C helper
(``csrc/powf_host.c``): the path for CPU tensors and the kernel's oracle
on the card.  :func:`fp64_work` reads the kernel's double-precision
instructions a base from the built library, for its bound.
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
    off = xc.data_ptr() % 16 // xc.element_size()
    if off == 0:
        out = torch.empty_like(xc)
    else:
        # ``out`` sits at the same offset from a 16-byte boundary as
        # ``x`` (an offset view), so the kernel's packs line up in both.
        out = torch.empty(xc.numel() + off, dtype=xc.dtype,
                          device=xc.device)[off:].view(xc.shape)
    lib = _build.load("powf", _SIGNATURES)
    _build.call(lib, "powf", lib.powf_f32, x.device, xc.data_ptr(),
                float(np.float32(y)), out.data_ptr(), xc.numel())
    LAUNCHES += 1
    return out


# Opcodes of the FP64 pipe, and conversions to or from 64-bit types other
# than the exponent's (one a call, hoisted).
_FP64_OPS = ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX")
_CONVERSIONS = ("F2F.F32.F64", "I2F.F64", "F2I.F64", "F2F.F64.F64")
# Bases whose code powf_vec_kernel holds: its fast and its special-case
# path, each for the 8 bases of two packs and for one ragged base.
_VEC_COPIES = 2 * (2 * 4 + 1)


def fp64_work() -> tuple:
    """``(fp64, conversions)``: FP64-pipe instructions (adds, multiplies,
    fused multiply-adds, compares) and slow 64-bit conversions a base in
    the built ``powf_vec_kernel``, from its SASS (``cuobjdump -sass``)."""
    ops = _build.sass_opcodes("powf", "powf_vec_kernel")
    fp64 = sum(v for k, v in ops.items() if k.split(".")[0] in _FP64_OPS)
    conv = sum(v for k, v in ops.items() if k.startswith(_CONVERSIONS))
    return fp64 / _VEC_COPIES, conv / _VEC_COPIES
