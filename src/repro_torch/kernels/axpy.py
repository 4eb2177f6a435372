"""AXPY, ``a * x + y`` (the paper's AXPY benchmark kernel).

Replaces ``src/repro/kernels/axpy.py::axpy`` (Pallas kernel
``_axpy_kernel``).  In the CUDA kernel (``csrc/axpy.cu``) each thread
loads a fixed run of 16-byte packs of x and y (streaming loads, all
before its first store), float32 or bfloat16 in and out, each element
one float32 fused multiply-add rounded once to the output dtype.  It is
memory-bound: 12 bytes moved per float32 element for 2 flops.  The plain
version is :func:`repro_torch.kernels.ref.axpy`, the path for CPU
tensors and the kernel's oracle on the card.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

# Kernel launches made by axpy; the plain path never counts.
LAUNCHES = 0

_SIGNATURES = {fn: [ctypes.c_float] + [ctypes.c_void_p] * 3
               + [ctypes.c_longlong, ctypes.c_void_p]
               for fn in ("axpy_f32", "axpy_bf16")}
_ENTRY = {torch.float32: "axpy_f32", torch.bfloat16: "axpy_bf16"}

axpy_plain = ref.axpy


def axpy(a, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``a * x + y`` in ``x``'s dtype and shape; ``a`` is a Python number
    (or one-element tensor) taken as float32.  CUDA tensors launch the
    kernel (float32 or bfloat16 operands of one dtype); CPU tensors take
    the plain version."""
    global LAUNCHES
    if x.shape != y.shape:
        raise ValueError(f"axpy operands differ in shape: {tuple(x.shape)} "
                         f"and {tuple(y.shape)}")
    if x.device != y.device:
        raise ValueError("axpy operands must share one device")
    a = float(a)
    if x.device.type == "cpu":
        return axpy_plain(a, x, y)
    if x.device.type != "cuda":
        raise ValueError(f"axpy runs on cuda or cpu, not {x.device}")
    if x.dtype != y.dtype or x.dtype not in _ENTRY:
        raise TypeError(f"axpy takes float32 or bfloat16 operands of one "
                        f"dtype, got {x.dtype} and {y.dtype}")
    xc, yc = x.contiguous(), y.contiguous()
    out = torch.empty_like(xc)
    lib = _build.load("axpy", _SIGNATURES)
    _build.call(lib, "axpy", getattr(lib, _ENTRY[x.dtype]), x.device,
                a, xc.data_ptr(), yc.data_ptr(), out.data_ptr(), xc.numel())
    LAUNCHES += 1
    return out
