"""Row-wise DCT-II (the paper's DCT benchmark kernel).

Replaces ``src/repro/kernels/dct.py::dct`` (Pallas kernel
``_dct_kernel``).  The CUDA kernel (``csrc/dct.cu``) is a pipelined
float32 GEMM of the rows against the transposed orthonormal basis, the
basis streamed through a ring of shared-memory tiles filled by
``cp.async`` (at n = 4096 it is 64 MB, too large to stay resident as it
does in the TPU's VMEM), with a block tile that follows the row count.
Every output is one float32 FMA chain in increasing k whatever the tile,
so a row's result does not depend on the rows beside it.  Rows are
float32, bfloat16 or float16; the output is float32.  It is bound by
float32 operations at many rows and by reading the basis at few.  The
plain version is
:func:`repro_torch.kernels.ref.dct`'s product, the path for CPU tensors
and the kernel's oracle on the card.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

# Kernel launches made by dct; the plain path never counts.
LAUNCHES = 0

_SIGNATURES = {fn: [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
               + [ctypes.c_void_p]
               for fn in ("dct_f32", "dct_bf16", "dct_f16")}
_ENTRY = {torch.float32: "dct_f32", torch.bfloat16: "dct_bf16",
          torch.float16: "dct_f16"}


def dct_plain(x: torch.Tensor, basis_t: torch.Tensor) -> torch.Tensor:
    """``float32(x) @ basis_t`` through the plain matmul."""
    return ref.matmul(x.to(torch.float32), basis_t)


def dct(x: torch.Tensor, basis_t: torch.Tensor) -> torch.Tensor:
    """``float32(x) (T, n) @ basis_t (n, n)`` as float32, the reference
    kernel's contract.  CUDA tensors launch the kernel; CPU tensors take
    the plain version."""
    global LAUNCHES
    if x.dim() != 2 or basis_t.shape != (x.shape[1], x.shape[1]):
        raise ValueError(f"dct needs x (T, n) and basis_t (n, n), got "
                         f"{tuple(x.shape)} and {tuple(basis_t.shape)}")
    if x.device != basis_t.device:
        raise ValueError("dct operands must share one device")
    if basis_t.dtype != torch.float32:
        raise TypeError(f"dct takes a float32 basis, got {basis_t.dtype}")
    if x.device.type == "cpu":
        return dct_plain(x, basis_t)
    if x.device.type != "cuda":
        raise ValueError(f"dct runs on cuda or cpu, not {x.device}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"dct takes float32, bfloat16 or float16 rows, got "
                        f"{x.dtype}")
    x, basis_t = x.contiguous(), basis_t.contiguous()
    rows, n = x.shape
    out = torch.empty((rows, n), dtype=torch.float32, device=x.device)
    lib = _build.load("dct", _SIGNATURES)
    _build.call(lib, "dct", getattr(lib, _ENTRY[x.dtype]), x.device,
                x.data_ptr(), basis_t.data_ptr(), out.data_ptr(), rows, n)
    LAUNCHES += 1
    return out
