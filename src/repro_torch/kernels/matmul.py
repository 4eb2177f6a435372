"""Skinny GEMM with float32 accumulation (the paper's MATMUL /
beamforming kernel).

Replaces ``src/repro/kernels/matmul.py::matmul`` (Pallas kernel
``_mm_kernel``).  The CUDA kernel (``csrc/matmul.cu``) computes one
32 x 128 output tile a block: x read once into a float32 panel in shared
memory, each warp streaming its own 32 columns of w through a four-stage
shared-memory ring of 16-k chunks by 16-byte ``cp.async``, with no
block-wide barrier while it streams; it takes float32 or bfloat16
inputs, always writes float32 (by ``float4`` streaming stores) and masks
ragged M/N/K edges itself, copying and storing element by element where
a row of w or of the output is not whole 16-byte packs on an aligned
base.  Every output is one ``fmaf`` chain in increasing k, so a call's
first rows (or columns) equal the call on the first rows of x (or
columns of w) bit for bit.  At the 5G beamforming shape its bytes bound
it (about 10 flops a byte), though its FMAs take about as long.  The
plain version is :func:`repro_torch.kernels.ref.matmul`, the path for
CPU tensors and the kernel's oracle on the card.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

# Kernel launches made by matmul; the plain path never counts.
LAUNCHES = 0

_SIGNATURES = {fn: [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
               + [ctypes.c_void_p]
               for fn in ("matmul_f32", "matmul_bf16")}
_ENTRY = {torch.float32: "matmul_f32", torch.bfloat16: "matmul_bf16"}

matmul_plain = ref.matmul


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (M, K) @ w (K, N)`` as float32.  CUDA tensors launch the
    kernel (float32 or bfloat16 inputs of one dtype); CPU tensors take
    the plain version."""
    global LAUNCHES
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul needs (M, K) @ (K, N), got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    if x.device != w.device:
        raise ValueError("matmul operands must share one device")
    if x.device.type == "cpu":
        return matmul_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"matmul runs on cuda or cpu, not {x.device}")
    if x.dtype != w.dtype or x.dtype not in _ENTRY:
        raise TypeError(f"matmul takes float32 or bfloat16 operands of one "
                        f"dtype, got {x.dtype} and {w.dtype}")
    x, w = x.contiguous(), w.contiguous()
    (m, k), n = x.shape, w.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    lib = _build.load("matmul", _SIGNATURES)
    _build.call(lib, "matmul", getattr(lib, _ENTRY[x.dtype]), x.device,
                x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k)
    LAUNCHES += 1
    return out
