"""Dot product as a barrier-coupled reduction (the paper's DOTP kernel),
in its two synchronization patterns.

Replaces the three Pallas kernels of ``src/repro/kernels/dotp.py``:
``dotp_central`` (every tile adds into one accumulator, the central
counter), ``dotp_partials`` (one partial sum per tile, the tree leaves)
and ``combine_partials`` (one k-ary tree level).  The CUDA kernels
(``csrc/dotp.cu``) run one 256-thread block per 32768-element leaf (the
reference's (256, 128) tile) with 16-byte loads and a shuffle
reduction; the central variant ends each block with one ``atomicAdd`` on
a single address.  All three are memory-bound.  The plain versions are
in :mod:`repro_torch.kernels.ref`: the path for CPU tensors and the
kernels' oracles on the card.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

# Kernel launches per kernel; the plain path never counts.
LAUNCHES = {"dotp_central": 0, "dotp_partials": 0, "combine_partials": 0}

_PAIR = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p]
_SIGNATURES = {
    "dotp_partials_f32": _PAIR, "dotp_partials_bf16": _PAIR,
    "dotp_central_f32": _PAIR, "dotp_central_bf16": _PAIR,
    "combine_partials_f32": [ctypes.c_void_p] * 2
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
}
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

dotp_central_plain = ref.dotp_central
dotp_partials_plain = ref.dotp_partials
combine_partials_plain = ref.combine_partials


def leaf_count(n: int) -> int:
    """Leaves of the reduction tree over ``n`` elements."""
    return max(1, -(-int(n) // ref.DOTP_LEAF))


def _operands(x: torch.Tensor, y: torch.Tensor, name: str) -> tuple:
    """Flattened, contiguous operands; raises on what the kernels do not
    take.  Returns ``(x, y, on_cuda)``."""
    if x.shape != y.shape:
        raise ValueError(f"{name} operands differ in shape: "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if x.numel() == 0:
        raise ValueError(f"{name} needs at least one element")
    if x.device != y.device:
        raise ValueError(f"{name} operands must share one device")
    if x.device.type == "cpu":
        return x, y, False
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    if x.dtype != y.dtype or x.dtype not in _SUFFIX:
        raise TypeError(f"{name} takes float32 or bfloat16 operands of one "
                        f"dtype, got {x.dtype} and {y.dtype}")
    return x.reshape(-1).contiguous(), y.reshape(-1).contiguous(), True


def _launch(fn: str, kernel: str, *args) -> None:
    lib = _build.load("dotp", _SIGNATURES)
    err = getattr(lib, fn)(*args, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, "dotp", err)
    LAUNCHES[kernel] += 1


def dotp_partials(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The tree leaves: ``(leaf_count(n),)`` float32 partial sums of
    ``x * y``.  CUDA tensors launch the kernel; CPU tensors take the
    plain version."""
    x, y, cuda = _operands(x, y, "dotp_partials")
    if not cuda:
        return dotp_partials_plain(x, y)
    out = torch.empty(leaf_count(x.numel()), dtype=torch.float32,
                      device=x.device)
    with torch.cuda.device(x.device):
        _launch(f"dotp_partials_{_SUFFIX[x.dtype]}", "dotp_partials",
                x.data_ptr(), y.data_ptr(), out.data_ptr(), x.numel())
    return out


def dotp_central(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``sum(x * y)`` as a float32 scalar through one shared accumulator.
    The order of the atomic adds varies, so the last bits do too."""
    x, y, cuda = _operands(x, y, "dotp_central")
    if not cuda:
        return dotp_central_plain(x, y)
    acc = torch.empty((), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _launch(f"dotp_central_{_SUFFIX[x.dtype]}", "dotp_central",
                x.data_ptr(), y.data_ptr(), acc.data_ptr(), x.numel())
    return acc


def combine_partials(parts: torch.Tensor, radix: int) -> torch.Tensor:
    """One k-ary tree level: ``(ceil(n / radix),)`` float32 sums of
    groups of ``radix`` partials, the last group zero-padded."""
    radix = int(radix)
    if radix < 2:
        raise ValueError(f"combine_partials needs radix >= 2, got {radix}")
    if parts.dim() != 1 or parts.numel() == 0:
        raise ValueError(f"combine_partials takes a non-empty 1-D tensor, "
                         f"got shape {tuple(parts.shape)}")
    if parts.device.type == "cpu":
        return combine_partials_plain(parts, radix)
    if parts.device.type != "cuda":
        raise ValueError(f"combine_partials runs on cuda or cpu, not "
                         f"{parts.device}")
    if parts.dtype != torch.float32:
        raise TypeError(f"combine_partials takes float32, got {parts.dtype}")
    parts = parts.contiguous()
    n = parts.numel()
    out = torch.empty(-(-n // radix), dtype=torch.float32,
                      device=parts.device)
    with torch.cuda.device(parts.device):
        _launch("combine_partials_f32", "combine_partials",
                parts.data_ptr(), out.data_ptr(), n, radix)
    return out
