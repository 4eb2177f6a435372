"""Dot product as a barrier-coupled reduction (the paper's DOTP kernel),
in its two synchronization patterns.

Replaces the three Pallas kernels of ``src/repro/kernels/dotp.py``:
``dotp_central`` (every tile adds into one accumulator, the central
counter), ``dotp_partials`` (one partial sum per tile, the tree leaves)
and ``combine_partials`` (one k-ary tree level).  The CUDA kernels
(``csrc/dotp.cu``) run one 256-thread block per 32768-element leaf (the
reference's (256, 128) tile) with 16-byte loads and a shuffle
reduction; the central variant ends each block with one ``atomicAdd`` on
a single address.  :func:`combine_tree` runs every level above the leaves
in one launch, the levels separated by a block-wide barrier, in the
per-level kernel's summation order, so it gives the bits of the chain of
:func:`combine_partials` launches.  All are memory-bound, and the tree
levels are bound by their launches.  The plain versions are in
:mod:`repro_torch.kernels.ref`: the path for CPU tensors and the
kernels' oracles on the card.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

# Kernel launches per kernel; the plain path never counts.
LAUNCHES = {"dotp_central": 0, "dotp_partials": 0, "combine_partials": 0,
            "combine_tree": 0}
# The most partials one combine_tree launch takes: 232,448 bytes of shared
# memory (csrc/dotp.cu TREE_MAX), 1.9 G elements of input.
TREE_MAX = 232448 // 4

_PAIR = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p]
_SIGNATURES = {
    "dotp_partials_f32": _PAIR, "dotp_partials_bf16": _PAIR,
    "dotp_central_f32": _PAIR, "dotp_central_bf16": _PAIR,
    "combine_partials_f32": [ctypes.c_void_p] * 2
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
    "combine_tree_f32": [ctypes.c_void_p] * 2
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
    "dotp_tree_max": [],
}
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

dotp_central_plain = ref.dotp_central
dotp_partials_plain = ref.dotp_partials
combine_partials_plain = ref.combine_partials


def combine_tree_plain(parts: torch.Tensor, radix: int) -> torch.Tensor:
    """Every tree level over ``parts``: :func:`ref.combine_partials` until
    one partial is left, as a float32 scalar."""
    while parts.numel() > 1:
        parts = ref.combine_partials(parts, radix)
    return parts.reshape(())


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


def _launch(fn: str, kernel: str, device: torch.device, *args) -> None:
    lib = _build.load("dotp", _SIGNATURES)
    _build.call(lib, "dotp", getattr(lib, fn), device, *args)
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
    _launch(f"dotp_partials_{_SUFFIX[x.dtype]}", "dotp_partials", x.device,
            x.data_ptr(), y.data_ptr(), out.data_ptr(), x.numel())
    return out


def dotp_central(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``sum(x * y)`` as a float32 scalar through one shared accumulator.
    The order of the atomic adds varies, so the last bits do too."""
    x, y, cuda = _operands(x, y, "dotp_central")
    if not cuda:
        return dotp_central_plain(x, y)
    acc = torch.empty((), dtype=torch.float32, device=x.device)
    _launch(f"dotp_central_{_SUFFIX[x.dtype]}", "dotp_central", x.device,
            x.data_ptr(), y.data_ptr(), acc.data_ptr(), x.numel())
    return acc


def _partials(parts: torch.Tensor, radix, name: str) -> tuple:
    """``(parts, radix, on_cuda)`` checked; raises on what the kernels do
    not take."""
    radix = int(radix)
    if radix < 2:
        raise ValueError(f"{name} needs radix >= 2, got {radix}")
    if parts.dim() != 1 or parts.numel() == 0:
        raise ValueError(f"{name} takes a non-empty 1-D tensor, got shape "
                         f"{tuple(parts.shape)}")
    if parts.device.type == "cpu":
        return parts, radix, False
    if parts.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {parts.device}")
    if parts.dtype != torch.float32:
        raise TypeError(f"{name} takes float32, got {parts.dtype}")
    return parts.contiguous(), radix, True


def combine_partials(parts: torch.Tensor, radix: int) -> torch.Tensor:
    """One k-ary tree level: ``(ceil(n / radix),)`` float32 sums of
    groups of ``radix`` partials, the last group zero-padded."""
    parts, radix, cuda = _partials(parts, radix, "combine_partials")
    if not cuda:
        return combine_partials_plain(parts, radix)
    n = parts.numel()
    out = torch.empty(-(-n // radix), dtype=torch.float32,
                      device=parts.device)
    _launch("combine_partials_f32", "combine_partials", parts.device,
            parts.data_ptr(), out.data_ptr(), n, radix)
    return out


def combine_tree(parts: torch.Tensor, radix: int) -> torch.Tensor:
    """Every k-ary tree level over ``parts`` down to one float32 scalar:
    on the card one launch for up to :data:`TREE_MAX` partials, after
    one :func:`combine_partials` launch per level while more are left.
    The bits are those of the chain of :func:`combine_partials`
    launches."""
    parts, radix, cuda = _partials(parts, radix, "combine_tree")
    if not cuda:
        return combine_tree_plain(parts, radix)
    while parts.numel() > TREE_MAX:
        parts = combine_partials(parts, radix)
    out = torch.empty((), dtype=torch.float32, device=parts.device)
    _launch("combine_tree_f32", "combine_tree", parts.device,
            parts.data_ptr(), out.data_ptr(), parts.numel(), radix)
    return out
