"""Flash attention forward (the LM stack's prefill attention).

Replaces ``src/repro/kernels/flash_attn.py::flash_attention`` (Pallas
kernel ``_fa_kernel``).  The CUDA kernel (``csrc/flash_attn.cu``) takes
q (B, H, S, D) and k, v (B, Hk, T, D) with ``H`` a multiple of ``Hk``
(query head ``h`` reads KV head ``h // (H // Hk)``), float32 or
bfloat16, ``D`` in :data:`HEAD_DIMS`, and returns (B, H, S, D) in q's
dtype.  bfloat16 runs on the tensor cores (``mma.sync``), float32 in
true float32 FMAs.  At the serving path's prefill it is bound by
tensor-core operations.  The plain version is
:func:`repro_torch.kernels.ref.flash_attention` cast to q's dtype, the
path for CPU tensors and the kernel's oracle on the card.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

# Kernel launches made by flash_attention; the plain path never counts.
LAUNCHES = 0

HEAD_DIMS = (8, 16, 32, 64, 128)

_SIGNATURES = {fn: [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
               + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
               for fn in ("flash_attn_f32", "flash_attn_bf16")}
_ENTRY = {torch.float32: "flash_attn_f32", torch.bfloat16: "flash_attn_bf16"}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True) -> torch.Tensor:
    """The O(S^2) reference attention, in q's dtype."""
    return ref.flash_attention(q, k, v, causal=causal).to(q.dtype)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with a 16-byte-aligned base (the kernel's vector
    loads need it)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Attention over q (B, H, S, D) and k, v (B, Hk, T, D) with scale
    ``D ** -0.5``; causal masking by absolute position.  CUDA tensors
    launch the kernel (float32 or bfloat16 operands of one dtype, ``D``
    in :data:`HEAD_DIMS`); CPU tensors take the plain version."""
    global LAUNCHES
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention needs q (B, H, S, D) and k, v "
                         f"(B, Hk, T, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s, d = q.shape
    hk, t = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hk == 0 or h % hk:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"fit q {tuple(q.shape)} (H must be a multiple of "
                         f"Hk)")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention operands must share one device")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _ENTRY:
        raise TypeError(f"flash_attention takes float32 or bfloat16 operands "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes head dims {HEAD_DIMS}, "
                         f"got {d}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    lib = _build.load("flash_attn", _SIGNATURES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, _ENTRY[q.dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
            hk, s, t, d, d ** -0.5, int(causal), stream)
    _build.check(lib, "flash_attn", err)
    LAUNCHES += 1
    return out
