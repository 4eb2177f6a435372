"""Flash attention forward (the LM stack's prefill attention).

Replaces ``src/repro/kernels/flash_attn.py::flash_attention`` (Pallas
kernel ``_fa_kernel``).  The CUDA kernel (``csrc/flash_attn.cu``) takes
q (B, H, S, D), k (B, Hk, T, D) and v (B, Hk, T, Dv) with ``H`` a
multiple of ``Hk`` (query head ``h`` reads KV head ``h // (H // Hk)``),
float32 or bfloat16, ``(D, Dv)`` in :data:`PAIRS`, and a scale, and
returns (B, H, S, Dv) in q's dtype.  Each operand, and the output, may
be a strided view whose feature axis is contiguous (:func:`layout_error`
says what the kernel reads), so the model hands it its (B, S, H, D)
projections transposed, without a copy.  bfloat16 runs on the tensor
cores (``wgmma`` at D 64, 80, 128 and 192 and at (192, 128),
``mma.sync`` at 16 and 32), float32 at every pair and bfloat16 at D = 8
and (24, 16) in true float32 FMAs, register-tiled (no TF32); each of the
three takes the models' sliding window (the hybrid family's), starting a
query tile's kv loop at the first tile its first row sees.
:data:`HEAD_DIMS` holds the head widths of the repo's configs: 64 and
128 (most of them), 80 (hubert-xlarge), 192 (nemotron-4-340b), and the
smoke configs' 8 and 16; :data:`PAIRS` adds DeepSeek-V3's multi-head
latent attention, keys of 128 + 64 rope features against values of 128,
and its smoke config's (16 + 8, 16).  At the serving path's prefill it
is bound by tensor-core operations.  The plain version is
:func:`repro_torch.kernels.ref.flash_attention` cast to q's dtype, the
path for CPU tensors and the kernel's oracle on the card.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

# Kernel launches made by flash_attention; the plain path never counts.
LAUNCHES = 0

HEAD_DIMS = (8, 16, 32, 64, 80, 128, 192)
# The (query/key width, value width) pairs the kernel computes.
PAIRS = tuple((d, d) for d in HEAD_DIMS) + ((192, 128), (24, 16))

# q, k, v, out, their 12 strides, B, H, Hk, S, T, D, Dv, scale, causal,
# window, stream.
_SIGNATURES = {fn: [ctypes.c_void_p] * 4
               + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 7
               + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                  ctypes.c_void_p]
               for fn in ("flash_attn_f32", "flash_attn_bf16")}
_SIGNATURES["flash_attn_wgmma_smem"] = [ctypes.c_int] * 2
_SIGNATURES["flash_attn_fma_smem"] = [ctypes.c_int] * 2
_ENTRY = {torch.float32: "flash_attn_f32", torch.bfloat16: "flash_attn_bf16"}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, scale: float | None = None,
                          window: int = 0) -> torch.Tensor:
    """The O(S^2) reference attention, in q's dtype."""
    return ref.flash_attention(q, k, v, causal=causal, scale=scale,
                               window=window).to(q.dtype)


def layout_error(shape, strides, base: int):
    """Why the kernel cannot read (or write) an operand of this ``shape``
    and ``strides`` (elements) at address ``base``, or None.  The
    feature axis must be contiguous, the base 16-byte aligned, and the
    batch, head and sequence strides multiples of 8 elements, so that
    every 8-element pack of a row is one aligned 16-byte copy (axes of
    size 1 are never stepped, so their strides do not matter)."""
    if strides[-1] != 1:
        return f"has stride {strides[-1]} on its feature axis, not 1"
    if base % 16:
        return f"starts at {base}, not on a 16-byte boundary"
    bad = [st for size, st in zip(shape[:-1], strides[:-1])
           if size > 1 and st % 8]
    if bad:
        return f"has strides {tuple(strides)}, not multiples of 8 elements"
    return None


def _strides(*tensors):
    """The kernel's 12 strides (batch, head, sequence of each tensor) as
    a C array, after checking each tensor's layout."""
    for name, t in zip(("q", "k", "v", "out"), tensors):
        err = layout_error(t.shape, t.stride(), t.data_ptr())
        if err:
            raise ValueError(f"flash_attention: {name} {err}")
    flat = [st for t in tensors for st in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    window: int = 0,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """Attention over q (B, H, S, D), k (B, Hk, T, D) and v (B, Hk, T,
    Dv) with scale ``scale`` (default ``D ** -0.5``); causal masking by
    absolute position, and a sliding window where ``window > 0`` (query s
    sees key t only when s - t < window; on the card it needs S <= T, so
    that every row sees a key).  Writes into ``out`` ((B, H, S, Dv) in q's dtype,
    any layout :func:`layout_error` accepts) if given, else into a new
    tensor (laid out like q where Dv = D), and returns it.  CUDA tensors launch the
    kernel (float32 or bfloat16 operands of one dtype, ``(D, Dv)`` in
    :data:`PAIRS`, layouts that :func:`layout_error` accepts; anything
    else raises); CPU tensors take the plain version in any layout."""
    global LAUNCHES
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"flash_attention needs q (B, H, S, D), k (B, Hk, "
                         f"T, D) and v (B, Hk, T, Dv), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, s, d = q.shape
    hk, t, dv = k.shape[1], k.shape[2], v.shape[3]
    if k.shape[0] != b or k.shape[3] != d or hk == 0 or h % hk:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"fit q {tuple(q.shape)} (H must be a multiple of "
                         f"Hk)")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention operands must share one device")
    o_shape = (b, h, s, dv)
    if out is not None and (tuple(out.shape) != o_shape
                            or out.dtype != q.dtype
                            or out.device != q.device):
        raise ValueError(f"flash_attention: out must be {o_shape} "
                         f"{q.dtype} on {q.device}, got {tuple(out.shape)} "
                         f"{out.dtype} on {out.device}")
    scale = d ** -0.5 if scale is None else float(scale)
    window = int(window)
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    if q.device.type == "cpu":
        res = flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                    window=window)
        return res if out is None else out.copy_(res)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _ENTRY:
        raise TypeError(f"flash_attention takes float32 or bfloat16 operands "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if (d, dv) not in PAIRS:
        raise ValueError(f"flash_attention takes (D, Dv) in {PAIRS}, got "
                         f"({d}, {dv})")
    if window and s > t:
        raise ValueError(f"flash_attention: a window needs S <= T, got S "
                         f"{s}, T {t}")
    if out is None:
        out = torch.empty_like(q) if dv == d else q.new_empty(o_shape)
    strides = _strides(q, k, v, out)
    lib = _build.load("flash_attn", _SIGNATURES)
    _build.call(lib, "flash_attn", getattr(lib, _ENTRY[q.dtype]), q.device,
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                strides, b, h, hk, s, t, d, dv, scale, int(causal), window)
    LAUNCHES += 1
    return out
