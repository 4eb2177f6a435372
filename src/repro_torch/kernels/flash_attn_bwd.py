"""Flash attention backward (the gradient of the LM stack's attention in
training).

Replaces no Pallas kernel of its own: the reference differentiates its
jnp chunked attention (``src/repro/models/attention.py:86``) with JAX's
autodiff, and on the card the port's forward is the hand-written kernel
of :mod:`repro_torch.kernels.flash_attn`, so its gradient is a kernel too.
The CUDA kernels (``csrc/flash_attn_bwd.cu``) take q (B, H, S, D), k and v
(B, Hk, T, D) with ``H`` a multiple of ``Hk``, the forward's output and
its gradient dO (B, H, S, D), and the forward's row log-sum-exp (B, H, S)
float32, and write dq, dk and dv in the operands' dtype, float32 or
bfloat16: a pre-pass ``delta = rowsum(dO * O)``, then one kernel per
(batch, KV head, key tile) that recomputes the softmax from ``lse`` and
accumulates dK and dV over every query tile and every query head of its
group, and one per (batch, head, query tile) for dQ; no atomics, so two
runs give the same bits.  bfloat16 at the widths that are multiples of
16 runs on ``mma.sync`` m16n8k16, float32 and bfloat16 at D 8 and 40 on
register FMAs (no TF32).  It
takes the pairs (D, D) of :data:`HEAD_DIMS`, causal or full, and no
window; anything else raises ``ValueError`` before any launch (the
forward's windowed, (192, 128) and (24, 16) paths have no backward yet).
Bound at Qwen3-4B's training shape: tensor-core operations (the source's
header).  Every operand and output may be a strided view whose feature
axis is contiguous (``flash_attn.layout_error``).

The plain version, :func:`flash_attention_bwd_plain`, is autograd through
``ref.flash_attention`` in float32, cast to the operands' dtype: the path
for CPU tensors and the kernel's oracle on the card.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref
from .flash_attn import HEAD_DIMS, layout_error

# Calls of flash_attention_bwd that launched the kernels (the pre-pass,
# dK/dV and dQ: one count); the plain path never counts.
LAUNCHES = 0

# q, k, v, out, dout, lse, delta, dq, dk, dv, their 24 strides, B, H, Hk,
# S, T, D, scale, causal, stream.
_SIGNATURES = {fn: [ctypes.c_void_p] * 10
               + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 6
               + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
               for fn in ("flash_attn_bwd_f32", "flash_attn_bwd_bf16")}
_ENTRY = {torch.float32: "flash_attn_bwd_f32",
          torch.bfloat16: "flash_attn_bwd_bf16"}


def check_supported(d: int, dv: int, window: int = 0) -> None:
    """Raise ``ValueError`` naming what the backward kernels do not take:
    a sliding window, a value width other than the key width, or a width
    outside :data:`HEAD_DIMS`."""
    if window:
        raise ValueError(f"flash_attention has no backward under a sliding "
                         f"window (window {window})")
    if dv != d or d not in HEAD_DIMS:
        raise ValueError(f"flash_attention has a backward at (D, D) for D "
                         f"in {HEAD_DIMS}, not at (D, Dv) = ({d}, {dv})")


def flash_attention_bwd_plain(q, k, v, dout, *, causal: bool = True,
                              scale: float | None = None) -> tuple:
    """``(dq, dk, dv)`` in the operands' dtype, from autograd through the
    float32 reference attention."""
    grads = ref.flash_attention_bwd(q, k, v, dout, causal=causal,
                                    scale=scale)
    return tuple(g.to(t.dtype) for g, t in zip(grads, (q, k, v)))


def _strides(*tensors):
    """The kernels' 24 strides (batch, head, row of each tensor) as a C
    array, after checking each tensor's layout."""
    names = ("q", "k", "v", "out", "dout", "dq", "dk", "dv")
    for name, t in zip(names, tensors):
        err = layout_error(t.shape, t.stride(), t.data_ptr())
        if err:
            raise ValueError(f"flash_attention_bwd: {name} {err}")
    flat = [st for t in tensors for st in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor,
                        lse: torch.Tensor, *, causal: bool = True,
                        scale: float | None = None, window: int = 0,
                        dq: torch.Tensor | None = None,
                        dk: torch.Tensor | None = None,
                        dv: torch.Tensor | None = None) -> tuple:
    """``(dq, dk, dv)``, the gradients of attention over q (B, H, S, D), k
    and v (B, Hk, T, D) (scale ``scale``, default ``D ** -0.5``; causal
    masking by absolute position) against ``dout``, given the forward's
    output ``out`` and its row log-sum-exp ``lse`` (a contiguous (B, H, S)
    float32 tensor, ``flash_attn.flash_attention(..., lse=)``).  Writes
    into ``dq``, ``dk``, ``dv`` (any layout ``layout_error`` accepts, in
    the operands' dtype) where given.  CUDA tensors launch the kernels
    (float32 or bfloat16 operands of one dtype); CPU tensors take
    :func:`flash_attention_bwd_plain`, which needs neither ``out`` nor
    ``lse``.  A window or an unsupported pair raises ``ValueError``
    (:func:`check_supported`) before any launch."""
    global LAUNCHES
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"flash_attention_bwd needs q (B, H, S, D), k and v "
                         f"(B, Hk, T, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s, d = q.shape
    hk, t = k.shape[1], k.shape[2]
    check_supported(d, v.shape[3], window)
    if k.shape[0] != b or k.shape[3] != d or hk == 0 or h % hk:
        raise ValueError(f"flash_attention_bwd: k/v {tuple(k.shape)} do not "
                         f"fit q {tuple(q.shape)} (H must be a multiple of "
                         f"Hk)")
    for name, x in (("out", out), ("dout", dout)):
        if x.shape != q.shape:
            raise ValueError(f"flash_attention_bwd: {name} must be "
                             f"{tuple(q.shape)}, got {tuple(x.shape)}")
    scale = d ** -0.5 if scale is None else float(scale)
    grads = {"dq": (dq, q), "dk": (dk, k), "dv": (dv, v)}
    for name, (g, like) in grads.items():
        if g is not None and (g.shape != like.shape or g.dtype != q.dtype
                              or g.device != q.device):
            raise ValueError(f"flash_attention_bwd: {name} must be "
                             f"{tuple(like.shape)} {q.dtype} on {q.device}")
    if q.device.type == "cpu":
        res = flash_attention_bwd_plain(q, k, v, dout, causal=causal,
                                        scale=scale)
        return tuple(r if g is None else g.copy_(r)
                     for r, (g, _) in zip(res, grads.values()))
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu, not "
                         f"{q.device}")
    if len({x.dtype for x in (q, k, v, out, dout)}) != 1 \
            or q.dtype not in _ENTRY:
        raise TypeError(f"flash_attention_bwd takes float32 or bfloat16 "
                        f"operands of one dtype, got "
                        f"{[x.dtype for x in (q, k, v, out, dout)]}")
    if (tuple(lse.shape) != (b, h, s) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd: lse must be a contiguous "
                         f"({b}, {h}, {s}) float32 tensor on {q.device}")
    dq, dk, dv = (torch.empty_like(like) if g is None else g
                  for g, like in grads.values())
    if 0 in (b, s, t):                  # nothing to launch
        for g in (dq, dk, dv):
            g.zero_()
        return dq, dk, dv
    strides = _strides(q, k, v, out, dout, dq, dk, dv)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    lib = _build.load("flash_attn_bwd", _SIGNATURES)
    _build.call(lib, "flash_attn_bwd", getattr(lib, _ENTRY[q.dtype]),
                q.device, *(x.data_ptr() for x in (q, k, v, out, dout, lse,
                                                   delta, dq, dk, dv)),
                strides, b, h, hk, s, t, d, scale, int(causal))
    LAUNCHES += 1
    return dq, dk, dv
