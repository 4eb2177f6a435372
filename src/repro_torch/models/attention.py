"""Attention (port of ``repro.models.attention``): GQA projections,
flash-style chunked attention for prefill, the sliding-window fast
path, and single-token decode against the KV cache.

:func:`flash_attention` runs where its inputs lie.  On the CPU it is
:func:`chunked_attention`, the reference's chunked online-softmax
algorithm step for step (the ``chunk`` blocking, the single-block
fallback, the ``swa_fast`` window path, the finite ``-1e30`` mask), and
autograd differentiates it as JAX differentiates the reference's.  On
the card it launches the hand-written kernel
(:mod:`repro_torch.kernels.flash_attn`), which computes the same
function with its own tiles, with a value width and a scale of its own
where multi-head latent attention asks for them, and the sliding window
of the hybrid family.  Under autograd it is a ``torch.autograd.Function``
whose forward kernel also writes the rows' log-sum-exp and whose
backward is the kernels of :mod:`repro_torch.kernels.flash_attn_bwd`, at
the pairs (D, D) without a window; elsewhere a gradient raises.  Decode
attention is plain torch, as the reference has no kernel for it; under a
window the KV cache is a rolling buffer of ``min(max_len, window)`` slots
(slot ``pos % Smax``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..kernels import flash_attn as _fa
from ..kernels import flash_attn_bwd as _fa_bwd
from .config import ModelConfig
from .layers import ParamDef, apply_rope, rms_norm

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor          # (B, S_max, Hk, D)  [rolling buffer if window]
    v: torch.Tensor          # (B, S_max, Hk, D)
    positions: torch.Tensor  # (B, S_max) int32; -1 marks empty slots


def attn_defs(cfg: ModelConfig) -> dict:
    h, hk, d, dm = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    defs = {
        "wq": ParamDef((dm, h * d), (None, "model")),
        "wk": ParamDef((dm, hk * d), (None, "model")),
        "wv": ParamDef((dm, hk * d), (None, "model")),
        "wo": ParamDef((h * d, dm), ("model", None), fsdp_dim=1),
    }
    if cfg.qkv_bias:
        defs |= {
            "bq": ParamDef((h * d,), ("model",), fsdp_dim=None, init="zeros"),
            "bk": ParamDef((hk * d,), ("model",), fsdp_dim=None,
                           init="zeros"),
            "bv": ParamDef((hk * d,), ("model",), fsdp_dim=None,
                           init="zeros"),
        }
    if cfg.qk_norm:
        defs |= {
            "q_norm": ParamDef((d,), (None,), fsdp_dim=None, init="ones"),
            "k_norm": ParamDef((d,), (None,), fsdp_dim=None, init="ones"),
        }
    return defs


# ---------------------------------------------------------------------------
# Flash-style chunked attention.
# ---------------------------------------------------------------------------

def _block_attn(qc, kc, vc, mask, scale):
    """One (q-block x kv-block) tile.  qc: (B,cq,Hk,g,D); kc/vc:
    (B,ck,Hk,D|Dv); mask: (cq,ck) or None.  Returns unnormalized
    (acc, m, l) contributions: float32 scores of the working-dtype
    inputs, p rounded to v's dtype for the PV product."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", qc.to(torch.float32),
                     kc.to(torch.float32)) * scale
    if mask is not None:
        s = torch.where(mask[None, None, None], s, NEG_INF)
    m = torch.amax(s, dim=-1)                                # (B,Hk,g,cq)
    p = torch.exp(s - m[..., None])
    p = torch.where(torch.isfinite(m)[..., None], p, 0.0)
    l = torch.sum(p, dim=-1)
    acc = torch.einsum("bhgqk,bkhd->bhgqd", p.to(vc.dtype).to(torch.float32),
                       vc.to(torch.float32))
    return acc, m, l


def _combine(acc1, m1, l1, acc2, m2, l2):
    m = torch.maximum(m1, m2)
    a1, a2 = torch.exp(m1 - m), torch.exp(m2 - m)
    a1 = torch.where(torch.isfinite(m1), a1, 0.0)
    a2 = torch.where(torch.isfinite(m2), a2, 0.0)
    return (acc1 * a1[..., None] + acc2 * a2[..., None],
            m, l1 * a1 + l2 * a2)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      chunk: int = 1024,
                      scale: Optional[float] = None) -> torch.Tensor:
    """The reference's chunked attention with running softmax, in plain
    torch on any device.

    q: (B,S,H,D); k,v: (B,T,Hk,D[v]).  Sliding-window with
    ``window <= chunk`` touches only the diagonal and previous kv block
    (O(S) work); otherwise all kv blocks are scanned.
    """
    B, S, H, D = q.shape
    _, T, Hk, Dv = v.shape
    g = H // Hk
    scale = scale if scale is not None else D ** -0.5
    cq = ck = min(chunk, S, T)
    if S % cq or T % ck:  # small/odd shapes: single-block fallback
        cq, ck = S, T
    nq, nk = S // cq, T // ck
    qb = q.reshape(B, nq, cq, Hk, g, D)
    kb = k.reshape(B, nk, ck, Hk, D)
    vb = v.reshape(B, nk, ck, Hk, Dv)
    q_pos = torch.arange(cq, device=q.device)
    k_pos = torch.arange(ck, device=q.device)

    swa_fast = (window > 0 and window <= ck and nk == nq)

    def mask_for(qi, ki):
        qp = qi * cq + q_pos[:, None]
        kp = ki * ck + k_pos[None, :]
        m = torch.ones((cq, ck), dtype=torch.bool, device=q.device)
        if causal:
            m &= qp >= kp
        if window > 0:
            m &= (qp - kp) < window
        return m

    def q_block(qi):
        qc = qb[:, qi]
        if swa_fast:
            # Diagonal + previous block only.
            prev = max(qi - 1, 0)
            acc, m, l = _block_attn(qc, kb[:, qi], vb[:, qi],
                                    mask_for(qi, qi), scale)
            pmask = mask_for(qi, prev) & (qi > 0)
            a2, m2, l2 = _block_attn(qc, kb[:, prev], vb[:, prev],
                                     pmask, scale)
            acc, m, l = _combine(acc, m, l, a2, m2, l2)
        else:
            acc = torch.zeros((B, Hk, g, cq, Dv), dtype=torch.float32,
                              device=q.device)
            m = torch.full((B, Hk, g, cq), NEG_INF, dtype=torch.float32,
                           device=q.device)
            l = torch.zeros((B, Hk, g, cq), dtype=torch.float32,
                            device=q.device)
            for ki in range(nk):
                a2, m2, l2 = _block_attn(qc, kb[:, ki], vb[:, ki],
                                         mask_for(qi, ki), scale)
                acc, m, l = _combine(acc, m, l, a2, m2, l2)
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        return out.permute(0, 3, 1, 2, 4).reshape(B, cq, H, Dv)

    out = torch.cat([q_block(qi) for qi in range(nq)], dim=1)
    return out.to(q.dtype)


class _KernelAttention(torch.autograd.Function):
    """The attention kernel with its backward kernels, on (B, S, H, D)
    tensors seen as (B, H, S, D) through ``transpose(1, 2)``: the forward
    saves q, k, v, the output and the rows' log-sum-exp; the backward
    hands the kernels the output gradient made contiguous and writes the
    three gradients in the operands' (B, S, H, D) layout."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out = torch.empty_like(q)
        lse = torch.empty(q.shape[0], q.shape[2], q.shape[1],
                          dtype=torch.float32, device=q.device)
        _fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, scale=scale,
                            out=out.transpose(1, 2), lse=lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        _fa_bwd.flash_attention_bwd(
            *(t.transpose(1, 2) for t in (q, k, v, out, dout)), lse,
            causal=ctx.causal, scale=ctx.scale, dq=dq.transpose(1, 2),
            dk=dk.transpose(1, 2), dv=dv.transpose(1, 2))
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    chunk: int = 1024,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Chunked attention with running softmax; q: (B,S,H,D); k,v:
    (B,T,Hk,D[v]) -> (B,S,H,Dv) in q's dtype.

    CPU tensors run :func:`chunked_attention`.  CUDA tensors launch the
    flash-attention kernel on (B, H, S, D) transposed views, which it
    reads in place, and it writes a (B, S, H, Dv) output, so no operand
    is copied (``chunk`` is the CPU algorithm's blocking; the kernel has
    its own tiles, and takes the window as the kernel's own argument);
    ``(D, Dv)`` must be one of the kernel's pairs
    (``kernels.flash_attn.PAIRS``, else ``ValueError``).  Where autograd
    records (grad enabled and an operand that requires grad) CUDA tensors
    go through :class:`_KernelAttention`, whose backward is a kernel too;
    a window or a pair other than (D, D) then raises ``ValueError``, and
    nothing falls back to the plain attention.
    """
    if q.device.type == "cpu":
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 chunk=chunk, scale=scale)
    if _fa.needs_grad(q, k, v):
        _fa_bwd.check_supported(q.shape[-1], v.shape[-1], window)
        return _KernelAttention.apply(q, k, v, causal, scale)
    out = torch.empty(q.shape[:3] + v.shape[3:], dtype=q.dtype,
                      device=q.device)
    _fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal, scale=scale,
                        window=window, out=out.transpose(1, 2))
    return out


# ---------------------------------------------------------------------------
# Decode (one new token against the cache).
# ---------------------------------------------------------------------------

def decode_attention(q: torch.Tensor, cache: KVCache, pos: torch.Tensor, *,
                     window: int = 0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,1,H,D); cache.k/v: (B,Smax,Hk,D).  As in the reference, the
    score and PV products run in q's dtype (the scores rounded to it,
    then scaled by the scale rounded to it) and the softmax in float32."""
    B, _, H, D = q.shape
    _, Smax, Hk, Dv = cache.v.shape
    g = H // Hk
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, Hk, g, D)
    s = torch.einsum("bhgd,bshd->bhgs", qg, cache.k.to(qg.dtype))
    # The scale rounded to q's dtype on the host: a Python number reaches
    # the kernel as an argument, where a device tensor would be a copy
    # that waits for the device.
    scale = torch.tensor(scale, dtype=qg.dtype).item()
    s = (s * scale).to(torch.float32)
    valid = (cache.positions <= pos[:, None]) & (cache.positions >= 0)
    if window > 0:
        valid &= (pos[:, None] - cache.positions) < window
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p.to(cache.v.dtype), cache.v)
    return out.reshape(B, 1, H * Dv).to(q.dtype)


def scatter_time(buf: torch.Tensor, new: torch.Tensor,
                 slot: torch.Tensor) -> torch.Tensor:
    """Write ``new`` (B,1,...) into time slot ``slot`` (a one-element
    tensor) of ``buf`` (B,S,...).  Unlike the reference's one-hot select,
    which builds a new buffer, this writes the slot IN PLACE and returns
    ``buf``; the values equal the select's."""
    return buf.index_copy_(1, slot.reshape(1).to(torch.int64),
                           new.to(buf.dtype))


def update_cache(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                 pos: torch.Tensor, *, window: int = 0) -> KVCache:
    """Insert one token (B,1,Hk,D) at ``pos`` (rolling slot if SWA), in
    place (see :func:`scatter_time`)."""
    Smax = cache.k.shape[1]
    slot = (pos[0] % Smax) if window > 0 else torch.clamp_max(pos[0],
                                                              Smax - 1)
    k = scatter_time(cache.k, k_new, slot)
    v = scatter_time(cache.v, v_new, slot)
    positions = scatter_time(cache.positions, pos[:, None], slot)
    return KVCache(k=k, v=v, positions=positions)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, device) -> KVCache:
    s = min(max_len, cfg.attn_window) if cfg.attn_window else max_len
    hk, d = cfg.n_kv_heads, cfg.head_dim
    return KVCache(
        k=torch.zeros((batch, s, hk, d), dtype=dtype, device=device),
        v=torch.zeros((batch, s, hk, d), dtype=dtype, device=device),
        positions=torch.full((batch, s), -1, dtype=torch.int32,
                             device=device),
    )


# ---------------------------------------------------------------------------
# Full attention block (projections + rope + mixer).
# ---------------------------------------------------------------------------

def attention_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                    positions: torch.Tensor,
                    cache: Optional[KVCache] = None,
                    decode_pos: Optional[torch.Tensor] = None):
    """Returns (out, new_cache).  ``cache`` set => write path; with
    ``decode_pos`` also set => single-token decode.  The cache's buffers
    are written in place; ``new_cache`` holds the same tensors."""
    B, S, _ = x.shape
    h, hk, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = q.reshape(B, S, h, d)
    k = k.reshape(B, S, hk, d)
    v = v.reshape(B, S, hk, d)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = cache
    if cache is not None and decode_pos is not None:
        new_cache = update_cache(cache, k, v, decode_pos,
                                 window=cfg.attn_window)
        out = decode_attention(q, new_cache, decode_pos,
                               window=cfg.attn_window)
    else:
        if cache is not None:  # prefill: persist k/v into the cache
            Smax = cache.k.shape[1]
            span = min(S, Smax)
            # Rolling (windowed) caches address slot = position % Smax;
            # align the fill so decode overwrites the OLDEST slot next.
            first_pos = (S - span) % Smax if cfg.attn_window else 0

            def fill(buf, val):
                val = val[:, -span:].to(buf.dtype)
                if span < Smax:
                    buf[:, span:] = 0
                buf[:, :span] = val
                if first_pos:
                    buf.copy_(torch.roll(buf, first_pos, dims=1))
                return buf

            pos_grid = torch.broadcast_to(positions[..., -span:], (B, span))
            cache.positions[:, span:] = -1
            cache.positions[:, :span] = pos_grid.to(torch.int32)
            if first_pos:
                cache.positions.copy_(torch.roll(cache.positions, first_pos,
                                                 dims=1))
            new_cache = KVCache(k=fill(cache.k, k), v=fill(cache.v, v),
                                positions=cache.positions)
        out = flash_attention(q, k, v, causal=cfg.causal,
                              window=cfg.attn_window, chunk=cfg.attn_chunk)
        out = out.reshape(B, S, h * d)
    return out @ p["wo"].to(dt), new_cache
