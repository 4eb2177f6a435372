"""Multi-head Latent Attention (port of ``repro.models.mla``,
DeepSeek-V3).

Prefill runs the expanded path through
:func:`repro_torch.models.attention.flash_attention`: queries of
``qk_nope + qk_rope`` features against keys of the same width (the
rope part one shared key broadcast over the heads) and values of
``v_head_dim``, with the scale ``(qk_nope + qk_rope) ** -0.5``; on the
card that is the flash-attention kernel at its (192, 128) pair, and
under autograd its backward kernels at the same pair (training).  Decode
runs the *absorbed* path: the k up-projection is folded into the query
so attention reads the (B, S, kv_lora) latent cache directly, with the
reference's casts at the same sites (the absorbed query and the softmax
rounded to the cache's dtype, the softmax in float32).  The cache is
written in place, as the port's KV cache is.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import attention as attn_mod
from .attention import NEG_INF, scatter_time
from .config import ModelConfig
from .layers import ParamDef, apply_rope, rms_norm


class MLACache(NamedTuple):
    ckv: torch.Tensor        # (B, S_max, kv_lora) normalized latents
    kpe: torch.Tensor        # (B, S_max, qk_rope_dim) roped shared key
    positions: torch.Tensor  # (B, S_max) int32; -1 == empty


def mla_defs(cfg: ModelConfig) -> dict:
    h = cfg.n_heads
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    return {
        "q_a": ParamDef((cfg.d_model, cfg.q_lora_rank), (None, None)),
        "q_a_norm": ParamDef((cfg.q_lora_rank,), (None,), fsdp_dim=None,
                             init="ones"),
        "q_b": ParamDef((cfg.q_lora_rank, h * qk), (None, "model")),
        "kv_a": ParamDef((cfg.d_model,
                          cfg.kv_lora_rank + cfg.qk_rope_dim),
                         (None, None)),
        "kv_a_norm": ParamDef((cfg.kv_lora_rank,), (None,), fsdp_dim=None,
                              init="ones"),
        "k_b": ParamDef((cfg.kv_lora_rank, h * cfg.qk_nope_dim),
                        (None, "model")),
        "v_b": ParamDef((cfg.kv_lora_rank, h * cfg.v_head_dim),
                        (None, "model")),
        "wo": ParamDef((h * cfg.v_head_dim, cfg.d_model),
                       ("model", None), fsdp_dim=1),
    }


def _latents(p, x, cfg, positions):
    """Shared (normalized latent, roped positional key) for the cache."""
    ckv_full = x @ p["kv_a"].to(x.dtype)
    ckv, kpe = torch.split(ckv_full, [cfg.kv_lora_rank, cfg.qk_rope_dim],
                           dim=-1)
    ckv = rms_norm(ckv, p["kv_a_norm"])
    kpe = apply_rope(kpe[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return ckv, kpe


def _queries(p, x, cfg, positions):
    B, S, _ = x.shape
    h, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    cq = rms_norm(x @ p["q_a"].to(x.dtype), p["q_a_norm"])
    q = (cq @ p["q_b"].to(x.dtype)).reshape(B, S, h, dn + dr)
    q_nope, q_pe = torch.split(q, [dn, dr], dim=-1)
    q_pe = apply_rope(q_pe, positions, cfg.rope_theta)
    return q_nope, q_pe


def _fill(cache: MLACache, ckv, kpe, positions) -> MLACache:
    """Prefill: the last ``min(S, S_max)`` tokens' latents into the cache
    from slot 0, the rest of it zeros with positions -1, in place."""
    B, S = ckv.shape[:2]
    span = min(S, cache.ckv.shape[1])
    for buf, val in ((cache.ckv, ckv), (cache.kpe, kpe)):
        buf[:, span:] = 0
        buf[:, :span] = val[:, -span:].to(buf.dtype)
    cache.positions[:, span:] = -1
    cache.positions[:, :span] = torch.broadcast_to(
        positions[..., -span:], (B, span)).to(torch.int32)
    return cache


def mla_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor,
              cache: Optional[MLACache] = None,
              decode_pos: Optional[torch.Tensor] = None):
    """Returns (out, new_cache).  ``cache`` set => write path; with
    ``decode_pos`` also set => single-token absorbed decode.  The cache's
    buffers are written in place; ``new_cache`` holds the same
    tensors."""
    B, S, _ = x.shape
    h, dn, dr, dv = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    scale = (dn + dr) ** -0.5
    dt = x.dtype

    if cache is not None and decode_pos is not None:
        # ---- absorbed decode ----
        ckv_new, kpe_new = _latents(p, x, cfg, positions)     # (B,1,..)
        Smax = cache.ckv.shape[1]
        slot = torch.clamp_max(decode_pos[0], Smax - 1)
        new_cache = MLACache(
            ckv=scatter_time(cache.ckv, ckv_new, slot),
            kpe=scatter_time(cache.kpe, kpe_new, slot),
            positions=scatter_time(cache.positions, decode_pos[:, None],
                                   slot))
        ckv, kpe = new_cache.ckv, new_cache.kpe
        q_nope, q_pe = _queries(p, x, cfg, positions)
        k_b = p["k_b"].reshape(cfg.kv_lora_rank, h, dn)
        v_b = p["v_b"].reshape(cfg.kv_lora_rank, h, dv)
        # The k up-projection absorbed into the query (in the promoted
        # dtype of the two, as JAX promotes); products against the cache
        # in its dtype, the softmax in float32.
        qk_dt = torch.promote_types(q_nope.dtype, k_b.dtype)
        q_lat = torch.einsum("bhd,chd->bhc", q_nope[:, 0].to(qk_dt),
                             k_b.to(qk_dt))                       # (B,h,c)
        s = (torch.einsum("bhc,bsc->bhs", q_lat.to(ckv.dtype), ckv)
             + torch.einsum("bhr,bsr->bhs", q_pe[:, 0].to(kpe.dtype),
                            kpe)).to(torch.float32) * scale
        valid = ((new_cache.positions <= decode_pos[:, None])
                 & (new_cache.positions >= 0))
        s = torch.where(valid[:, None], s, NEG_INF)
        pr = torch.softmax(s, dim=-1)
        ctx = torch.einsum("bhs,bsc->bhc", pr.to(ckv.dtype), ckv)
        out = torch.einsum("bhc,chd->bhd", ctx.to(dt), v_b.to(dt))
        out = out.reshape(B, 1, h * dv).to(dt)
    else:
        # ---- expanded prefill ----
        ckv, kpe = _latents(p, x, cfg, positions)
        new_cache = cache
        if cache is not None:
            new_cache = _fill(cache, ckv, kpe, positions)
        q_nope, q_pe = _queries(p, x, cfg, positions)
        k_nope = (ckv @ p["k_b"].to(dt)).reshape(B, S, h, dn)
        v = (ckv @ p["v_b"].to(dt)).reshape(B, S, h, dv)
        q = torch.cat([q_nope, q_pe], dim=-1)
        k = torch.cat([k_nope, kpe[:, :, None, :].expand(B, S, h, dr)
                       .to(dt)], dim=-1)
        out = attn_mod.flash_attention(q, k, v, causal=cfg.causal,
                                       chunk=cfg.attn_chunk, scale=scale)
        out = out.reshape(B, S, h * dv)

    return out @ p["wo"].to(dt), new_cache


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, *, device) -> MLACache:
    return MLACache(
        ckv=torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                        device=device),
        kpe=torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dtype,
                        device=device),
        positions=torch.full((batch, max_len), -1, dtype=torch.int32,
                             device=device),
    )
