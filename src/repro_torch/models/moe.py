"""Mixture-of-Experts layer (port of ``repro.models.moe``) on one device.

Dispatch is sort-based, as in the reference: token assignments are
sorted by expert id (a stable sort), each expert keeps its first ``C``
assignments (``_capacity``) in an (E, C, d) buffer, the expert FFN runs
as two batched products over that buffer, and each token sums its kept
experts' outputs weighted by its renormalised gate.  Routing is float32
(softmax, top-k with ties to the lower expert id, as ``lax.top_k``).

The buffer holds the same values as the reference's scatter (one token
a kept slot, zeros elsewhere; the dropped assignments' zero payload at
slot (E - 1, C - 1) adds nothing), but is filled by a gather: each slot
reads the assignment the sort put there.  The combine is a gather too:
each token's K contributions are summed in a fixed order (ascending
expert id, the order in which the reference's scatter-add meets them),
so no atomics and no duplicate writes, and the same bits from run to
run on the card.  Exchange and combine are float32 on every device,
the reference's choice on the CPU (it keeps the activations' dtype on a
TPU).

The reference wraps the dispatch in a data-axis ``shard_map`` under a
mesh; the port runs one device, and asking for more data shards raises.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from .config import ModelConfig
from .layers import ParamDef, swiglu


def moe_defs(cfg: ModelConfig) -> dict:
    e, dm, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    ep = cfg.moe_parallel == "ep"
    etp = "model" if ep else None
    ftp = None if ep else "model"
    defs = {
        "router": ParamDef((dm, e), (None, None), fsdp_dim=None,
                           dtype="float32"),
        "w_in": ParamDef((e, dm, 2 * f), (etp, None, ftp), fsdp_dim=1),
        "w_out": ParamDef((e, f, dm), (etp, ftp, None), fsdp_dim=2),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        defs["shared_in"] = ParamDef((dm, 2 * fs), (None, "model"))
        defs["shared_out"] = ParamDef((fs, dm), ("model", None), fsdp_dim=1)
    return defs


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = math.ceil(n_tokens * cfg.top_k / cfg.n_experts
                  * cfg.capacity_factor)
    return max(4, -(-c // 4) * 4)   # round up to a multiple of 4


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest of each row, largest first, ties in ascending
    index order (``jax.lax.top_k``'s order; ``torch.topk`` gives none)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _moe_local(p: dict, x: torch.Tensor, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routed-expert compute.  x: (B, S, d) -> (out, aux_loss)."""
    B, S, d = x.shape
    T = B * S
    E, K = cfg.n_experts, cfg.top_k
    C = _capacity(T, cfg)
    f32 = torch.float32
    dev = x.device
    xt = x.reshape(T, d)

    # --- routing (fp32) ---
    logits = xt.to(f32) @ p["router"]
    probs = torch.softmax(logits, dim=-1)                    # (T, E)
    gate, eidx = top_k(probs, K)                             # (T, K)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)

    # Load-balance auxiliary loss (Switch-style): the reference adds
    # 1 / (T K) once per assignment; here the count times it.
    counts = torch.bincount(eidx.reshape(-1), minlength=E)
    me = probs.mean(dim=0)
    ce = (counts.to(torch.float64) / (T * K)).to(f32)
    aux = cfg.router_aux_weight * E * torch.sum(me * ce)

    # --- sort-based dispatch ---
    e_flat = eidx.reshape(-1)                                # (T*K,)
    order = torch.argsort(e_flat, stable=True)
    e_s = e_flat[order]
    tok_s = order // K                   # tok_flat = repeat(arange(T), K)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * K, device=dev) - starts[e_s]
    keep = pos < C
    e_c = torch.where(keep, e_s, E - 1)
    p_c = torch.where(keep, pos, C - 1)

    # The (E, C, d) float32 buffer: slot (e, c) holds the token of sorted
    # assignment starts[e] + c when c < counts[e], else zeros.
    slot = starts[:, None] + torch.arange(C, device=dev)[None, :]
    filled = torch.arange(C, device=dev)[None, :] < counts[:, None]
    src = tok_s[torch.clamp_max(slot, T * K - 1)]            # (E, C)
    xe = xt[src].to(f32)
    xe.masked_fill_(~filled[..., None], 0.0)

    # --- expert FFN (SwiGLU) ---
    h = torch.bmm(xe.to(x.dtype), p["w_in"].to(x.dtype))
    h = swiglu(h)
    ye = torch.bmm(h, p["w_out"].to(x.dtype))                # (E, C, d)

    # --- combine: each token's kept contributions, gate-weighted, summed
    # in ascending expert id (the sorted order) ---
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * K, device=dev)             # a permutation
    e_t, p_t = e_c[inv].view(T, K), p_c[inv].view(T, K)
    keep_t = keep[inv].view(T, K)
    w_t = gate.reshape(T, K)
    by_expert = torch.argsort(eidx, dim=1, stable=True)
    rows = torch.arange(T, device=dev)
    out = torch.zeros((T, d), dtype=f32, device=dev)
    for j in range(K):
        kk = by_expert[:, j]
        g = ye[e_t[rows, kk], p_t[rows, kk]].to(f32)
        g = torch.where(keep_t[rows, kk][:, None], g, 0.0)
        out = out + g * w_t[rows, kk][:, None]
    return out.to(x.dtype).reshape(B, S, d), aux


def _shared_experts(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Shared-expert FFN: two plain products."""
    hs = x @ p["shared_in"].to(x.dtype)
    return swiglu(hs) @ p["shared_out"].to(x.dtype)


def moe_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
              data_shards: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss) on x's device.  ``data_shards`` > 1
    (the reference's data-axis ``shard_map``) raises."""
    if data_shards > 1:
        raise NotImplementedError(
            "MoE dispatch over data shards comes to the port with the "
            "multi-device (collectives) slice")
    routed = {k: v for k, v in p.items()
              if k not in ("shared_in", "shared_out")}
    out, aux = _moe_local(routed, x, cfg)
    if "shared_in" in p:
        out = out + _shared_experts(p, x.reshape(out.shape))
    return out, aux
