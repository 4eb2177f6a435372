"""Model stacks (port of ``repro.models.transformer``) for every family
of the reference:

  * dense:   x += attn(n1(x));  x += mlp(n2(x))
  * moe:     x += attn(n1(x));  x += moe(n2(x))      (+ leading dense)
  * ssm:     x += mamba(n1(x))
  * hybrid:  h = n1(x); x += g_a*attn(h) + g_s*mamba(h);  x += mlp(n2(x))
  * encoder: dense block, bidirectional attention

``attn`` is GQA attention (sliding-window where the config sets
``attn_window``) or, where the config says ``use_mla``, multi-head
latent attention (:mod:`.mla`); ``mamba`` is the selective state-space
block of :mod:`.ssm`.  The parameter registry (``param_defs``) equals
the reference's for every family, frontends and DeepSeek's
multi-token-prediction (``mtp``) subtree included, so ``param_count``
and the parameter tree agree; the ``mtp`` head's loss is training and
waits for that slice.  The vision and audio frontends are the
reference's stubs: precomputed embeddings in the batch.  A Python loop
over the stacked layer parameters replaces the reference's
``lax.scan``; serving has no rematerialization.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .._device import resolve_device
from . import attention as attn_mod
from . import mla as mla_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from .config import ModelConfig
from .layers import (DTYPES, ParamDef, init_tree, mlp_apply, mlp_defs,
                     rms_norm, stacked, tree_map)


# ---------------------------------------------------------------------------
# Parameter registry.
# ---------------------------------------------------------------------------

def _norm_def(d: int) -> ParamDef:
    return ParamDef((d,), (None,), fsdp_dim=None, init="ones")


def block_defs(cfg: ModelConfig, *, moe_layer: bool = False) -> dict:
    """One block's parameters: the SSM family's Mamba block alone; else
    attention (GQA or MLA), beside a Mamba block and two gates in the
    hybrid family, then an MLP or, in a MoE layer, the experts."""
    d = cfg.d_model
    defs: Dict[str, Any] = {"norm1": _norm_def(d)}
    if cfg.family == "ssm":
        defs["ssm"] = ssm_mod.ssm_defs(cfg)
        return defs
    defs["attn"] = (mla_mod.mla_defs(cfg) if cfg.use_mla
                    else attn_mod.attn_defs(cfg))
    if cfg.family == "hybrid":
        defs["ssm"] = ssm_mod.ssm_defs(cfg)
        defs["gate_attn"] = ParamDef((1,), (None,), fsdp_dim=None,
                                     init="ones")
        defs["gate_ssm"] = ParamDef((1,), (None,), fsdp_dim=None,
                                    init="ones")
    defs["norm2"] = _norm_def(d)
    if moe_layer:
        defs["moe"] = moe_mod.moe_defs(cfg)
    else:
        defs["mlp"] = mlp_defs(d, cfg.d_ff, cfg.act)
    return defs


def param_defs(cfg: ModelConfig) -> dict:
    """The parameter registry, frontends included (an audio frontend has
    no token embedding): MoE configs stack their leading dense layers as
    ``dense_layers`` and their MoE layers as ``layers``."""
    d, v = cfg.d_model, cfg.vocab_size
    defs: Dict[str, Any] = {"final_norm": _norm_def(d)}
    if cfg.frontend != "audio":
        defs["embed"] = ParamDef((v, d), ("model", None), fsdp_dim=1,
                                 scale=d ** 0.5)  # ~N(0, 1/sqrt(d))
    defs["head"] = ParamDef((d, v), (None, "model"), fsdp_dim=0)

    def stack_tree(tree, n):
        return tree_map(lambda pd: stacked(pd, n), tree)

    if cfg.is_moe:
        if cfg.n_dense_layers:
            defs["dense_layers"] = stack_tree(
                block_defs(cfg, moe_layer=False), cfg.n_dense_layers)
        defs["layers"] = stack_tree(block_defs(cfg, moe_layer=True),
                                    cfg.n_moe_layers)
    else:
        defs["layers"] = stack_tree(block_defs(cfg), cfg.n_layers)

    if cfg.use_mtp:
        defs["mtp"] = {
            "proj": ParamDef((2 * d, d), (None, None)),
            "norm_h": _norm_def(d),
            "norm_e": _norm_def(d),
            "block": block_defs(cfg, moe_layer=False),
            "final_norm": _norm_def(d),
        }
    return defs


def init_params(cfg: ModelConfig, key: torch.Tensor) -> dict:
    """The reference's ``init_params`` bit for bit, on ``key``'s device
    (``prng.PRNGKey(seed, device=...)``)."""
    return init_tree(key, param_defs(cfg))


# ---------------------------------------------------------------------------
# Block application.
# ---------------------------------------------------------------------------

def block_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                moe_layer: bool = False, positions: torch.Tensor,
                cache: Optional[Any] = None,
                decode_pos: Optional[torch.Tensor] = None):
    """Returns (x, new_cache, aux_loss): the MoE router's auxiliary loss,
    zero in a block without experts.  A hybrid block's cache is the dict
    ``{"attn": KVCache, "ssm": SSMCache}``; the attention caches are
    written in place, an ``SSMCache`` comes back new."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    decode = decode_pos is not None
    h = rms_norm(x, p["norm1"])
    if cfg.family == "ssm":
        out, new_cache = ssm_mod.ssm_apply(p["ssm"], h, cfg, cache=cache,
                                           decode=decode)
        return x + out, (new_cache if cache is not None else None), aux
    cache_attn = cache["attn"] if isinstance(cache, dict) else cache
    apply = mla_mod.mla_apply if cfg.use_mla else attn_mod.attention_apply
    a_out, new_cache = apply(p["attn"], h, cfg, positions=positions,
                             cache=cache_attn, decode_pos=decode_pos)
    if cfg.family == "hybrid":
        s_out, c_ssm = ssm_mod.ssm_apply(
            p["ssm"], h, cfg,
            cache=cache["ssm"] if isinstance(cache, dict) else None,
            decode=decode)
        x = (x + p["gate_attn"].to(x.dtype) * a_out
             + p["gate_ssm"].to(x.dtype) * s_out)
        new_cache = ({"attn": new_cache, "ssm": c_ssm}
                     if cache is not None else None)
    else:
        x = x + a_out
    h2 = rms_norm(x, p["norm2"])
    if moe_layer:
        m_out, aux = moe_mod.moe_apply(p["moe"], h2, cfg)
    else:
        m_out = mlp_apply(p["mlp"], h2, cfg.act)
    return x + m_out, new_cache, aux


def _layer(tree, i: int):
    """Layer ``i`` of a stacked parameter tree (views, no copies)."""
    return tree_map(lambda t: t[i], tree)


def _cache_at(stack, i: int):
    """Layer ``i`` of a stacked cache (a cache NamedTuple, or the hybrid's
    dict of them), as views."""
    if isinstance(stack, dict):
        return {k: _cache_at(v, i) for k, v in stack.items()}
    return type(stack)(*(t[i] for t in stack))


def _store(stack, i: int, new):
    """``stack`` with layer ``i``'s new cache in it.  Attention caches were
    written in place through their views; a new ``SSMCache`` is copied in.
    Its conv state comes in the activations' dtype, as the reference's
    does whatever the caches' dtype, so a stack of another dtype is first
    recast (every layer's entry is rewritten by the same run)."""
    if isinstance(stack, dict):
        return {k: _store(v, i, new[k]) for k, v in stack.items()}
    if isinstance(new, ssm_mod.SSMCache):
        if stack.conv.dtype != new.conv.dtype:
            stack = stack._replace(conv=stack.conv.to(new.conv.dtype))
        stack.conv[i].copy_(new.conv)
        stack.state[i].copy_(new.state)
    return stack


# ---------------------------------------------------------------------------
# Full forward.
# ---------------------------------------------------------------------------

def embed_inputs(params: dict, cfg: ModelConfig, batch: Dict[str, Any],
                 compute_dtype) -> torch.Tensor:
    """Token/frontend embedding.  Audio: the precomputed frame embeddings
    ``batch["features"]``; vision: the stub patch embeddings
    ``batch["img_embeds"]`` spliced over the first ``n_frontend_tokens``
    token embeddings."""
    if cfg.frontend == "audio":
        return batch["features"].to(compute_dtype)
    x = params["embed"][batch["tokens"]].to(compute_dtype)
    if cfg.frontend == "vision" and "img_embeds" in batch:
        n = cfg.n_frontend_tokens
        img = batch["img_embeds"].to(compute_dtype)
        x = torch.cat([img, x[:, n:]], dim=1)
    return x


def _stacks(cfg: ModelConfig) -> list:
    """(name, moe_layer, layer count) of each stack, in order."""
    if not cfg.is_moe:
        return [("layers", False, cfg.n_layers)]
    out = [("dense_layers", False, cfg.n_dense_layers)] \
        if cfg.n_dense_layers else []
    return out + [("layers", True, cfg.n_moe_layers)]


def forward(params: dict, cfg: ModelConfig, batch: Dict[str, Any], *,
            caches: Optional[Any] = None,
            decode_pos: Optional[torch.Tensor] = None,
            last_only: bool = False):
    """Run the stack.  Returns (logits, new_caches, aux, hidden).

    ``caches`` (from :func:`init_caches`) are written in place and
    returned (an SSM stack's entry in ``caches`` may be replaced, see
    :func:`_store`).  ``last_only`` projects only the last position to the
    vocabulary (logits (B, 1, V)): the prefill step needs no more, and
    the row's values are the same product.  ``aux`` sums the MoE layers'
    router losses, stack by stack as the reference does.
    """
    cdt = DTYPES[cfg.compute_dtype]
    x = embed_inputs(params, cfg, batch, cdt)
    B, S = x.shape[:2]
    if decode_pos is not None:
        positions = decode_pos[:, None]
    else:
        positions = torch.broadcast_to(
            torch.arange(S, device=x.device)[None], (B, S))

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for name, moe_layer, n in _stacks(cfg):
        stack = caches[name] if caches is not None else None
        aux_stack = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(n):
            cache = None if stack is None else _cache_at(stack, i)
            x, new_cache, aux = block_apply(
                _layer(params[name], i), x, cfg, moe_layer=moe_layer,
                positions=positions, cache=cache, decode_pos=decode_pos)
            if stack is not None:
                stack = _store(stack, i, new_cache)
            aux_stack = aux_stack + aux
        if stack is not None:
            caches[name] = stack
        aux_total = aux_total + aux_stack

    hidden = rms_norm(x, params["final_norm"])
    logits = _project_logits(params, hidden[:, -1:] if last_only else hidden)
    return logits, caches, aux_total, hidden


def _project_logits(params: dict, hidden: torch.Tensor) -> torch.Tensor:
    """Same-dtype product (rounded to the working dtype, as the
    reference's), then float32."""
    logits = hidden @ params["head"].to(hidden.dtype)
    return logits.to(torch.float32)


# ---------------------------------------------------------------------------
# Cache construction.
# ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, *, device="cuda"):
    """Stacked per-layer decode caches for the whole model, one entry a
    stack (``{"layers": ...}``, and ``"dense_layers"`` before it in a
    MoE config with leading dense layers), each with a leading layer
    axis: a ``KVCache`` (a rolling one of ``min(max_len, attn_window)``
    slots under a sliding window), an ``MLACache`` under multi-head
    latent attention, an ``SSMCache`` in the SSM family, and in the
    hybrid family the dict ``{"attn": KVCache, "ssm": SSMCache}``."""
    dev = resolve_device(device)
    if cfg.family == "ssm":
        one = ssm_mod.init_ssm_cache(cfg, batch, dtype, device=dev)
    elif cfg.use_mla:
        one = mla_mod.init_mla_cache(cfg, batch, max_len, dtype, device=dev)
    else:
        one = attn_mod.init_cache(cfg, batch, max_len, dtype, device=dev)
    if cfg.family == "hybrid":
        one = {"attn": one,
               "ssm": ssm_mod.init_ssm_cache(cfg, batch, dtype, device=dev)}

    def stack(c, n):
        if isinstance(c, dict):
            return {k: stack(v, n) for k, v in c.items()}
        return type(c)(*(t[None].expand((n,) + t.shape).contiguous()
                         for t in c))

    return {name: stack(one, n) for name, _, n in _stacks(cfg)}
