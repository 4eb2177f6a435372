"""Model stacks (port of ``repro.models.transformer``) for the dense,
encoder and MoE families, with multi-head latent attention:

  * dense:   x += attn(n1(x));  x += mlp(n2(x))
  * moe:     x += attn(n1(x));  x += moe(n2(x))      (+ leading dense)
  * encoder: dense block, bidirectional attention

``attn`` is GQA attention or, where the config says ``use_mla``,
multi-head latent attention (:mod:`.mla`).  The parameter registry
(``param_defs``) equals the reference's for every family but SSM and
hybrid, frontends and DeepSeek's multi-token-prediction (``mtp``)
subtree included, so ``param_count`` and the parameter tree agree; the
``mtp`` head's loss is training and waits for that slice.  The SSM and
hybrid families raise ``NotImplementedError`` naming their slice, and so
does running a vision or audio frontend.  A Python loop over the stacked
layer parameters replaces the reference's ``lax.scan``; serving has no
rematerialization.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .._device import resolve_device
from . import attention as attn_mod
from . import mla as mla_mod
from . import moe as moe_mod
from .config import ModelConfig
from .layers import (DTYPES, ParamDef, init_tree, mlp_apply, mlp_defs,
                     rms_norm, stacked, tree_map)


def _later(what: str, slice_name: str):
    return NotImplementedError(f"{what} comes to the port with the "
                               f"{slice_name} slice")


def _check_family(cfg: ModelConfig) -> None:
    """Raise for the families whose modules the port does not have yet."""
    if cfg.family in ("ssm", "hybrid"):
        raise _later(f"the {cfg.family} family", "SSM/hybrid")


def _check_runnable(cfg: ModelConfig) -> None:
    """Raise for what the port does not run yet: the families above, and
    the vision and audio frontends."""
    _check_family(cfg)
    if cfg.frontend != "none":
        raise _later(f"the {cfg.frontend} frontend", "multimodal frontend")


# ---------------------------------------------------------------------------
# Parameter registry.
# ---------------------------------------------------------------------------

def _norm_def(d: int) -> ParamDef:
    return ParamDef((d,), (None,), fsdp_dim=None, init="ones")


def block_defs(cfg: ModelConfig, *, moe_layer: bool = False) -> dict:
    """One block's parameters: attention (GQA or MLA), then an MLP or,
    in a MoE layer, the experts."""
    _check_family(cfg)
    d = cfg.d_model
    defs: Dict[str, Any] = {"norm1": _norm_def(d)}
    defs["attn"] = (mla_mod.mla_defs(cfg) if cfg.use_mla
                    else attn_mod.attn_defs(cfg))
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
    _check_family(cfg)
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
    zero in a block without experts."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, p["norm1"])
    apply = mla_mod.mla_apply if cfg.use_mla else attn_mod.attention_apply
    a_out, new_cache = apply(p["attn"], h, cfg, positions=positions,
                             cache=cache, decode_pos=decode_pos)
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


# ---------------------------------------------------------------------------
# Full forward.
# ---------------------------------------------------------------------------

def embed_inputs(params: dict, cfg: ModelConfig, batch: Dict[str, Any],
                 compute_dtype) -> torch.Tensor:
    """Token embedding (frontends raise until their slice)."""
    if cfg.frontend != "none":
        raise _later(f"the {cfg.frontend} frontend", "multimodal frontend")
    return params["embed"][batch["tokens"]].to(compute_dtype)


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
    returned.  ``last_only`` projects only the last position to the
    vocabulary (logits (B, 1, V)): the prefill step needs no more, and
    the row's values are the same product.  ``aux`` sums the MoE layers'
    router losses, stack by stack as the reference does.
    """
    _check_runnable(cfg)
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
            cache = None if stack is None else type(stack)(
                *(t[i] for t in stack))
            x, _, aux = block_apply(_layer(params[name], i), x, cfg,
                                    moe_layer=moe_layer,
                                    positions=positions, cache=cache,
                                    decode_pos=decode_pos)
            aux_stack = aux_stack + aux
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
    MoE config with leading dense layers): a ``KVCache``, or an
    ``MLACache`` under multi-head latent attention, with a leading layer
    axis."""
    _check_runnable(cfg)
    dev = resolve_device(device)
    if cfg.use_mla:
        one = mla_mod.init_mla_cache(cfg, batch, max_len, dtype, device=dev)
    else:
        one = attn_mod.init_cache(cfg, batch, max_len, dtype, device=dev)
    return {name: type(one)(*(t[None].expand((n,) + t.shape).contiguous()
                              for t in one))
            for name, _, n in _stacks(cfg)}
