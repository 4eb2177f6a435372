"""Model stacks (port of ``repro.models.transformer``) for the dense
family and the encoder family:

  * dense:   x += attn(n1(x));  x += mlp(n2(x))
  * encoder: dense block, bidirectional attention

The parameter registry (``param_defs``) equals the reference's for these
families, frontend configs included, so ``param_count`` and the
parameter tree agree.  The MoE, MLA, SSM and hybrid families raise
``NotImplementedError`` naming their slice, and so does running a vision
or audio frontend.  A Python loop over the stacked layer parameters
replaces the reference's ``lax.scan``; serving has no
rematerialization.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .._device import resolve_device
from . import attention as attn_mod
from .config import ModelConfig
from .layers import (DTYPES, ParamDef, init_tree, mlp_apply, mlp_defs,
                     rms_norm, stacked, tree_map)


def _later(what: str, slice_name: str):
    return NotImplementedError(f"{what} comes to the port with the "
                               f"{slice_name} slice")


def _check_family(cfg: ModelConfig) -> None:
    """Raise for the families whose modules this slice does not port."""
    if cfg.is_moe or cfg.use_mtp:
        raise _later("the MoE family", "MoE/MLA")
    if cfg.use_mla:
        raise _later("multi-head latent attention", "MoE/MLA")
    if cfg.family in ("ssm", "hybrid"):
        raise _later(f"the {cfg.family} family", "SSM/hybrid")


def _check_runnable(cfg: ModelConfig) -> None:
    """Raise for what this slice of the port does not run: the families
    above, and the vision and audio frontends."""
    _check_family(cfg)
    if cfg.frontend != "none":
        raise _later(f"the {cfg.frontend} frontend", "multimodal frontend")


# ---------------------------------------------------------------------------
# Parameter registry.
# ---------------------------------------------------------------------------

def _norm_def(d: int) -> ParamDef:
    return ParamDef((d,), (None,), fsdp_dim=None, init="ones")


def block_defs(cfg: ModelConfig) -> dict:
    """One dense (or encoder) block's parameters."""
    _check_family(cfg)
    d = cfg.d_model
    return {"norm1": _norm_def(d), "attn": attn_mod.attn_defs(cfg),
            "norm2": _norm_def(d), "mlp": mlp_defs(d, cfg.d_ff, cfg.act)}


def param_defs(cfg: ModelConfig) -> dict:
    """The parameter registry of a dense or encoder config, frontends
    included (an audio frontend has no token embedding)."""
    _check_family(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    defs: Dict[str, Any] = {"final_norm": _norm_def(d)}
    if cfg.frontend != "audio":
        defs["embed"] = ParamDef((v, d), ("model", None), fsdp_dim=1,
                                 scale=d ** 0.5)  # ~N(0, 1/sqrt(d))
    defs["head"] = ParamDef((d, v), (None, "model"), fsdp_dim=0)

    defs["layers"] = tree_map(lambda pd: stacked(pd, cfg.n_layers),
                              block_defs(cfg))
    return defs


def init_params(cfg: ModelConfig, key: torch.Tensor) -> dict:
    """The reference's ``init_params`` bit for bit, on ``key``'s device
    (``prng.PRNGKey(seed, device=...)``)."""
    return init_tree(key, param_defs(cfg))


# ---------------------------------------------------------------------------
# Block application.
# ---------------------------------------------------------------------------

def block_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                positions: torch.Tensor,
                cache: Optional[attn_mod.KVCache] = None,
                decode_pos: Optional[torch.Tensor] = None):
    """Returns (x, new_cache).  The dense block has no auxiliary loss
    (the reference's third result is a MoE router's)."""
    h = rms_norm(x, p["norm1"])
    a_out, new_cache = attn_mod.attention_apply(
        p["attn"], h, cfg, positions=positions, cache=cache,
        decode_pos=decode_pos)
    x = x + a_out
    h2 = rms_norm(x, p["norm2"])
    x = x + mlp_apply(p["mlp"], h2, cfg.act)
    return x, new_cache


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


def forward(params: dict, cfg: ModelConfig, batch: Dict[str, Any], *,
            caches: Optional[Any] = None,
            decode_pos: Optional[torch.Tensor] = None,
            last_only: bool = False):
    """Run the stack.  Returns (logits, new_caches, aux, hidden).

    ``caches`` (from :func:`init_caches`) are written in place and
    returned.  ``last_only`` projects only the last position to the
    vocabulary (logits (B, 1, V)): the prefill step needs no more, and
    the row's values are the same product.
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

    stack = caches["layers"] if caches is not None else None
    for i in range(cfg.n_layers):
        cache = None
        if stack is not None:
            cache = attn_mod.KVCache(*(t[i] for t in stack))
        x, _ = block_apply(_layer(params["layers"], i), x, cfg,
                           positions=positions, cache=cache,
                           decode_pos=decode_pos)

    hidden = rms_norm(x, params["final_norm"])
    logits = _project_logits(params, hidden[:, -1:] if last_only else hidden)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits, caches, aux, hidden


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
    """Stacked per-layer decode caches for the whole model:
    ``{"layers": KVCache}`` with a leading layer axis."""
    _check_runnable(cfg)
    kv = attn_mod.init_cache(cfg, batch, max_len, dtype,
                             device=resolve_device(device))
    n = cfg.n_layers
    return {"layers": attn_mod.KVCache(
        *(t[None].expand((n,) + t.shape).contiguous() for t in kv))}
