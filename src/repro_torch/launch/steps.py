"""Serve steps on one device (port of ``build_prefill_step`` and
``build_decode_step`` of ``repro.launch.steps``).

Each builder returns ``(fn, info)`` as the reference's does, with the
same call contracts: prefill ``fn(params, batch) -> (last_logits
(B, 1, V) float32, caches)`` and decode ``fn(params, caches, tokens
(B, 1), pos (B,)) -> (logits (B, 1, V) float32, caches)``.  The
reference jits them over a mesh and donates the caches to decode; here
they run eagerly under ``torch.inference_mode`` and decode updates the
caches in place.  Sharding plans and meshes wait for the multi-device
slice.
"""
from __future__ import annotations

import torch

from .._device import resolve_device
from ..models import transformer
from ..models.config import ModelConfig


def build_prefill_step(cfg: ModelConfig, *, batch: int, seq_len: int,
                       device="cuda"):
    """Prefill: encode ``seq_len`` tokens -> last logits (+ caches).  The
    caches (``transformer.init_caches``: a KV cache, rolling under a
    sliding window; a latent cache under multi-head latent attention; an
    SSM cache of conv and scan states in the SSM family; both, as a dict,
    in the hybrid family) are allocated on
    ``device`` at each call, in bf16 as the reference's are (its
    ``init_caches`` default, whatever the config's dtype).  Only the last position is projected to the vocabulary (the
    encoder family returns every position's logits and no caches, as
    the reference does)."""
    dev = resolve_device(device)
    defs = transformer.param_defs(cfg)
    decoder = cfg.family != "encoder"

    @torch.inference_mode()
    def fn(params, batch_in):
        caches = None
        if decoder:
            caches = transformer.init_caches(cfg, batch, seq_len, device=dev)
        logits, new_caches, _, _ = transformer.forward(
            params, cfg, batch_in, caches=caches, last_only=decoder)
        return (logits, new_caches) if decoder else logits

    return fn, {"defs": defs}


def build_decode_step(cfg: ModelConfig, *, batch: int, max_len: int,
                      device="cuda"):
    """One decode step against pre-filled caches of ``batch`` sequences
    and ``max_len`` slots on ``device`` (written in place)."""
    resolve_device(device)
    defs = transformer.param_defs(cfg)

    @torch.inference_mode()
    def fn(params, caches, tokens, pos):
        logits, new_caches, _, _ = transformer.forward(
            params, cfg, {"tokens": tokens}, caches=caches, decode_pos=pos)
        return logits, new_caches

    return fn, {"defs": defs}
