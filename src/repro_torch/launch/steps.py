"""Step builders on one device (port of ``build_train_step``,
``build_prefill_step`` and ``build_decode_step`` of
``repro.launch.steps``).

Each builder returns ``(fn, info)`` as the reference's does, with the
same call contracts: train ``fn(params, opt_state, batch) -> (params,
opt_state, metrics)``, prefill ``fn(params, batch) -> (last_logits
(B, 1, V) float32, caches)`` and decode ``fn(params, caches, tokens
(B, 1), pos (B,)) -> (logits (B, 1, V) float32, caches)``.  The
reference jits them over a mesh and donates the caches to decode; here
they run eagerly, the serve steps under ``torch.inference_mode`` with
decode updating the caches in place.  Sharding plans, meshes and the
gradient synchronisation of ``SyncConfig`` (flat, hierarchical, radix-k)
wait for the multi-device slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import optim
from .._device import resolve_device
from ..models import transformer
from ..models.config import ModelConfig
from ..models.layers import DTYPES, _unflatten, tree_items

METRIC_KEYS = ("loss", "ce", "aux", "mtp")


def build_train_step(cfg: ModelConfig, *,
                     opt_cfg: Optional[optim.OptConfig] = None,
                     device="cuda"):
    """Returns ``(step, info)``; ``step(params, opt_state, batch) ->
    (params, opt_state, metrics)`` on ``device``, as the reference's
    train step computes it: the global batch (a dict of tensors with a
    leading batch axis) cut into ``min(cfg.micro_batches, batch)``
    micro-batches, each micro-batch's gradients of ``loss_fn`` (rematted
    block by block where ``cfg.remat``) summed in ``cfg.grad_accum_dtype``
    in order, then scaled by ``1 / n_micro``; the global squared norm of
    the result; one AdamW update (:func:`repro_torch.optim.update` with
    that norm).  ``metrics``: each of ``loss``, ``ce``, ``aux`` (and
    ``mtp`` with that head) averaged over the micro-batches, and
    ``grad_norm``.  The parameters and the state are updated in place
    and returned (the reference's step donates both to XLA), so a step
    holds them once.  ``info`` holds the parameter and state ParamDef
    trees and the ``OptConfig``.  One device: meshes, ``SyncConfig`` and
    sharding plans wait for the multi-device slice (ROADMAP queue 1 item
    5)."""
    dev = resolve_device(device)
    opt_cfg = opt_cfg or optim.OptConfig.from_model(cfg)
    defs = transformer.param_defs(cfg)
    mkeys = METRIC_KEYS if cfg.use_mtp else METRIC_KEYS[:3]
    accum_dtype = DTYPES[cfg.grad_accum_dtype]

    def step(params, opt_state, batch):
        gb = next(iter(batch.values())).shape[0]
        n_micro = min(cfg.micro_batches, gb)
        micro = {k: v.to(dev).reshape((n_micro, gb // n_micro) + v.shape[1:])
                 for k, v in batch.items()}
        items = tree_items(params)
        paths = [p for p, _ in items]
        leaves = [t.detach().requires_grad_(True) for _, t in items]
        live = _unflatten(params, dict(zip(paths, leaves)))
        g_acc = [torch.zeros(t.shape, dtype=accum_dtype, device=t.device)
                 for t in leaves]
        m_acc = [torch.zeros((), dtype=torch.float32, device=dev)
                 for _ in mkeys]
        for i in range(n_micro):
            mb = {k: v[i] for k, v in micro.items()}
            with torch.enable_grad():
                loss, metrics = transformer.loss_fn(live, cfg, mb)
                grads = torch.autograd.grad(loss, leaves,
                                            allow_unused=True,
                                            materialize_grads=True)
            for a, g in zip(g_acc, grads):
                a.add_(g)             # in float32: exact, as g.astype(f32)
            del grads
            m_acc = [a + metrics[k].detach() for a, k in zip(m_acc, mkeys)]
        del live, items, leaves
        for g in g_acc:
            g.mul_(torch.tensor(1.0 / n_micro, dtype=g.dtype))
        grads = _unflatten(params, dict(zip(paths, g_acc)))
        nsq = optim.global_norm_sq(grads)
        optim.update(grads, opt_state, params, opt_cfg, norm_sq=nsq)
        mtree = {k: v / n_micro for k, v in zip(mkeys, m_acc)}
        mtree["grad_norm"] = torch.sqrt(nsq)
        return params, opt_state, mtree

    return step, {"defs": defs,
                  "sdefs": optim.state_defs(defs, opt_cfg),
                  "opt_cfg": opt_cfg}


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
