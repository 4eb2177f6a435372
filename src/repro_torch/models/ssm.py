"""Mamba-1 selective state-space block (port of ``repro.models.ssm``):
the Falcon-Mamba SSM family and the SSM path of the hybrid (Hymba).

Prefill runs the selective scan of :mod:`repro_torch.kernels.ssm_scan`:
the hand-written kernel for CUDA tensors, its plain chunked version for
CPU ones (which autograd differentiates).  Where autograd records on the
card the scan is :class:`_KernelScan`, whose forward kernel also writes
the state at the start of every 16-step tile and whose backward is the
kernel of :mod:`repro_torch.kernels.ssm_scan_bwd`.  Decode is the
reference's one-step recurrence in plain torch on both devices (the
reference has no kernel there) against the cache (conv_state,
ssm_state), O(1) in the sequence length.  The reference's
casts stay where they are: ``x_proj``'s product in the activations'
dtype, ``dt`` through ``softplus`` in float32, the causal conv in
float32 and cast back, the state float32, ``y`` cast to the input dtype
before the ``silu(z)`` gate.  The reference's sharding constraints are
dropped (one device).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ssm_scan as _scan
from ..kernels import ssm_scan_bwd as _scan_bwd
from .config import ModelConfig
from .layers import ParamDef


class SSMCache(NamedTuple):
    conv: torch.Tensor    # (B, d_conv-1, d_inner) last inputs
    state: torch.Tensor   # (B, d_inner, n) SSM state, float32


def ssm_defs(cfg: ModelConfig) -> dict:
    dm, di, n, r = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    return {
        "in_proj": ParamDef((dm, 2 * di), (None, "model")),
        "conv_w": ParamDef((cfg.d_conv, di), (None, "model"),
                           fsdp_dim=None, scale=1.0),
        "conv_b": ParamDef((di,), ("model",), fsdp_dim=None, init="zeros"),
        "x_proj": ParamDef((di, r + 2 * n), ("model", None), fsdp_dim=None),
        "dt_proj": ParamDef((r, di), (None, "model"), fsdp_dim=None),
        "dt_bias": ParamDef((di,), ("model",), fsdp_dim=None, init="ssm_dt"),
        "a_log": ParamDef((di, n), ("model", None), fsdp_dim=None,
                          init="ssm_a"),
        "d_skip": ParamDef((di,), ("model",), fsdp_dim=None, init="ones"),
        "out_proj": ParamDef((di, dm), ("model", None), fsdp_dim=1),
    }


def _ssm_params(p, x) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Input-dependent (dt, B, C) for x: (..., di), float32."""
    f32 = torch.float32
    dbc = x @ p["x_proj"].to(x.dtype)
    r = p["dt_proj"].shape[0]
    n = p["a_log"].shape[1]
    dt, b, c = torch.split(dbc, [r, n, n], dim=-1)
    dt = F.softplus(dt.to(f32) @ p["dt_proj"].to(f32)
                    + p["dt_bias"].to(f32))                  # (..., di)
    return dt, b.to(f32), c.to(f32)


def _causal_conv(p, x, conv_state=None):
    """Depthwise causal conv over S.  x: (B,S,di).  Returns (out in x's
    dtype, the last d_conv - 1 inputs in x's dtype)."""
    dw = p["conv_w"].to(torch.float32)                        # (K, di)
    K = dw.shape[0]
    xf = x.to(torch.float32)
    if conv_state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]),
                          dtype=torch.float32, device=x.device)
    else:
        pad = conv_state.to(torch.float32)
    xp = torch.cat([pad, xf], dim=1)                          # (B,S+K-1,di)
    S = x.shape[1]
    out = xp[:, 0:S] * dw[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * dw[i]
    out = out + p["conv_b"].to(torch.float32)
    new_state = xp[:, -(K - 1):]
    return out.to(x.dtype), new_state.to(x.dtype)


class _KernelScan(torch.autograd.Function):
    """The scan kernel with its backward kernel, on the float32 operands
    of :func:`repro_torch.kernels.ssm_scan.ssm_scan`: the forward writes
    (y, h) and the state at the start of every 16-step tile, and saves the
    operands and those checkpoints; the backward hands the kernel the
    output's gradient (and the final state's, which training leaves
    None) and returns the seven operands' gradients."""

    @staticmethod
    def forward(ctx, dt, x, bmat, cmat, a, d_skip, h0):
        ctx.set_materialize_grads(False)
        B, S, di = x.shape
        ckpt = torch.empty((B, _scan_bwd.checkpoints(S), di, a.shape[-1]),
                           dtype=torch.float32, device=x.device)
        y, h = _scan.ssm_scan(dt, x, bmat, cmat, a, d_skip, h0, ckpt=ckpt)
        ctx.save_for_backward(dt, x, bmat, cmat, a, d_skip, h0, ckpt)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        *ops, ckpt = ctx.saved_tensors
        dy = torch.zeros_like(ops[1]) if dy is None else dy.contiguous()
        dh = None if dh is None else dh.contiguous()
        return _scan_bwd.ssm_scan_bwd(*ops, dy, dh, ckpt=ckpt)


def ssm_scan(p: dict, xc: torch.Tensor, state: torch.Tensor, *,
             plain: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The selective-scan recurrence over S.  xc: (B,S,di) post-conv
    activations; state: (B,di,n) float32.  Returns (y in xc's dtype, the
    final state).  CPU tensors run the plain scan; CUDA tensors the
    kernel, through :class:`_KernelScan` where autograd records (nothing
    falls back to the plain scan).  ``plain=True`` runs the plain scan on
    any device, under autograd too: the kernels' oracle on the card."""
    A = -torch.exp(p["a_log"].to(torch.float32))              # (di, n)
    dt, bmat, cmat = _ssm_params(p, xc)
    ops = (dt.contiguous(), xc.to(torch.float32).contiguous(),
           bmat.contiguous(), cmat.contiguous(), A.contiguous(),
           p["d_skip"].to(torch.float32).contiguous(), state.contiguous())
    if plain:
        y, state = _scan.ssm_scan_plain(*ops)
    elif xc.device.type != "cpu" and torch.is_grad_enabled() and any(
            t.requires_grad for t in ops):
        y, state = _KernelScan.apply(*ops)
    else:
        y, state = _scan.ssm_scan(*ops)
    return y.to(xc.dtype), state


def ssm_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
              cache: Optional[SSMCache] = None, decode: bool = False):
    """Full Mamba block.  Returns (out, new_cache): a new ``SSMCache``
    whose conv state is in x's dtype."""
    B, S, _ = x.shape
    dt = x.dtype
    xz = x @ p["in_proj"].to(dt)
    xin, z = torch.chunk(xz, 2, dim=-1)                       # (B,S,di)

    conv_state = cache.conv if cache is not None else None
    xc, new_conv = _causal_conv(p, xin, conv_state)
    xc = F.silu(xc)

    state = (cache.state if cache is not None else
             torch.zeros((B, cfg.d_inner, cfg.ssm_state),
                         dtype=torch.float32, device=x.device))
    if decode:
        # Single-step recurrence (S == 1).
        A = -torch.exp(p["a_log"].to(torch.float32))
        dtv, bv, cv = _ssm_params(p, xc[:, 0])                # (B, di|n)
        x0 = xc[:, 0].to(torch.float32)
        decay = torch.exp(dtv[..., None] * A)
        state = decay * state + (dtv * x0)[..., None] * bv[:, None, :]
        y = torch.einsum("bdn,bn->bd", state, cv)
        y = y + x0 * p["d_skip"].to(torch.float32)
        y = y[:, None].to(dt)
    else:
        y, state = ssm_scan(p, xc, state)

    y = y * F.silu(z)
    out = y @ p["out_proj"].to(dt)
    return out, SSMCache(conv=new_conv, state=state)


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16, *,
                   device) -> SSMCache:
    return SSMCache(
        conv=torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner), dtype=dtype,
                         device=device),
        state=torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                          dtype=torch.float32, device=device),
    )
