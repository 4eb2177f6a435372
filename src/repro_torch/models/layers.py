"""Shared building blocks (port of ``repro.models.layers``): parameter
registry, norms, rotary embeddings and MLP variants.

Parameters are declared as :class:`ParamDef` trees (nested dicts)
carrying shape, dtype, the tensor-parallel spec and the FSDP dimension,
as in the reference, so both packages read one registry; the port runs
on one device and uses neither sharding field.  The reference's
``constrain`` (a sharding constraint that is a no-op without a mesh) is
dropped: on one device it does nothing.

:func:`init_tree` gives the reference's weights bit for bit: it walks
the leaves in ``jax.tree.flatten``'s order (dict keys sorted,
recursively), splits the key as ``jax.random.split`` does, and draws
each leaf through the port's threefry ``normal``, in slices for the
large leaves.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..core import prng, xla_math

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# Elements drawn at a time when a leaf is initialized: the threefry hash
# and erf_inv hold about ten 8-byte temporaries per element, so a slice
# takes about 5 GB on the card.  The largest full-width leaf has 1.8 G
# elements.
INIT_SLICE = 1 << 26


# ---------------------------------------------------------------------------
# Trees: nested dicts whose leaves are anything else.
# ---------------------------------------------------------------------------

def tree_items(tree, prefix: str = "") -> list:
    """``[(path, leaf)]`` in ``jax.tree.flatten``'s order: dict keys
    sorted, depth first; a path joins keys with dots."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out += tree_items(tree[k], f"{prefix}.{k}" if prefix else k)
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_items(tree)]


def tree_map(fn, tree):
    """``fn`` applied to every leaf, the dict structure kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------------------
# Parameter registry.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParamDef:
    """Declaration of one parameter tensor."""

    shape: Tuple[int, ...]
    tp: Tuple[Optional[str], ...]      # "model" on TP-sharded dims
    fsdp_dim: Optional[int] = 0        # dim the data-axis shard lives on
    dtype: str = "bfloat16"
    init: str = "normal"               # normal | zeros | ones | ssm_a | ssm_dt
    scale: float = 1.0                 # multiplier on the fan-in init

    def __post_init__(self):
        assert len(self.tp) == len(self.shape), (self.shape, self.tp)
        if self.fsdp_dim is not None:
            assert 0 <= self.fsdp_dim < len(self.shape)


def stacked(d: ParamDef, n_layers: int) -> ParamDef:
    """Stack a per-layer def along a leading layer axis."""
    return dataclasses.replace(
        d, shape=(n_layers,) + d.shape, tp=(None,) + d.tp,
        fsdp_dim=None if d.fsdp_dim is None else d.fsdp_dim + 1)


def init_param(key: torch.Tensor, d: ParamDef) -> torch.Tensor:
    """One leaf on ``key``'s device: ``normal(key, shape) * float32(std)``
    rounded to the leaf's dtype (to nearest even for bf16), with ``std =
    scale * fan_in ** -0.5``; or zeros or ones; or the SSM family's
    ``ssm_a``/``ssm_dt`` (:func:`_ssm_a`, :func:`_ssm_dt`)."""
    dtype = DTYPES[d.dtype]
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=key.device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=key.device)
    if d.init == "ssm_a":
        return _ssm_a(d.shape, key.device).to(dtype)
    if d.init == "ssm_dt":
        return _ssm_dt(key, d.shape).to(dtype)
    fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
    std = float(np.float32(d.scale * (fan_in ** -0.5)))
    out = torch.empty(d.shape, dtype=dtype, device=key.device)
    flat = out.view(-1)
    for start in range(0, flat.numel(), INIT_SLICE):
        stop = min(flat.numel(), start + INIT_SLICE)
        z = prng.normal(key, (stop - start,), offset=start)
        flat[start:stop] = (z * std).to(dtype)
    return out


def _ssm_a(shape, device) -> torch.Tensor:
    """Mamba-1's A matrix stored as ``log(-A)``: XLA's float32 ``log`` of
    ``1 .. n`` along the last axis, broadcast over the channels."""
    n = shape[-1]
    a = torch.arange(1, n + 1, dtype=torch.float32, device=device)
    return torch.broadcast_to(xla_math._log(a), shape)


def _ssm_dt(key: torch.Tensor, shape) -> torch.Tensor:
    """The dt bias that starts ``softplus(dt)`` in [1e-3, 1e-1]: ``u +
    log(-expm1(-u))`` with ``u = uniform(key, shape, 1e-3, 1e-1)``, in
    XLA's float32 steps (the uniform's scale-and-shift one fused
    multiply-add, ``log`` and ``expm1`` its polynomials)."""
    lo, hi = (torch.tensor(v, dtype=torch.float32, device=key.device)
              for v in (1e-3, 1e-1))
    u = torch.maximum(lo, xla_math._fma(prng.uniform(key, shape), hi - lo,
                                        lo))
    return u + xla_math._log(-xla_math.expm1(-u))


def init_tree(key: torch.Tensor, defs) -> dict:
    """Initialize a full ParamDef tree deterministically: one key of
    ``split(key, n_leaves)`` per leaf, in flatten order."""
    items = tree_items(defs)
    keys = prng.split(key, len(items))
    flat = {path: init_param(keys[i], d)
            for i, (path, d) in enumerate(items)}
    return _unflatten(defs, flat)


def _unflatten(tree, flat: dict, prefix: str = ""):
    """``tree``'s dict structure with each leaf replaced by ``flat``'s
    value at its dotted path.  A module-level function, not a recursive
    closure: such a closure holds itself and ``flat`` in a reference
    cycle, which kept every weight alive after the caller dropped them,
    until the garbage collector happened to run."""
    if not isinstance(tree, dict):
        return flat[prefix]
    return {k: _unflatten(v, flat, f"{prefix}.{k}" if prefix else k)
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Norms / activations / rotary embeddings.
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * weight.to(torch.float32)).to(dtype)


def swiglu(gate_up: torch.Tensor) -> torch.Tensor:
    gate, up = torch.chunk(gate_up, 2, dim=-1)
    return torch.nn.functional.silu(gate) * up


def relu2(h: torch.Tensor) -> torch.Tensor:
    """Squared ReLU (Nemotron-4)."""
    r = torch.relu(h)
    return r * r


def rope_freqs(head_dim: int, theta: float, *,
               device="cpu") -> torch.Tensor:
    """``1 / theta ** (2i / head_dim)`` in float32.  The reference's
    ``pow`` is the C library's ``powf`` under XLA; torch's may differ by
    an ulp, which the float32 tolerances absorb.  ``theta`` goes to the
    kernel as a scalar argument, not as a tensor copied to the device
    (such a copy waits for the device)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(float(theta), exps)


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim: int, theta: float,
                   device: torch.device) -> torch.Tensor:
    """:func:`rope_freqs`, built once per (head_dim, theta, device)."""
    return rope_freqs(head_dim, theta, device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = _rope_freqs_on(d, theta, x.device)               # (D/2,)
    angles = positions[..., :, None, None].to(torch.float32) * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)           # (..., S, 1, D/2)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP.
# ---------------------------------------------------------------------------

def mlp_defs(d_model: int, d_ff: int, act: str) -> dict:
    if act == "swiglu":
        return {
            "w_in": ParamDef((d_model, 2 * d_ff), (None, "model")),
            "w_out": ParamDef((d_ff, d_model), ("model", None), fsdp_dim=1),
        }
    if act == "relu2":
        return {
            "w_in": ParamDef((d_model, d_ff), (None, "model")),
            "w_out": ParamDef((d_ff, d_model), ("model", None), fsdp_dim=1),
        }
    raise ValueError(f"unknown activation {act!r}")


def mlp_apply(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    h = x @ p["w_in"].to(x.dtype)
    h = swiglu(h) if act == "swiglu" else relu2(h)
    return h @ p["w_out"].to(x.dtype)
