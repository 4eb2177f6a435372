"""AdamW with the reference's state layouts (port of
``repro.optim.adamw``), on one device.

Memory knobs per ModelConfig:
  * ``master_dtype``  — float32 master copies, or bf16 (update in
    float32 math, store bf16).
  * ``moment_dtype``  — float32 | bfloat16 | int8 (channel-quantized,
    :mod:`.quant`).
  * ``factored_second_moment`` — Adafactor-style rank-1 v for >=2D
    tensors.

The state tree is the reference's: ``{"step": int32 scalar, "params":
...}`` where each parameter's place holds ``{"m": moment, "v": {"full":
moment} | {"row": ..., "col": ...}, "master": float32 copy}`` (``master``
only for a parameter stored below float32 under float32 masters), and an
int8 moment is a :class:`~.quant.QTensor`.  The updates walk the
parameter dict, so a ``QTensor`` is never taken for a leaf of the tree;
:func:`global_norm_sq` sums the leaves in ``jax.tree.leaves``' order
(dict keys sorted), so its float32 sum adds in the reference's order.
The schedule's cosine, the bias corrections' ``pow`` and the square root
are torch's float32 functions, an ulp or so from XLA's at most; the
parity tests state their tolerances.  :func:`update` writes the new
parameters and state into the given tensors, leaf by leaf, where the
reference's train step donates its buffers to XLA: a full-width model's
state is held once, plus one leaf's float32 temporaries.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..models.layers import DTYPES, ParamDef, tree_leaves, tree_map
from . import quant

_MOMENT_DTYPES = {"int8": torch.int8, **DTYPES}


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    master_dtype: str = "float32"
    moment_dtype: str = "float32"
    factored_second_moment: bool = False

    @staticmethod
    def from_model(mcfg, **overrides) -> "OptConfig":
        base = dict(master_dtype=mcfg.master_dtype,
                    moment_dtype=mcfg.moment_dtype,
                    factored_second_moment=mcfg.factored_second_moment)
        base.update(overrides)
        return OptConfig(**base)


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to 10%, float32 (``step`` an integer
    tensor)."""
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.1 + 0.45 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


# --------------------------------------------------------------------------
# Moment storage.
# --------------------------------------------------------------------------

def _store_moment(x: torch.Tensor, dtype: str):
    if dtype == "int8":
        return quant.quantize(x)
    return x.to(_MOMENT_DTYPES[dtype])


def _load_moment(s, dtype: str) -> torch.Tensor:
    if dtype == "int8":
        return quant.dequantize(s)
    return s.to(torch.float32)


def _init_moment(p: torch.Tensor, dtype: str):
    return _store_moment(torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device), dtype)


def _init_v(p: torch.Tensor, cfg: OptConfig):
    shape = tuple(p.shape)
    dims = quant.factored_dims(shape) if cfg.factored_second_moment else None
    if dims is None:
        return {"full": _init_moment(p, cfg.moment_dtype)}
    r, c = dims
    zeros = dict(dtype=torch.float32, device=p.device)
    return {"row": torch.zeros(shape[:r] + (shape[r],), **zeros),
            "col": torch.zeros(shape[:r] + (shape[c],), **zeros)}


def _v_update_and_read(v_state, g2: torch.Tensor, b2: float,
                       cfg: OptConfig):
    """Returns (new_state, dense v estimate)."""
    if "full" in v_state:
        v = _load_moment(v_state["full"], cfg.moment_dtype)
        v = b2 * v + (1 - b2) * g2
        return {"full": _store_moment(v, cfg.moment_dtype)}, v
    row = b2 * v_state["row"] + (1 - b2) * torch.mean(g2, dim=-1)
    col = b2 * v_state["col"] + (1 - b2) * torch.mean(g2, dim=-2)
    mean_row = torch.mean(row, dim=-1, keepdim=True)
    v = (row[..., :, None] * col[..., None, :]
         / torch.clamp_min(mean_row[..., None], 1e-30))
    return {"row": row, "col": col}, v


def _map_params(fn, params, *trees):
    """``fn(leaf, *matching)`` over the parameter dict's leaves, where
    each of ``trees`` holds a value at every parameter's place (a grad,
    or a state dict); the parameter dict's structure kept."""
    if isinstance(params, dict):
        return {k: _map_params(fn, params[k], *(t[k] for t in trees))
                for k in params}
    return fn(params, *trees)


# --------------------------------------------------------------------------
# Public API.
# --------------------------------------------------------------------------

def init(params, cfg: OptConfig) -> Dict[str, Any]:
    """The zero state of ``params`` (a dict of tensors), on their
    device."""
    def leaf(p):
        state = {"m": _init_moment(p, cfg.moment_dtype),
                 "v": _init_v(p, cfg)}
        if cfg.master_dtype == "float32" and p.dtype != torch.float32:
            state["master"] = p.to(torch.float32)
        return state

    device = tree_leaves(params)[0].device
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "params": _map_params(leaf, params)}


def _drop_dim(d: ParamDef, dim: int, dtype: str) -> ParamDef:
    """ParamDef for a tensor that removes one dim of ``d`` (scales,
    factored moments): shardings shift accordingly."""
    fsdp = d.fsdp_dim
    if fsdp is not None:
        fsdp = None if fsdp == dim else (fsdp - 1 if fsdp > dim else fsdp)
    return ParamDef(shape=d.shape[:dim] + d.shape[dim + 1:],
                    tp=d.tp[:dim] + d.tp[dim + 1:],
                    fsdp_dim=fsdp, dtype=dtype, init="zeros")


def state_defs(param_def_tree, cfg: OptConfig):
    """ParamDef mirror of :func:`init`'s state tree (an int8 moment a
    ``QTensor`` of ParamDefs), as the reference's."""

    def _moment_def(d: ParamDef):
        if cfg.moment_dtype == "int8":
            return quant.QTensor(
                q=dataclasses.replace(d, dtype="int8", init="zeros"),
                scale=_drop_dim(d, len(d.shape) - 1, "float32")
                if d.shape else dataclasses.replace(d, dtype="float32",
                                                    init="zeros"))
        return dataclasses.replace(d, dtype=cfg.moment_dtype, init="zeros")

    def leaf(d: ParamDef):
        nd = len(d.shape)
        state = {"m": _moment_def(d)}
        if cfg.factored_second_moment and nd >= 2:
            state["v"] = {"row": _drop_dim(d, nd - 1, "float32"),
                          "col": _drop_dim(d, nd - 2, "float32")}
        else:
            state["v"] = {"full": _moment_def(d)}
        if cfg.master_dtype == "float32" and d.dtype != "float32":
            state["master"] = dataclasses.replace(d, dtype="float32")
        return state

    return {"step": ParamDef((), (), fsdp_dim=None, dtype="int32",
                             init="zeros"),
            "params": tree_map(leaf, param_def_tree)}


def global_norm_sq(grads) -> torch.Tensor:
    """The float32 sum of every leaf's float32 sum of squares, leaves in
    sorted-key order."""
    return sum(torch.sum(torch.square(g.to(torch.float32)))
               for g in tree_leaves(grads))


def _write(dst, src) -> None:
    """Copy a stored moment (a tensor or a ``QTensor``) into ``dst``."""
    if isinstance(dst, quant.QTensor):
        dst.q.copy_(src.q)
        dst.scale.copy_(src.scale)
    else:
        dst.copy_(src)


def update(grads, state, params, cfg: OptConfig, *,
           norm_sq: Optional[torch.Tensor] = None
           ) -> Tuple[Any, Dict[str, Any]]:
    """One AdamW step, written in place into ``params`` and ``state``
    (which must not require grad), which it returns; the values are the
    reference's ``update``'s.  ``norm_sq`` is the global squared grad norm
    (:func:`global_norm_sq` of ``grads`` if omitted)."""
    state["step"].add_(1)
    step = state["step"]
    lr = schedule(cfg, step)
    if norm_sq is None:
        norm_sq = global_norm_sq(grads)
    clip = torch.clamp_max(cfg.clip_norm
                           / torch.clamp_min(torch.sqrt(norm_sq), 1e-12),
                           1.0)
    bc1 = 1 - cfg.b1 ** step.to(torch.float32)
    bc2 = 1 - cfg.b2 ** step.to(torch.float32)

    def leaf(p, g, s):
        g = g.to(torch.float32) * clip
        m = _load_moment(s["m"], cfg.moment_dtype)
        m = cfg.b1 * m + (1 - cfg.b1) * g
        new_v_state, v = _v_update_and_read(s["v"], torch.square(g),
                                            cfg.b2, cfg)
        upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        master = s.get("master", p).to(torch.float32)
        master = master - lr * (upd + cfg.weight_decay * master)
        _write(s["m"], _store_moment(m, cfg.moment_dtype))
        for k, v in new_v_state.items():
            _write(s["v"][k], v)
        if "master" in s:
            s["master"].copy_(master)
        p.copy_(master.to(p.dtype))

    _map_params(leaf, params, grads, state["params"])
    return params, state
