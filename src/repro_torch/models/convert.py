"""Parameters and decode caches between the two packages, bit for bit:
the reference's tree of numpy arrays (``jax.tree.map(np.asarray,
params)``, the MoE configs' float32 router and DeepSeek's ``mtp``
subtree included) and the port's dict of tensors; a cache tree
(``{"layers": ..., "dense_layers": ...}`` whose entries are the
reference's ``KVCache``, ``MLACache`` or ``SSMCache`` of numpy arrays,
or the hybrid family's dict ``{"attn": KVCache, "ssm": SSMCache}``) and
the port's caches of the same names; an optimizer state (``{"step",
"params"}``, its int8 moments ``QTensor``s of ``q`` and ``scale``, its
factored second moments and float32 masters) and the port's.

JAX's bfloat16 arrays arrive as ``ml_dtypes.bfloat16``, which torch
cannot read: they cross as their ``uint16`` bits, viewed as
``torch.bfloat16`` on the other side.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..optim.quant import QTensor
from .attention import KVCache
from .layers import tree_map
from .mla import MLACache
from .ssm import SSMCache

# The port's cache types by the reference's class names.
CACHE_TYPES = {"KVCache": KVCache, "MLACache": MLACache,
               "SSMCache": SSMCache}


def _is_bf16(dtype: np.dtype) -> bool:
    return dtype.name == "bfloat16"


def _to_tensor(a, dev) -> torch.Tensor:
    a = np.asarray(a)
    if _is_bf16(a.dtype):
        bits = torch.from_numpy(np.array(a).view(np.int16))
        return bits.view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a)).to(dev)


def _to_array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def from_jax_params(tree, *, device="cuda") -> dict:
    """The port's parameter dict (same keys) from a nested dict of numpy
    arrays, on ``device``; bfloat16 leaves keep their bits."""
    dev = resolve_device(device)
    return tree_map(lambda a: _to_tensor(a, dev), tree)


def to_numpy(tree) -> dict:
    """The inverse of :func:`from_jax_params`: numpy arrays on the host,
    bfloat16 tensors as ``ml_dtypes.bfloat16`` arrays with the same
    bits."""
    return tree_map(_to_array, tree)


def caches_from_jax(tree, *, device="cuda") -> dict:
    """The port's caches from the reference's cache tree (its cache
    NamedTuples, or a hybrid stack's dict of them, of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, caches)``), on ``device``, bit for bit."""
    dev = resolve_device(device)

    def one(c):
        if isinstance(c, dict):
            return {k: one(v) for k, v in c.items()}
        return CACHE_TYPES[type(c).__name__](*(_to_tensor(a, dev)
                                                for a in c))

    return {name: one(c) for name, c in tree.items()}


def caches_to_numpy(caches) -> dict:
    """The port's cache tree as ``{name: {field: numpy array}}`` (a hybrid
    stack as ``{name: {"attn": {...}, "ssm": {...}}}``), bf16 as
    ``ml_dtypes.bfloat16`` with the same bits."""
    def one(c):
        if isinstance(c, dict):
            return {k: one(v) for k, v in c.items()}
        return {f: _to_array(t) for f, t in c._asdict().items()}

    return {name: one(c) for name, c in caches.items()}


def _opt_leaves(tree, fn):
    """``fn`` over an optimizer state's arrays: dicts and ``QTensor``s (the
    reference's, or the port's) kept as nodes, a ``QTensor`` of either
    package coming out as the port's."""
    if isinstance(tree, dict):
        return {k: _opt_leaves(v, fn) for k, v in tree.items()}
    if type(tree).__name__ == "QTensor":
        return QTensor(*(fn(a) for a in tree))
    return fn(tree)


def opt_state_from_jax(tree, *, device="cuda") -> dict:
    """The port's optimizer state (``repro_torch.optim.init``'s layout)
    from the reference's (``jax.tree.map(np.asarray, opt_state)``: the
    ``step`` scalar, and each parameter's ``m``, ``v`` and ``master``), on
    ``device``, bit for bit."""
    dev = resolve_device(device)
    return _opt_leaves(tree, lambda a: _to_tensor(a, dev))


def opt_state_to_numpy(state) -> dict:
    """The inverse of :func:`opt_state_from_jax`: the same tree of numpy
    arrays (a ``QTensor`` of numpy arrays for an int8 moment), bf16 as
    ``ml_dtypes.bfloat16`` with the same bits."""
    return _opt_leaves(state, _to_array)
