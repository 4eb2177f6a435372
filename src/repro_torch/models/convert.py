"""Parameters between the two packages: the reference's tree of numpy
arrays (``jax.tree.map(np.asarray, params)``) and the port's dict of
tensors, bit for bit.

JAX's bfloat16 arrays arrive as ``ml_dtypes.bfloat16``, which torch
cannot read: they cross as their ``uint16`` bits, viewed as
``torch.bfloat16`` on the other side.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from .layers import tree_map


def _is_bf16(dtype: np.dtype) -> bool:
    return dtype.name == "bfloat16"


def from_jax_params(tree, *, device="cuda") -> dict:
    """The port's parameter dict (same keys) from a nested dict of numpy
    arrays, on ``device``; bfloat16 leaves keep their bits."""
    dev = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        if _is_bf16(a.dtype):
            bits = torch.from_numpy(np.array(a).view(np.int16))
            return bits.view(torch.bfloat16).to(dev)
        return torch.from_numpy(np.array(a)).to(dev)

    return tree_map(leaf, tree)


def to_numpy(tree) -> dict:
    """The inverse of :func:`from_jax_params`: numpy arrays on the host,
    bfloat16 tensors as ``ml_dtypes.bfloat16`` arrays with the same
    bits."""

    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()

    return tree_map(leaf, tree)

