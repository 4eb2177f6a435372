"""Channel-wise int8 quantization for optimizer moments (port of
``repro.optim.quant``).

Adam moments stored as int8 with one float32 scale per *channel* (all but
the last dim), cutting optimizer-state memory from 4 to about 1 byte a
parameter.  The scale tensor is the parameter's shape minus its last
dim.  :func:`quantize` gives the reference's bits: float32 division by
the scale, rounding half to even (``torch.round``, as ``jnp.round``), a
clip to [-127, 127].
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class QTensor(NamedTuple):
    q: torch.Tensor       # int8, original shape
    scale: torch.Tensor   # float32, shape[:-1]


def quantize(x: torch.Tensor) -> QTensor:
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1) if x.dim() else xf.abs()
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    q = torch.clamp(torch.round(xf / scale[..., None] if x.dim()
                                else xf / scale), -127, 127)
    return QTensor(q=q.to(torch.int8), scale=scale)


def dequantize(t: QTensor) -> torch.Tensor:
    qf = t.q.to(torch.float32)
    return qf * (t.scale[..., None] if t.q.dim() else t.scale)


def factored_dims(shape: Tuple[int, ...]):
    """Adafactor-style factoring: the two trailing dims of a >=2D
    tensor (None for scalars/vectors)."""
    if len(shape) < 2:
        return None
    return len(shape) - 2, len(shape) - 1
