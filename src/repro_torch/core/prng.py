"""The slice of ``jax.random`` the simulator draws from, bit for bit.

Threefry-2x32 (Salmon et al., SC'11) in JAX's *partitionable* mode
(``jax_threefry_partitionable``, on by default since jax 0.5): the
counter of element ``i`` of a draw of shape ``s`` is the 64-bit flat
index ``i`` split into two 32-bit words, so a block of shape ``(T, N)``
equals the first ``T`` rows of any taller draw under the same key.

Inside ``with threefry_partitionable(False):`` the draws follow JAX's
original stream instead (the flag off): a draw of ``n`` words hashes
the counter pairs ``(j, j + ceil(n / 2))`` of ``0 .. n - 1`` (the last
one ``(j, 0)`` when ``n`` is odd) and concatenates the two output
words, and ``split`` is such a draw of ``2 * num`` words.  A block is
then no prefix of a taller draw, so ``offset=`` raises there.
``fold_in`` is the same in both streams.

A key is an int64 tensor of shape ``(..., 2)`` holding two 32-bit words.
All arithmetic runs on int64 tensors masked to 32 bits, so it is exact
on every device torch supports.  Keys with leading batch dimensions
draw one block per key in a single batched call.

``normal`` goes through :func:`~repro_torch.core.xla_math.erf_inv`,
XLA's float32 lowering written out op for op, so its draws agree bit
for bit too.
"""
from __future__ import annotations

import contextlib
import contextvars

import numpy as np
import torch

from .._device import resolve_device
from .xla_math import erf_inv

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_PARTITIONABLE = contextvars.ContextVar("threefry_partitionable",
                                        default=True)


@contextlib.contextmanager
def threefry_partitionable(enabled: bool):
    """Draw from the partitionable stream (``True``, the default) or
    from JAX's original one (``False``) inside the ``with`` block, as
    ``jax.threefry_partitionable`` does for ``jax.random``."""
    token = _PARTITIONABLE.set(bool(enabled))
    try:
        yield
    finally:
        _PARTITIONABLE.reset(token)


def partitionable() -> bool:
    """Whether draws follow the partitionable stream here."""
    return _PARTITIONABLE.get()


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> tuple:
    """The Threefry-2x32 hash with 20 rounds (five blocks of four, a key
    injection after each), on broadcastable 32-bit-word tensors."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x0 = (x1 + ks[0]) & _MASK
    x1 = (x2 + ks[1]) & _MASK
    for block in range(5):
        for r in _ROTATIONS[block % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & _MASK
        x1 = (x1 + ks[(block + 2) % 3] + block + 1) & _MASK
    return x0, x1


def PRNGKey(seed: int, *, device="cuda") -> torch.Tensor:
    """The raw threefry key of ``jax.random.PRNGKey(seed)``: the 64-bit
    seed bit-cast into (high word, low word)."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"seed must be in [0, 2**64), got {seed}")
    return torch.tensor([seed >> 32, seed & _MASK], dtype=torch.int64,
                        device=resolve_device(device))


def _hash_counts(key: torch.Tensor, shape: tuple, offset: int = 0) -> tuple:
    """Hash the flat indices ``offset, offset + 1, ...`` of ``shape``
    under every key of ``key`` (shape ``(..., 2)``); returns two word
    tensors of shape ``key.shape[:-1] + shape``."""
    count = 1
    for d in shape:
        count *= int(d)
    flat = torch.arange(offset, offset + count, dtype=torch.int64,
                        device=key.device)
    hi = (flat >> 32).reshape(shape)
    lo = (flat & _MASK).reshape(shape)
    lift = key.shape[:-1] + (1,) * len(shape)
    k1 = key[..., 0].reshape(lift)
    k2 = key[..., 1].reshape(lift)
    return threefry2x32(k1, k2, hi, lo)


def _hash_iota(key: torch.Tensor, count: int) -> torch.Tensor:
    """The original stream's words ``0 .. count - 1`` under every key of
    ``key`` (shape ``(..., 2)``): JAX's ``threefry_2x32`` over an iota,
    which hashes the pairs ``(j, j + h)``, ``h = ceil(count / 2)``,
    padding the last with 0 when ``count`` is odd.  Shape
    ``key.shape[:-1] + (count,)``."""
    if count >= _MASK:
        raise ValueError(f"a draw of {count} words passes the original "
                         f"stream's one-block limit")
    half = (count + 1) // 2
    j = torch.arange(half, dtype=torch.int64, device=key.device)
    pair = j + half
    pair = torch.where(pair < count, pair, 0)
    lift = key.shape[:-1] + (1,)
    y0, y1 = threefry2x32(key[..., 0].reshape(lift),
                          key[..., 1].reshape(lift), j, pair)
    return torch.cat([y0, y1], dim=-1)[..., :count]


def _bits(key: torch.Tensor, shape: tuple, offset: int) -> torch.Tensor:
    """32 random bits per element of ``shape`` under every key, from the
    stream in force."""
    if partitionable():
        bits1, bits2 = _hash_counts(key, shape, offset)
        return bits1 ^ bits2
    if offset:
        raise ValueError("offset= needs the partitionable stream: the "
                         "original one has no prefix property")
    count = 1
    for d in shape:
        count *= d
    return _hash_iota(key, count).reshape(key.shape[:-1] + shape)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``num`` new keys per key, shape
    ``key.shape[:-1] + (num, 2)`` (``(num, 2)`` for one key)."""
    if key.ndim < 1 or key.shape[-1] != 2:
        raise ValueError(f"split takes keys of shape (..., 2), got "
                         f"{tuple(key.shape)}")
    num = int(num)
    if not partitionable():
        return _hash_iota(key, 2 * num).reshape(key.shape[:-1] + (num, 2))
    bits1, bits2 = _hash_counts(key, (num,))
    return torch.stack([bits1, bits2], dim=-1)


def uniform(key: torch.Tensor, shape, minval=0.0, maxval=1.0, *,
            offset: int = 0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: 23 random mantissa bits under
    exponent 0 give a float in [1, 2); minus one, scaled to
    ``[minval, maxval)`` and clamped below at ``minval``.  ``key`` of
    shape ``(..., 2)`` gives a draw of shape ``key.shape[:-1] + shape``.
    ``offset`` draws flat elements ``offset, offset + 1, ...`` of a
    larger draw under the same key: each element hashes its own flat
    index, so a large draw can be made in slices."""
    shape = tuple(int(d) for d in shape)
    mantissa = (_bits(key, shape, offset) >> 9) | 0x3F800000
    u = mantissa.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.as_tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.as_tensor(maxval, dtype=torch.float32, device=key.device)
    # XLA fuses the scale-and-shift into one multiply-add.  The product
    # of two float32 values is exact in float64, so rounding the float64
    # sum once to float32 gives the fused result whenever the sum fits
    # 53 bits — always for minval = 0, the simulator's only use.
    scaled = (u.double() * (hi - lo).double() + lo.double()).to(
        torch.float32)
    return torch.maximum(lo, scaled)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: the threefry hash of the counter pair
    ``(0, data)`` under ``key``; ``data`` is taken as a uint32."""
    data = int(data) & _MASK
    zero = torch.zeros_like(key[..., 0])
    x0, x1 = threefry2x32(key[..., 0], key[..., 1], zero, zero + data)
    return torch.stack([x0, x1], dim=-1)


def bernoulli(key: torch.Tensor, p: float, shape) -> torch.Tensor:
    """``jax.random.bernoulli`` (``mode="low"``): a float32 uniform draw
    below ``p``."""
    return uniform(key, shape) < torch.tensor(p, dtype=torch.float32)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))


def normal(key: torch.Tensor, shape, *, offset: int = 0) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``sqrt(2) * erf_inv(u)`` with
    ``u`` uniform on ``[nextafter(-1, 0), 1)``; ``offset`` as in
    :func:`uniform`."""
    return _SQRT2 * erf_inv(uniform(key, shape, _NORMAL_LO, 1.0,
                                    offset=offset))
