"""The selective scan's gradient (the SSM family's training on the card).

Replaces no Pallas kernel: the reference differentiates its jnp chunked
scan (``src/repro/models/ssm.py:69`` ``ssm_scan``) with JAX's autodiff,
and on the card the port's forward is the hand-written kernel of
:mod:`repro_torch.kernels.ssm_scan`, so its gradient is a kernel too.
Given the forward's operands dt, x (B, S, d_inner), B_t, C_t (B, S, n), A
(d_inner, n), D (d_inner,), the start state h0 (B, d_inner, n), the
output's gradient dy (B, S, d_inner) and the final state's (B, d_inner, n;
None for zeros, as in training, which never reads the final state), it
returns the seven gradients ``(d(dt), dx, dB, dC, dA, dD, dh0)``, all
float32, in the operands' order.

The CUDA kernel (``csrc/ssm_scan_bwd.cu``) walks each (batch row,
channel)'s steps in reverse over 16-step tiles: the forward writes the
state at the start of every tile (``ckpt``, (B, ceil(S / 16), d_inner, n),
:func:`checkpoints` tiles) when autograd records, and the backward
recomputes a tile's states from it into shared memory before walking
the tile backwards, ``lanes`` threads a channel as the forward (the lane
count of :func:`bwd_plan`).  dB and dC, which sum over every channel, and
dA and dD, which sum over batch rows and time, go through per-block
partial sums and a second launch that adds them in a fixed order: no
atomics, so two runs give the same bits.  The plain version,
:func:`ssm_scan_bwd_plain`, is autograd through
:func:`repro_torch.kernels.ssm_scan.ssm_scan_plain`: the path for CPU
tensors and the kernel's oracle on the card.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import _build
from .ssm_scan import STATES, THREADS, _check, lane_counts, scan_plan, \
    ssm_scan_plain

# Calls of ssm_scan_bwd that launched the kernels (the walk and the sums:
# one count); the plain path never counts.
LAUNCHES = 0

# Steps a tile: the forward's checkpoint interval (csrc/ssm_scan.cu,
# csrc/ssm_scan_bwd.cu STEPS).
STEPS = 16

# dt, x, B, C, A, D, ckpt, dy, dh_T, then the seven gradients, the four
# partial sums, then B, S, d_inner, n, lanes, stream.
_SIGNATURES = {"ssm_scan_bwd_f32": [ctypes.c_void_p] * 20
               + [ctypes.c_int] * 5 + [ctypes.c_void_p],
               "ssm_scan_bwd_smem": [ctypes.c_int] * 2}


def checkpoints(s: int) -> int:
    """The forward's checkpoints over ``s`` steps: one a 16-step tile."""
    return -(-s // STEPS)


@dataclass(frozen=True)
class ScanBwdPlan:
    """A launch of the backward: ``lanes`` threads a (batch row, channel),
    ``channels`` a block of :data:`THREADS`, ``grid`` (blocks along
    d_inner, whose dB and dC partial sums the second launch adds, and
    batch rows); ``checkpoints`` states a (batch row, channel) from the
    forward."""
    lanes: int
    channels: int
    grid: tuple
    checkpoints: int


def bwd_plan(b: int, s: int, d_inner: int, n: int,
             lanes: int | None = None) -> ScanBwdPlan:
    """The backward's launch for ``b`` batch rows of ``s`` steps and
    ``d_inner`` channels at ``n`` states: the forward's lane count
    (:func:`~repro_torch.kernels.ssm_scan.scan_plan`: at one batch row 4
    lanes at Falcon-Mamba-7B's 8192 channels, 8 at Hymba-1.5B's 3200) or
    ``lanes``, one of :func:`~repro_torch.kernels.ssm_scan.lane_counts`."""
    if lanes is None:
        lanes = scan_plan(b, d_inner, n).lanes
    if n not in STATES or lanes not in lane_counts(n):
        raise ValueError(f"ssm_scan_bwd: {lanes} lanes at n = {n}; the "
                         f"kernel holds n in {STATES} at lanes "
                         f"{lane_counts(n) if n in STATES else ()}")
    channels = THREADS // lanes
    return ScanBwdPlan(lanes, channels, (-(-d_inner // channels), b),
                       checkpoints(s))


def ssm_scan_bwd_plain(dt, x, bmat, cmat, a, d_skip, h0, dy,
                       dh=None) -> tuple:
    """``(d(dt), dx, dB, dC, dA, dD, dh0)`` from autograd through
    :func:`~repro_torch.kernels.ssm_scan.ssm_scan_plain` in float32."""
    ops = [t.detach().to(torch.float32).requires_grad_(True)
           for t in (dt, x, bmat, cmat, a, d_skip, h0)]
    with torch.enable_grad():
        y, h = ssm_scan_plain(*ops)
        outs, grads = [y], [dy.to(torch.float32)]
        if dh is not None:
            outs.append(h)
            grads.append(dh.to(torch.float32))
        return torch.autograd.grad(outs, ops, grads, allow_unused=True,
                                   materialize_grads=True)


def ssm_scan_bwd(dt: torch.Tensor, x: torch.Tensor, bmat: torch.Tensor,
                 cmat: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor,
                 h0: torch.Tensor, dy: torch.Tensor,
                 dh: torch.Tensor | None = None, *,
                 ckpt: torch.Tensor | None = None,
                 lanes: int | None = None) -> tuple:
    """The scan's seven gradients (module docstring).  CUDA tensors launch
    the kernels at :func:`bwd_plan`'s lane count (or ``lanes``) from the
    forward's checkpoints ``ckpt`` ((B, :func:`checkpoints`, d_inner, n),
    ``ssm_scan.launch(..., ckpt=)``): float32, contiguous, n in
    :data:`~repro_torch.kernels.ssm_scan.STATES`; anything else raises.
    CPU tensors take :func:`ssm_scan_bwd_plain`, which needs no
    checkpoints."""
    global LAUNCHES
    _check(dt, x, bmat, cmat, a, d_skip, h0)
    B, S, di = x.shape
    n = a.shape[-1]
    if tuple(dy.shape) != (B, S, di) or (
            dh is not None and tuple(dh.shape) != (B, di, n)):
        raise ValueError(f"ssm_scan_bwd: dy must be {(B, S, di)} and dh "
                         f"{(B, di, n)}")
    if x.device.type == "cpu":
        return ssm_scan_bwd_plain(dt, x, bmat, cmat, a, d_skip, h0, dy, dh)
    if x.device.type != "cuda":
        raise ValueError(f"the ssm_scan_bwd kernel runs on cuda, not "
                         f"{x.device}")
    plan = bwd_plan(B, S, di, n, lanes)
    ops = [dt, x, bmat, cmat, a, d_skip, dy] + ([] if dh is None else [dh])
    if ckpt is None or tuple(ckpt.shape) != (B, plan.checkpoints, di, n):
        raise ValueError(f"ssm_scan_bwd needs the forward's checkpoints "
                         f"{(B, plan.checkpoints, di, n)}")
    ops.append(ckpt)
    if any(t.device != x.device for t in ops):
        raise ValueError("ssm_scan_bwd operands must share one device")
    if any(t.dtype != torch.float32 for t in ops):
        raise TypeError(f"ssm_scan_bwd takes float32 operands, got "
                        f"{[t.dtype for t in ops]}")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("ssm_scan_bwd takes contiguous operands")
    grads = [torch.empty_like(t) for t in (dt, x, bmat, cmat, a, d_skip, h0)]
    f32 = dict(dtype=torch.float32, device=x.device)
    parts = (torch.empty((plan.grid[0], B, S, n), **f32),
             torch.empty((plan.grid[0], B, S, n), **f32),
             torch.empty((B, di, n), **f32), torch.empty((B, di), **f32))
    if B == 0:
        for g in grads:
            g.zero_()
        return tuple(grads)
    lib = _build.load("ssm_scan_bwd", _SIGNATURES)
    _build.call(lib, "ssm_scan_bwd", lib.ssm_scan_bwd_f32, x.device,
                *(t.data_ptr() for t in (dt, x, bmat, cmat, a, d_skip, ckpt,
                                         dy)),
                None if dh is None else dh.data_ptr(),
                *(g.data_ptr() for g in grads),
                *(p.data_ptr() for p in parts), B, S, di, n, plan.lanes)
    LAUNCHES += 1
    return tuple(grads)
