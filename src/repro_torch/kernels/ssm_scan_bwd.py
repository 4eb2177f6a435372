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

The CUDA kernels (``csrc/ssm_scan_bwd.cu``) walk each (batch row,
channel)'s steps in reverse over 16-step tiles: the forward writes the
state at the start of every tile (``ckpt``, (B, ceil(S / 16), d_inner, n),
:func:`checkpoints` tiles) when autograd records, and the backward
recomputes a tile's states from it into registers before walking the
tile backwards, n / :data:`LANE_STATES` threads a channel.  The sequence
is cut into chunks of :func:`bwd_plan`'s ``chunk`` steps, walked in
parallel: the carry a chunk hands the one before is linear in the carry
it receives, so a pre-pass writes each chunk's outgoing carry from a zero
one and its decays' product, and each walk folds the later chunks' into
its own incoming carry, last chunk first.  dB and dC, which sum over every
channel, and dA and dD, which sum over chunks, batch rows and time, go
through per-block partial sums and a last launch that adds them in a
fixed order: no atomics, so two runs give the same bits.  The plain
version, :func:`ssm_scan_bwd_plain`, is autograd through
:func:`repro_torch.kernels.ssm_scan.ssm_scan_plain`: the path for CPU
tensors and the kernel's oracle on the card.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import _build
from .ssm_scan import STATES, THREADS, _check, ssm_scan_plain

# Calls of ssm_scan_bwd that launched the kernels (the pre-pass, the walk
# and the sums: one count); the plain path never counts.
LAUNCHES = 0

# Steps a tile: the forward's checkpoint interval (csrc/ssm_scan.cu,
# csrc/ssm_scan_bwd.cu STEPS).
STEPS = 16
# States a pre-pass thread (csrc/ssm_scan_bwd.cu PRE_STATES): a pre-pass
# block holds 128 / (n / 8) channels.
PRE_STATES = 8
# States a walk lane (csrc/ssm_scan_bwd.cu LANE_STATES): n / 4 lanes a
# channel, the fewest whose recomputed history fits registers.
LANE_STATES = 4
# The chunk lengths the plan picks from, in steps (whole tiles each).
CHUNK_STEPS = (64, 128, 256, 512, 1024)
# Walk blocks the plan asks of the grid: the longest chunk whose grid has
# this many, else the shortest.  About two waves of the walk at 4 lanes
# (128 registers a thread: 4 blocks on each of the 132 SMs), the fastest
# of CHUNK_STEPS at both training shapes (kernel_times.py on the H100).
TARGET_BLOCKS = 1024

# dt, x, B, C, A, D, ckpt, dy, dh_T, then the seven gradients, the four
# partial sums, the chunks' carries and decay products, then B, S,
# d_inner, n, chunk, stream.
_SIGNATURES = {"ssm_scan_bwd_f32": [ctypes.c_void_p] * 22
               + [ctypes.c_int] * 5 + [ctypes.c_void_p],
               "ssm_scan_bwd_smem": [ctypes.c_int]}


def checkpoints(s: int) -> int:
    """The forward's checkpoints over ``s`` steps: one a 16-step tile."""
    return -(-s // STEPS)


def chunk_count(s: int, chunk: int) -> int:
    """Chunks of ``chunk`` steps over ``s`` steps: at least one."""
    return max(1, -(-s // chunk))


@dataclass(frozen=True)
class ScanBwdPlan:
    """A launch of the backward: ``lanes`` threads a (batch row, channel),
    ``channels`` a walk block of :data:`THREADS`, ``chunk`` steps a chunk
    over ``chunks`` chunks, the walk's ``grid`` (blocks along d_inner,
    whose dB and dC partial sums the last launch adds; chunks; batch
    rows), the pre-pass's ``prepass_grid`` (blocks of ``prepass_channels``
    along d_inner; the chunks but the first; batch rows; no launch at one
    chunk) and ``checkpoints`` states a (batch row, channel) from the
    forward."""
    lanes: int
    channels: int
    chunk: int
    chunks: int
    grid: tuple
    prepass_channels: int
    prepass_grid: tuple
    checkpoints: int

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def bwd_plan(b: int, s: int, d_inner: int, n: int,
             chunk: int | None = None) -> ScanBwdPlan:
    """The backward's launch for ``b`` batch rows of ``s`` steps and
    ``d_inner`` channels at ``n`` states: n / :data:`LANE_STATES` lanes
    (4 at n = 16, 2 at n = 8; the chunks, not the lanes, fill the card);
    the longest chunk of :data:`CHUNK_STEPS` whose walk has
    :data:`TARGET_BLOCKS` blocks, else the shortest, or ``chunk`` steps
    (a positive multiple of 16).  Falcon-Mamba-7B's training micro-batch
    (1, 2048, 8192, 16) takes chunks of 512 steps, Hymba-1.5B's (1, 2048,
    3200, 16) 128."""
    if n not in STATES:
        raise ValueError(f"ssm_scan_bwd: n = {n}; the kernel holds n in "
                         f"{STATES}")
    lanes = n // LANE_STATES
    channels = THREADS // lanes
    blocks_x = -(-d_inner // channels)
    if chunk is None:
        chunk = next((c for c in CHUNK_STEPS[::-1]
                      if blocks_x * chunk_count(s, c) * b >= TARGET_BLOCKS),
                     CHUNK_STEPS[0])
    if chunk <= 0 or chunk % STEPS:
        raise ValueError(f"ssm_scan_bwd: a chunk of {chunk} steps; it "
                         f"takes a positive multiple of {STEPS}")
    chunks = chunk_count(s, chunk)
    pre = THREADS // (n // PRE_STATES)
    return ScanBwdPlan(lanes, channels, chunk, chunks,
                       (blocks_x, chunks, b), pre,
                       (-(-d_inner // pre), chunks - 1, b), checkpoints(s))


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
                 chunk: int | None = None) -> tuple:
    """The scan's seven gradients (module docstring).  CUDA tensors launch
    the kernels at :func:`bwd_plan`'s chunk length (or ``chunk``) from the forward's checkpoints ``ckpt`` ((B,
    :func:`checkpoints`, d_inner, n), ``ssm_scan.launch(..., ckpt=)``):
    float32, contiguous, n in :data:`~repro_torch.kernels.ssm_scan.STATES`;
    anything else raises.  CPU tensors take :func:`ssm_scan_bwd_plain`,
    which needs no checkpoints."""
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
    plan = bwd_plan(B, S, di, n, chunk)
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
    k = plan.chunks
    parts = (torch.empty((plan.grid[0], B, S, n), **f32),
             torch.empty((plan.grid[0], B, S, n), **f32),
             torch.empty((k, B, di, n), **f32), torch.empty((k, B, di), **f32),
             torch.empty((B, k, di, n), **f32),
             torch.empty((B, k, di, n), **f32))
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
                *(p.data_ptr() for p in parts), B, S, di, n, plan.chunk)
    LAUNCHES += 1
    return tuple(grads)
