"""The selective scan of the SSM family (Mamba-1), with its ``D`` skip.

Replaces no Pallas kernel: the reference computes it in jnp, a chunked
``lax.associative_scan`` (``src/repro/models/ssm.py:69`` ``ssm_scan``).
It has a hand-written kernel all the same because its plain form on the
card materialises (B, chunk, d_inner, n) float32 tensors, several a
chunk, where a sequential scan in registers moves only its inputs and
outputs.  Over S steps, for every batch row and channel,

    h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t
    y_t = C_t . h_t + D x_t

with dt, x (B, S, d_inner), B_t and C_t (B, S, n), A (d_inner, n), D
(d_inner,) and the start state h0 (B, d_inner, n), all float32; the
result is y (B, S, d_inner) and the final state (B, d_inner, n), float32.

The CUDA kernel (``csrc/ssm_scan.cu``) gives each (batch row, channel)
``lanes`` neighbouring threads, each holding ``n / lanes`` of its states
in registers, and stages tiles of dt, x, B and C in shared memory; the
lane count comes from :func:`scan_plan`, which asks the grid for 1.5
warps for each of the card's 528 schedulers.  Its sums run in another order than the associative scan's
tree: it agrees with the plain version to float32 rounding, not bit for
bit.  The plain version, :func:`ssm_scan_plain`, keeps the reference's
chunks (``min(256, S)`` steps, the whole of S if that does not divide
it) and runs a first-order scan inside each; it is the path for CPU
tensors and the kernel's oracle on the card, and autograd follows it.

This wrapper has no gradient of its own: on the card it refuses operands
that require one while grad is enabled.  The differentiable entry is
``repro_torch.models.ssm.ssm_scan``, whose ``autograd.Function`` has the
kernel write the state at the start of every 16-step tile (``ckpt``)
and differentiates with :mod:`repro_torch.kernels.ssm_scan_bwd`.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import _build

# Kernel launches made by ssm_scan and launch; the plain path never
# counts.
LAUNCHES = 0

# The state widths the kernel holds in registers: the configs' 16 and the
# smoke configs' 8.
STATES = (8, 16)

# A block's threads (csrc/ssm_scan.cu SCAN_THREADS): channels x lanes.
THREADS = 128
# Lanes a channel: each holds n / lanes of its states, at least 2.
LANES = (1, 2, 4, 8)
# The H100's schedulers (4 an SM, 132 SMs), and the warps the plan asks
# of the grid for each of them, on average: fewer leave a scheduler one
# warp or none, whose loads and chains then idle its MUFU; each lane
# beyond the first costs every state-step loads and a shuffle round.
SCHEDULERS = 4 * 132
WARPS_PER_SCHEDULER = 1.5

# dt, x, B, C, A, D, h0, y, h_out, ckpt, then B, S, d_inner, n, lanes,
# stream.
_SIGNATURES = {"ssm_scan_f32": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
               + [ctypes.c_void_p],
               "ssm_scan_smem": [ctypes.c_int] * 2}


def lane_counts(n: int) -> tuple:
    """The lane counts the kernel instantiates at ``n`` states."""
    return tuple(lanes for lanes in LANES if n // lanes >= 2)


@dataclass(frozen=True)
class ScanPlan:
    """A launch of the kernel: ``lanes`` threads a (batch row, channel),
    ``channels`` channels a block of :data:`THREADS`, ``grid`` (blocks
    along d_inner, batch rows)."""
    lanes: int
    channels: int
    grid: tuple

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]

    @property
    def warps_per_scheduler(self) -> float:
        return self.blocks * THREADS / 32 / SCHEDULERS


def plan_for(b: int, d_inner: int, lanes: int) -> ScanPlan:
    """The launch at a given lane count."""
    channels = THREADS // lanes
    return ScanPlan(lanes, channels, (-(-d_inner // channels), b))


def scan_plan(b: int, d_inner: int, n: int) -> ScanPlan:
    """The launch for ``b`` batch rows of ``d_inner`` channels at ``n``
    states: the fewest lanes a channel whose grid has
    :data:`WARPS_PER_SCHEDULER` warps for each scheduler, else the most
    the kernel has at ``n``.  Falcon-Mamba-7B's (4, 8192, 16) takes 1
    lane (256 blocks, 1.94 warps a scheduler), Hymba-1.5B's (4, 3200, 16)
    2 (200 blocks, 1.52)."""
    if n not in STATES:
        raise ValueError(f"ssm_scan holds n in {STATES} states, got {n}")
    counts = lane_counts(n)
    want = WARPS_PER_SCHEDULER * SCHEDULERS * 32
    lanes = next((c for c in counts if b * d_inner * c >= want), counts[-1])
    return plan_for(b, d_inner, lanes)


def ssm_scan_plain(dt: torch.Tensor, x: torch.Tensor, bmat: torch.Tensor,
                   cmat: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor,
                   h0: torch.Tensor, chunk: int = 256) -> tuple:
    """The scan in plain torch, chunk by chunk as the reference runs it:
    each chunk's decays ``exp(dt A)`` and inputs ``(dt x) B`` as (c, B,
    d_inner, n) tensors, a first-order scan over the chunk's steps, then
    ``y = C . h`` for the chunk; ``D x`` is added at the end.  Returns
    ``(y, h)``; autograd follows it."""
    B, S, di = x.shape
    c = min(chunk, S)
    if c == 0 or S % c:
        c = max(S, 1)
    h = h0
    ys = []
    for t0 in range(0, S, c):
        dt_c = dt[:, t0:t0 + c].transpose(0, 1)              # (c, B, di)
        x_c = x[:, t0:t0 + c].transpose(0, 1)
        decay = torch.exp(dt_c[..., None] * a)                # (c, B, di, n)
        inp = (dt_c * x_c)[..., None] * bmat[:, t0:t0 + c].transpose(
            0, 1)[:, :, None, :]
        # The states as a list, stacked: autograd refuses out=.
        hs = []
        for t in range(decay.shape[0]):
            h = torch.addcmul(inp[t], decay[t], h)
            hs.append(h)
        h_seq = torch.stack(hs)
        ys.append(torch.einsum("cbdn,bcn->bcd", h_seq, cmat[:, t0:t0 + c]))
    y = torch.cat(ys, dim=1) if ys else torch.zeros_like(x)
    return y + x * d_skip, h.clone()


def _check(dt, x, bmat, cmat, a, d_skip, h0) -> None:
    if x.dim() != 3:
        raise ValueError(f"ssm_scan needs x (B, S, d_inner), got "
                         f"{tuple(x.shape)}")
    B, S, di = x.shape
    n = a.shape[-1]
    want = {"dt": (dt, (B, S, di)), "B": (bmat, (B, S, n)),
            "C": (cmat, (B, S, n)), "A": (a, (di, n)), "D": (d_skip, (di,)),
            "h0": (h0, (B, di, n))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"ssm_scan: {name} is {tuple(t.shape)}, not "
                             f"{shape} for x {tuple(x.shape)}")
        if t.device != x.device:
            raise ValueError("ssm_scan operands must share one device")


def ssm_scan(dt: torch.Tensor, x: torch.Tensor, bmat: torch.Tensor,
             cmat: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor,
             h0: torch.Tensor, *, ckpt: torch.Tensor | None = None) -> tuple:
    """``(y, h)`` of the selective scan (module docstring).  CUDA tensors
    launch the kernel at :func:`scan_plan`'s lane count (writing the
    checkpoints into ``ckpt`` where given): float32, contiguous, n in
    :data:`STATES`, no operand that requires grad while grad is enabled
    (this wrapper has no gradient; anything else raises); CPU tensors take
    :func:`ssm_scan_plain`, which autograd follows."""
    if x.device.type == "cpu":
        _check(dt, x, bmat, cmat, a, d_skip, h0)
        return ssm_scan_plain(dt, x, bmat, cmat, a, d_skip, h0)
    plan = scan_plan(x.shape[0], x.shape[-1], a.shape[-1])
    return launch(dt, x, bmat, cmat, a, d_skip, h0, plan.lanes, ckpt=ckpt)


def launch(dt: torch.Tensor, x: torch.Tensor, bmat: torch.Tensor,
           cmat: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor,
           h0: torch.Tensor, lanes: int, *,
           ckpt: torch.Tensor | None = None) -> tuple:
    """``(y, h)`` from one launch of the kernel at ``lanes`` lanes a
    channel (what :func:`ssm_scan` runs with :func:`scan_plan`'s count;
    the checks and tests run the others): CUDA operands only, float32,
    contiguous, n in :data:`STATES`.  A lane count the kernel does not
    instantiate at this n (:func:`lane_counts`) raises
    (``cudaErrorInvalidValue``).  ``ckpt``, a contiguous (B, ceil(S /
    16), d_inner, n) float32 tensor, receives the state at the start of
    every 16-step tile, from which :mod:`.ssm_scan_bwd` differentiates."""
    global LAUNCHES
    ops = (dt, x, bmat, cmat, a, d_skip, h0)
    _check(*ops)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ops):
        raise RuntimeError(
            "the ssm_scan kernel wrapper has no gradient of its own: call "
            "repro_torch.models.ssm.ssm_scan (its backward is the "
            "ssm_scan_bwd kernel) or run under torch.no_grad()")
    if x.device.type != "cuda":
        raise ValueError(f"the ssm_scan kernel runs on cuda, not {x.device}")
    if any(t.dtype != torch.float32 for t in ops):
        raise TypeError(f"ssm_scan takes float32 operands, got "
                        f"{[t.dtype for t in ops]}")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("ssm_scan takes contiguous operands")
    B, S, di = x.shape
    n = a.shape[-1]
    if n not in STATES:
        raise ValueError(f"ssm_scan holds n in {STATES} states, got {n}")
    if ckpt is not None and (
            tuple(ckpt.shape) != (B, -(-S // 16), di, n)
            or ckpt.dtype != torch.float32 or ckpt.device != x.device
            or not ckpt.is_contiguous()):
        raise ValueError(f"ssm_scan: ckpt must be a contiguous "
                         f"{(B, -(-S // 16), di, n)} float32 tensor on "
                         f"{x.device}")
    y = torch.empty_like(x)
    h = torch.empty_like(h0)
    lib = _build.load("ssm_scan", _SIGNATURES)
    _build.call(lib, "ssm_scan", lib.ssm_scan_f32, x.device,
                *(t.data_ptr() for t in ops), y.data_ptr(), h.data_ptr(),
                None if ckpt is None else ckpt.data_ptr(), B, S, di, n,
                lanes)
    LAUNCHES += 1
    return y, h
