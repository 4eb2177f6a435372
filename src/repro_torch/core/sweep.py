"""Design-space sweeps over barrier schedules and arrival scatters (port
of ``repro.core.sweep``, single device).

The paper's Fig. 4 result is a sweep: barrier schedule x arrival
scatter x Monte-Carlo trial.  Every schedule over one cluster shares a
padded :class:`~repro_torch.core.barrier.LevelTable` shape, so the
whole grid is one batched call of a simulator core, with the stacked
tables broadcast over the (delay, trial) batch.

* :func:`sweep_schedules` — any stack of same-``n_pes`` schedules x
  uniform-scatter delays x trials.  The per-delay arrivals are
  ``uniform_arrivals`` bit for bit (``uniform(0, d) == d * uniform(0,
  1)`` under one key).
* :func:`sweep_barrier` — the Fig. 4 grid over the uniform radices.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from .._device import resolve_device
from . import barrier, barrier_sim, prng
from .barrier import LevelTable
from .barrier_sim import BarrierResult, core_fn
from .topology import DEFAULT, TeraPoolConfig


class SweepResult(NamedTuple):
    """Per-point results over a (schedule, delay, trial) grid.  Every
    tensor field is ``(n_schedules, n_delays, n_trials)``; ``schedules``
    and ``delays`` echo the grid axes."""

    schedules: tuple              # tuple[BarrierSchedule], length S
    delays: torch.Tensor          # (D,) float32
    exit_time: torch.Tensor       # (S, D, T)
    last_arrival: torch.Tensor    # (S, D, T)
    span_cycles: torch.Tensor     # (S, D, T)
    mean_residency: torch.Tensor  # (S, D, T)
    energy: torch.Tensor          # (S, D, T) episode energy, pJ
    completed: torch.Tensor       # (S, D, T) bool
    abandoned_pes: torch.Tensor   # (S, D, T) int32
    timed_out_levels: torch.Tensor  # (S, D, T) int32

    @property
    def radices(self) -> torch.Tensor:
        """(S,) uniform radix per schedule (0 where mixed-radix)."""
        return torch.tensor([s.radix for s in self.schedules],
                            dtype=torch.int32, device=self.delays.device)

    @property
    def names(self) -> tuple:
        """Canonical schedule names, e.g. ``("2x8x8x8", "32x32")``."""
        return tuple(barrier.schedule_name(s) for s in self.schedules)

    @property
    def mean_span(self) -> torch.Tensor:
        """(S, D) Fig. 4a metric, averaged over trials."""
        return self.span_cycles.mean(dim=-1)

    @property
    def mean_residency_grid(self) -> torch.Tensor:
        """(S, D) mean per-PE barrier residency, averaged over trials."""
        return self.mean_residency.mean(dim=-1)

    @property
    def mean_energy(self) -> torch.Tensor:
        """(S, D) episode energy (pJ), averaged over trials."""
        return self.energy.mean(dim=-1)

    @property
    def completion_rate(self) -> torch.Tensor:
        """(S, D) mean fraction of PEs released per episode (1.0 on
        fault-free sweeps)."""
        n = float(self.schedules[0].n_pes)
        return (1.0 - self.abandoned_pes.to(torch.float32) / n).mean(dim=-1)


def radix_tables(radices: Sequence[int], n_pes: int | None = None,
                 cfg: TeraPoolConfig = DEFAULT, *,
                 device="cuda") -> LevelTable:
    """Stacked ``(R, max_levels)`` level tables for a radix sweep."""
    n = int(n_pes if n_pes is not None else cfg.n_pes)
    scheds = [barrier.kary_tree(r, n_pes=n, cfg=cfg) for r in radices]
    return barrier.stack_tables(scheds, cfg, device=device)


def _sweep_body(tables: LevelTable, delays: torch.Tensor,
                unit: torch.Tensor, cfg: TeraPoolConfig, core: str,
                widths: tuple | None = None) -> BarrierResult:
    """(S, D, T) grid: ``unit`` is a (T, n_pes) block of standard
    uniforms, scaled by each delay into the (D, T, n_pes) arrivals; the
    stacked tables broadcast over the delay and trial axes."""
    arrivals = delays[:, None, None] * unit[None, :, :]      # (D, T, N)
    lifted = LevelTable(*(f.reshape(f.shape[:1] + (1, 1) + f.shape[1:])
                          for f in tables))                  # (S, 1, 1, ...)
    return core_fn(core)(arrivals, lifted, cfg, widths)


def _trial_chunks(n_trials: int, trial_chunk: int | None):
    """(lo, hi) slices of the trial axis; one full slice when unset."""
    if trial_chunk is None or trial_chunk >= n_trials:
        yield 0, n_trials
        return
    if trial_chunk < 1:
        raise ValueError(f"trial_chunk must be >= 1, got {trial_chunk}")
    for lo in range(0, n_trials, trial_chunk):
        yield lo, min(lo + trial_chunk, n_trials)


def _concat_results(parts: list) -> BarrierResult:
    if len(parts) == 1:
        return parts[0]
    return BarrierResult(*(torch.cat(xs, dim=-1) for xs in zip(*parts)))


def sweep_schedules(key: torch.Tensor,
                    schedules: Sequence[barrier.BarrierSchedule],
                    delays: Sequence[float] = (0.0, 128.0, 512.0, 2048.0),
                    n_trials: int = 16,
                    cfg: TeraPoolConfig = DEFAULT,
                    placements: Sequence | None = None, *,
                    core: str | None = None,
                    trial_chunk: int | None = None,
                    shard: bool = True,
                    devices=None,
                    faults=None,
                    device="cuda") -> SweepResult:
    """Run a same-``n_pes`` schedule stack x delay x trial grid on
    ``device`` as batched core calls.

    ``trial_chunk`` bounds the live grid memory by splitting the trial
    axis (chunked == unchunked bit for bit; the trial draws happen once,
    up front).  ``shard`` and ``devices`` are accepted for signature
    parity with the reference and ignored: the port runs on one device
    (ROADMAP.md §1 item 11).  ``placements`` (item 1) and ``faults``
    (item 4) are not ported."""
    if faults is not None:
        raise NotImplementedError(barrier_sim._FAULTS_TODO)
    dev = resolve_device(device)
    schedules = tuple(schedules)
    tables = barrier.stack_tables(schedules, cfg, placements, device=dev)
    n = schedules[0].n_pes
    unit = prng.uniform(key.to(dev), (n_trials, n), 0.0, 1.0)
    d = torch.as_tensor(delays, dtype=torch.float32, device=dev)
    core = barrier_sim.resolve_core(core)
    widths = barrier.telescope_widths(tables, n)
    res = _concat_results([
        _sweep_body(tables, d, unit[lo:hi], cfg, core, widths)
        for lo, hi in _trial_chunks(n_trials, trial_chunk)])
    return SweepResult(schedules=schedules, delays=d, **res._asdict())


def sweep_barrier(key: torch.Tensor, radices: Sequence[int] | None = None,
                  delays: Sequence[float] = (0.0, 128.0, 512.0, 2048.0),
                  n_pes: int | None = None, n_trials: int = 16,
                  cfg: TeraPoolConfig = DEFAULT, *,
                  core: str | None = None,
                  trial_chunk: int | None = None,
                  shard: bool = True,
                  device="cuda") -> SweepResult:
    """The Fig. 4 grid: :func:`sweep_schedules` over the uniform-radix
    stack (every radix of ``n_pes`` by default)."""
    n = int(n_pes if n_pes is not None else cfg.n_pes)
    if radices is None:
        radices = barrier.all_radices(n, cfg)
    scheds = [barrier.kary_tree(r, n_pes=n, cfg=cfg) for r in radices]
    return sweep_schedules(key, scheds, delays, n_trials, cfg, core=core,
                           trial_chunk=trial_chunk, shard=shard,
                           device=device)


def best_radix_per_delay(res: SweepResult) -> torch.Tensor:
    """(D,) radix minimizing the mean Fig. 4a span at each delay (only
    meaningful for uniform-radix stacks)."""
    return res.radices[torch.argmin(res.mean_span, dim=0)]
