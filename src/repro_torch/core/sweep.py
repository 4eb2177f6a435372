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
* :func:`sweep_arrivals` — data-dependent arrivals: stacks of per-PE
  arrival matrices (kernel x trial, e.g. the Fig. 5/6 workload models
  of :mod:`repro_torch.core.workloads`) across a schedule (x placement)
  stack, the engine behind the workload-conditioned tuner.
* :func:`simulate_schedules` / :func:`simulate_radices` — one arrival
  vector (e.g. one kernel's epoch, Fig. 6) across a schedule stack.

Placed and unplaced schedules share one table shape, so a placement
axis is more rows of the same stacked table, not another code path.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from .._device import resolve_device
from . import barrier, barrier_sim, prng
from .barrier import LevelTable
from .barrier_sim import BarrierResult, core_fn
from .topology import DEFAULT, TeraPoolConfig


def _stack_names(schedules: tuple, placements: tuple) -> tuple:
    """Canonical per-point labels, ``@strategy``-suffixed where a
    placement is attached (shared by both result types)."""
    placs = placements or (None,) * len(schedules)
    return tuple(barrier.schedule_name(s, p)
                 for s, p in zip(schedules, placs))


def _completion_rate(res) -> torch.Tensor:
    n = float(res.schedules[0].n_pes)
    return (1.0 - res.abandoned_pes.to(torch.float32) / n).mean(dim=-1)


class SweepResult(NamedTuple):
    """Per-point results over a (schedule[, placement], delay, trial)
    grid.  Every tensor field is ``(n_schedules, n_delays, n_trials)``;
    ``schedules`` and ``delays`` echo the grid axes and ``placements``
    aligns with ``schedules`` (empty on placement-free sweeps)."""

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
    placements: tuple = ()        # tuple[CounterPlacement | None], length S

    @property
    def radices(self) -> torch.Tensor:
        """(S,) uniform radix per schedule (0 where mixed-radix)."""
        return torch.tensor([s.radix for s in self.schedules],
                            dtype=torch.int32, device=self.delays.device)

    @property
    def names(self) -> tuple:
        """Canonical names, e.g. ``("2x8x8x8", "32x32@central")``."""
        return _stack_names(self.schedules, self.placements)

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
        return _completion_rate(self)


class ArrivalSweepResult(NamedTuple):
    """Per-point results over a (schedule[, placement], kernel, trial)
    grid — the data-dependent sibling of :class:`SweepResult`.  Every
    tensor field is ``(n_schedules, n_kernels, n_trials)``; ``kernels``
    echoes the arrival-stack axis."""

    schedules: tuple              # tuple[BarrierSchedule], length S
    kernels: tuple                # tuple[str], length K
    exit_time: torch.Tensor       # (S, K, T)
    last_arrival: torch.Tensor    # (S, K, T)
    span_cycles: torch.Tensor     # (S, K, T)
    mean_residency: torch.Tensor  # (S, K, T)
    energy: torch.Tensor          # (S, K, T) episode energy, pJ
    completed: torch.Tensor       # (S, K, T) bool
    abandoned_pes: torch.Tensor   # (S, K, T) int32
    timed_out_levels: torch.Tensor  # (S, K, T) int32
    placements: tuple = ()        # tuple[CounterPlacement | None], length S

    @property
    def radices(self) -> torch.Tensor:
        """(S,) uniform radix per schedule (0 where mixed-radix)."""
        return torch.tensor([s.radix for s in self.schedules],
                            dtype=torch.int32,
                            device=self.span_cycles.device)

    @property
    def names(self) -> tuple:
        """Canonical names, ``@strategy``-suffixed where placed."""
        return _stack_names(self.schedules, self.placements)

    @property
    def mean_span(self) -> torch.Tensor:
        """(S, K) Fig. 4a metric per kernel, averaged over trials."""
        return self.span_cycles.mean(dim=-1)

    @property
    def mean_energy(self) -> torch.Tensor:
        """(S, K) episode energy (pJ) per kernel, averaged over trials."""
        return self.energy.mean(dim=-1)

    @property
    def completion_rate(self) -> torch.Tensor:
        """(S, K) mean fraction of PEs released per episode."""
        return _completion_rate(self)


def radix_tables(radices: Sequence[int], n_pes: int | None = None,
                 cfg: TeraPoolConfig = DEFAULT, *,
                 device="cuda") -> LevelTable:
    """Stacked ``(R, max_levels)`` level tables for a radix sweep."""
    n = int(n_pes if n_pes is not None else cfg.n_pes)
    scheds = [barrier.kary_tree(r, n_pes=n, cfg=cfg) for r in radices]
    return barrier.stack_tables(scheds, cfg, device=device)


def _lift(tables: LevelTable, n_batch: int) -> LevelTable:
    """Stacked ``(S, ...)`` tables reshaped to ``(S, 1 x n_batch, ...)``
    so they broadcast against ``n_batch`` arrival batch dimensions."""
    return LevelTable(*(f.reshape(f.shape[:1] + (1,) * n_batch
                                  + f.shape[1:]) for f in tables))


def _sweep_body(tables: LevelTable, delays: torch.Tensor,
                unit: torch.Tensor, cfg: TeraPoolConfig, core: str,
                widths: tuple | None = None) -> BarrierResult:
    """(S, D, T) grid: ``unit`` is a (T, n_pes) block of standard
    uniforms, scaled by each delay into the (D, T, n_pes) arrivals; the
    stacked tables broadcast over the delay and trial axes."""
    arrivals = delays[:, None, None] * unit[None, :, :]      # (D, T, N)
    return core_fn(core)(arrivals, _lift(tables, 2), cfg, widths)


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
    (ROADMAP.md §1 item 11).  ``placements`` aligns with ``schedules``
    (``None`` entries keep the span heuristic).  ``faults`` needs the
    robust cores (item 4) and raises."""
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
    placements = tuple(placements) if placements is not None else ()
    return SweepResult(schedules=schedules, delays=d, placements=placements,
                       **res._asdict())


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


def sweep_arrivals(arrivals, schedules: Sequence[barrier.BarrierSchedule],
                   cfg: TeraPoolConfig = DEFAULT,
                   placements: Sequence | None = None,
                   kernels: Sequence[str] | None = None, *,
                   core: str | None = None,
                   trial_chunk: int | None = None,
                   faults=None) -> ArrivalSweepResult:
    """Sweep a stack of measured arrival matrices across a schedule
    (x optional placement) stack as batched core calls, on the
    arrivals' device.

    ``arrivals`` is ``(n_kernels, n_trials, n_pes)`` — e.g. one
    :func:`repro_torch.core.workloads.arrival_batch` per kernel,
    stacked — or ``(n_trials, n_pes)`` for a single workload.
    ``trial_chunk`` splits the trial axis (bit for bit the unchunked
    grid); ``faults`` raises (ROADMAP.md §1 item 4)."""
    if faults is not None:
        raise NotImplementedError(barrier_sim._FAULTS_TODO)
    arrivals = torch.as_tensor(arrivals, dtype=torch.float32)
    if arrivals.ndim == 2:
        arrivals = arrivals[None]
    if arrivals.ndim != 3:
        raise ValueError(
            f"arrivals must be (n_kernels, n_trials, n_pes) or "
            f"(n_trials, n_pes), got shape {tuple(arrivals.shape)}")
    schedules = tuple(schedules)
    if schedules and arrivals.shape[-1] != schedules[0].n_pes:
        raise ValueError(
            f"arrivals has {arrivals.shape[-1]} PEs, schedules expect "
            f"{schedules[0].n_pes}")
    if kernels is not None and len(kernels) != arrivals.shape[0]:
        raise ValueError(
            f"{arrivals.shape[0]} arrival stacks but {len(kernels)} "
            f"kernel names")
    tables = barrier.stack_tables(schedules, cfg, placements,
                                  device=arrivals.device)
    fn = core_fn(core)
    widths = barrier.telescope_widths(tables, arrivals.shape[-1])
    lifted = _lift(tables, 2)
    res = _concat_results([
        fn(arrivals[:, lo:hi], lifted, cfg, widths)
        for lo, hi in _trial_chunks(arrivals.shape[1], trial_chunk)])
    kernels = (tuple(kernels) if kernels is not None
               else tuple(f"workload{i}" for i in range(arrivals.shape[0])))
    placements = tuple(placements) if placements is not None else ()
    return ArrivalSweepResult(schedules=schedules, kernels=kernels,
                              placements=placements, **res._asdict())


def split_kernels(res: ArrivalSweepResult) -> list:
    """Per-kernel single-column views of a batched arrival sweep: column
    ``j`` is bit for bit what a single-kernel :func:`sweep_arrivals`
    call returns for the same arrivals."""
    return [ArrivalSweepResult(
        schedules=res.schedules, kernels=(k,), placements=res.placements,
        **{f: getattr(res, f)[:, j:j + 1] for f in BarrierResult._fields})
        for j, k in enumerate(res.kernels)]


def simulate_schedules(arrivals,
                       schedules: Sequence[barrier.BarrierSchedule],
                       cfg: TeraPoolConfig = DEFAULT,
                       placements: Sequence | None = None, *,
                       core: str | None = None) -> BarrierResult:
    """Simulate ONE arrival vector (or batch, ``(..., n_pes)``) under
    every schedule (x optional per-entry placement) of the stack in one
    batched call; results are ``(S, ...)``."""
    arrivals = torch.as_tensor(arrivals, dtype=torch.float32)
    schedules = tuple(schedules)
    if schedules and arrivals.shape[-1] != schedules[0].n_pes:
        raise ValueError(
            f"arrivals has {arrivals.shape[-1]} PEs, schedules expect "
            f"{schedules[0].n_pes}")
    tables = barrier.stack_tables(schedules, cfg, placements,
                                  device=arrivals.device)
    widths = barrier.telescope_widths(tables, arrivals.shape[-1])
    return core_fn(core)(arrivals, _lift(tables, arrivals.ndim - 1), cfg,
                         widths)


def simulate_radices(arrivals, radices: Sequence[int],
                     cfg: TeraPoolConfig = DEFAULT, *,
                     core: str | None = None) -> BarrierResult:
    """Simulate ONE arrival vector under every radix in ``radices``
    (Fig. 6's per-kernel radix scan) in one batched call."""
    arrivals = torch.as_tensor(arrivals, dtype=torch.float32)
    scheds = [barrier.kary_tree(r, n_pes=arrivals.shape[-1], cfg=cfg)
              for r in radices]
    return simulate_schedules(arrivals, scheds, cfg, core=core)


def best_schedule_per_delay(res: SweepResult) -> tuple:
    """(D,) canonical schedule names minimizing the mean Fig. 4a span at
    each delay — the mixed-radix-safe sibling of
    :func:`best_radix_per_delay`."""
    names = res.names
    return tuple(names[int(i)]
                 for i in torch.argmin(res.mean_span, dim=0).tolist())
