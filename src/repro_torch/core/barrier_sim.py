"""Cycle-level simulator of TeraPool barrier synchronization (port of
``repro.core.barrier_sim``, plain cores).

Given per-PE *arrival times*, computes the exact timing of the arrival
tree under the machine model of :mod:`repro_torch.core.topology`:

* every PE issues an atomic fetch&add to its group's counter;
* concurrent atomics to one BANK serialize at one per service interval
  — a max-plus prefix scan over each bank's request queue;
* the group's last arriver proceeds to the next level after its
  bookkeeping; the final survivor writes the wakeup register and every
  PE resumes from WFI.

Three implementations share the model and agree bit for bit on
``exit_time``, ``last_arrival`` and ``span_cycles``:

* :func:`_telescope_core` — the production path (``core="telescope"``):
  level ``i`` touches only the first ``widths[i]`` lanes, the survivor
  bound of the stacked schedules.
* :func:`_scan_core` — full width at every level (``core="scan"``), the
  width-independent oracle of the telescoping core.
* :func:`simulate_reference` — the per-level reshape loop, one schedule
  at a time.

Both cores take any leading batch shape on the arrivals, and level
tables whose fields carry leading batch dimensions that broadcast
against it: a whole schedule x delay x trial grid is one call.  Each
level is a handful of batched torch ops: a stable two-key sort by
(bank, ready), a segmented max-plus scan, a segment max.
``mean_residency`` and ``energy`` are float32 means over the PEs; torch
sums them in another order than XLA, so they match the reference to a
relative 1e-6, not bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .._device import resolve_device
from .barrier import (BarrierSchedule, LevelTable, default_widths,
                      level_table, telescope_widths, validate_tail_padding)
from .energy import (DEFAULT_ENERGY, EnergyModel, episode_energy,
                     schedule_energy_constants)
from .topology import DEFAULT, TeraPoolConfig
from . import prng

# The selectable simulator cores: "telescope" is the hot path, "scan"
# the full-width oracle.
CORES = ("telescope", "scan")
DEFAULT_CORE = "telescope"

_FAULTS_TODO = ("fault specs and masks need the robust cores, not ported "
                "yet (ROADMAP.md §1 item 4)")


class BarrierResult(NamedTuple):
    """Timing (cycles), energy (pJ) and degradation accounting of one
    barrier episode (or a batch of them).  The plain cores fill the last
    three columns trivially: finite exit, no abandonment, no watchdog
    releases."""

    exit_time: torch.Tensor        # float32: cycle every PE resumes
    last_arrival: torch.Tensor     # float32: cycle the last PE entered
    span_cycles: torch.Tensor      # float32: exit - last arrival (Fig. 4a)
    mean_residency: torch.Tensor   # float32: mean over PEs of exit - arrival
    energy: torch.Tensor           # float32: episode energy, pJ
    completed: torch.Tensor        # bool: the barrier released
    abandoned_pes: torch.Tensor    # int32: PEs the tree gave up on
    timed_out_levels: torch.Tensor  # int32: levels with a watchdog release


def _serialize_group(ready: torch.Tensor, latency: int,
                     cfg: TeraPoolConfig, svc=None) -> torch.Tensor:
    """Serialize atomics within each group (rows of ``ready``): with
    sorted issue times a_(1..k), service of request j starts at
    ``j*svc + cummax(a_j - j*svc)``.  Returns the completion time of the
    last request per group plus the response ``latency``."""
    svc = cfg.bank_service_cycles if svc is None else svc
    a = torch.sort(ready, dim=-1).values
    j = torch.arange(a.shape[-1], dtype=a.dtype, device=a.device) * svc
    start = torch.cummax(a - j, dim=-1).values + j
    return start[..., -1] + latency


# ---------------------------------------------------------------------------
# Batched cores over padded level tables.
# ---------------------------------------------------------------------------

def _segmented_cummax(x: torch.Tensor, is_start: torch.Tensor
                      ) -> torch.Tensor:
    """Running max along the last axis that restarts wherever
    ``is_start`` is True: a log-step (Hillis-Steele) scan of the
    segmented combine ``(lv, lf), (rv, rf) -> (rv if rf else
    max(lv, rv), lf | rf)``.  Exact, because max is order-free."""
    v, f = x, is_start
    width = x.shape[-1]
    s = 1
    while s < width:
        nv = torch.where(f[..., s:], v[..., s:],
                         torch.maximum(v[..., :-s], v[..., s:]))
        nf = f[..., s:] | f[..., :-s]
        v = torch.cat([v[..., :s], nv], dim=-1)
        f = torch.cat([f[..., :s], nf], dim=-1)
        s *= 2
    return v


def _gather_last(row: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``row[..., index]`` with the batch dimensions of both broadcast."""
    batch = torch.broadcast_shapes(row.shape[:-1], index.shape[:-1])
    return torch.gather(row.expand(*batch, row.shape[-1]), -1,
                        index.expand(*batch, index.shape[-1]))


def _sort_bank_ready(bank: torch.Tensor, ready: torch.Tensor,
                     grp: torch.Tensor) -> tuple:
    """Sort requests by (bank, ready), ties in lane order, carrying the
    group ids: two stable passes, by ready and then by bank — the order
    of the reference's stable ``lax.sort((bank, ready, grp),
    num_keys=2)``, which decides whose request a bank serves first."""
    batch = torch.broadcast_shapes(bank.shape, ready.shape, grp.shape)
    a, by_ready = torch.sort(ready.expand(batch), dim=-1, stable=True)
    b = torch.gather(bank.expand(batch), -1, by_ready)
    gs = torch.gather(grp.expand(batch), -1, by_ready)
    b, by_bank = torch.sort(b, dim=-1, stable=True)
    return (b, torch.gather(a, -1, by_bank), torch.gather(gs, -1, by_bank))


def _level_step(ready: torch.Tensor, table: LevelTable, i: int,
                m: torch.Tensor, w_next: int, oracle: bool) -> tuple:
    """One tree level over the ``w = ready.shape[-1]`` lanes in view:
    bank-queue service of every live request, each counter's release
    after its last serviced child plus its access latency, and the
    survivors' bookkeeping, compacted into the first ``w_next`` lanes
    (the rest ``+inf``).  ``m`` is the live count per table row.
    ``oracle`` ranks requests within a bank queue by a running max of
    segment starts (the scan core) instead of a search of the sorted
    bank column (the telescoping core)."""
    w = ready.shape[-1]
    width = table.bank_ids.shape[-1]
    idx = torch.arange(w, device=ready.device)
    g = table.group_sizes[..., i]
    svc = table.service_cycles[..., i, None]
    grp = idx // g[..., None]
    # Masked tail slots can index past the counter columns; clip — their
    # +inf ready times sort to the back of any bank queue they land in.
    bank = _gather_last(table.bank_ids[..., i, :], grp.clamp(max=width - 1))
    b, a, gs = _sort_bank_ready(bank, ready, grp)
    is_start = torch.ones_like(b, dtype=torch.bool)
    is_start[..., 1:] = b[..., 1:] != b[..., :-1]
    if oracle:
        first = torch.cummax(torch.where(is_start, idx, 0), dim=-1).values
    else:
        first = torch.searchsorted(b, b, right=False)
    rank = (idx - first).to(torch.float32)
    start = _segmented_cummax(a - rank * svc, is_start) + rank * svc
    # The counter's last arriver is its latest-serviced request; the
    # fetched value travels back at the counter's access latency.
    last = torch.full_like(start, -torch.inf).scatter_reduce_(
        -1, gs, start, "amax", include_self=True)
    lat = table.latencies[..., i, :].index_select(
        -1, idx.clamp(max=width - 1))
    done = last + lat
    m = m // g
    keep = torch.arange(w_next, device=ready.device) < m[..., None]
    ready = torch.where(
        keep, done[..., :w_next] + table.instr_cycles[..., i, None],
        torch.inf)
    return ready, m


def _result(arrivals: torch.Tensor, exit_time: torch.Tensor,
            table: LevelTable) -> BarrierResult:
    """The final reductions shared by both cores."""
    n = arrivals.shape[-1]
    last_arrival = arrivals.amax(dim=-1).expand(exit_time.shape)
    mean_res = (exit_time[..., None] - arrivals).mean(dim=-1)
    zeros = torch.zeros(exit_time.shape, dtype=torch.int32,
                        device=exit_time.device)
    return BarrierResult(
        exit_time=exit_time,
        last_arrival=last_arrival,
        span_cycles=exit_time - last_arrival,
        mean_residency=mean_res,
        energy=episode_energy(table.energy_static, table.active_cycles,
                              table.idle_power, n, mean_res),
        completed=torch.isfinite(exit_time),
        abandoned_pes=zeros,
        timed_out_levels=zeros,
    )


def _scan_core(arrivals: torch.Tensor, table: LevelTable,
               cfg: TeraPoolConfig, widths: tuple | None = None
               ) -> BarrierResult:
    """One barrier episode per batch entry, every level at full width.

    The ``m`` current survivors are compacted into the prefix of the
    ``(n_pes,)`` ready row and the tail is masked to ``+inf``.  Atomics
    serialize per BANK: requests sort by (bank, ready) and every bank's
    queue is one segment of the max-plus service scan.  ``widths`` is
    accepted for signature parity with :func:`_telescope_core` and
    ignored.
    """
    n = arrivals.shape[-1]
    arrivals = arrivals.to(torch.float32)
    ready = arrivals + table.entry_instr[..., None]
    m = torch.full(table.entry_instr.shape, n, dtype=torch.int64,
                   device=arrivals.device)
    for i in range(table.group_sizes.shape[-1]):
        ready, m = _level_step(ready, table, i, m, n, oracle=True)
    return _result(arrivals, ready[..., 0] + cfg.wakeup_cycles, table)


def _telescope_core(arrivals: torch.Tensor, table: LevelTable,
                    cfg: TeraPoolConfig, widths: tuple | None = None
                    ) -> BarrierResult:
    """One barrier episode per batch entry as a telescoping pyramid:
    level ``i`` runs on the first ``widths[i]`` lanes only, the
    cumulative-quotient survivor bound of the stacked schedules
    (:func:`~repro_torch.core.barrier.telescope_widths`), or
    ``max(1, N >> i)`` when ``widths`` is ``None``.  Lanes beyond the
    window hold only ``+inf`` phantoms, so every width table gives the
    scan core's result bit for bit."""
    n = arrivals.shape[-1]
    arrivals = arrivals.to(torch.float32)
    depth = table.group_sizes.shape[-1]
    if widths is None:
        widths = default_widths(n, depth)
    if len(widths) != depth + 1:
        raise ValueError(
            f"widths table has {len(widths)} entries for a depth-"
            f"{depth} table; need depth + 1")
    ready = arrivals + table.entry_instr[..., None]
    m = torch.full(table.entry_instr.shape, n, dtype=torch.int64,
                   device=arrivals.device)
    for i in range(depth):
        w = min(int(widths[i]), n)
        w_next = min(int(widths[i + 1]), w)
        ready, m = _level_step(ready[..., :w], table, i, m, w_next,
                               oracle=False)
    return _result(arrivals, ready[..., 0] + cfg.wakeup_cycles, table)


_CORE_FNS = {"scan": _scan_core, "telescope": _telescope_core}


def resolve_core(core: str | None = None) -> str:
    """Normalize a core selector (``"telescope"`` | ``"scan"`` | ``None``
    for :data:`DEFAULT_CORE`) to a validated core name."""
    name = DEFAULT_CORE if core is None else core
    if name not in _CORE_FNS:
        raise ValueError(
            f"unknown simulator core {name!r}; choose from {CORES}")
    return name


def core_fn(core: str | None = None):
    """Resolve a core selector to its implementation."""
    return _CORE_FNS[resolve_core(core)]


def simulate_table(arrivals, table: LevelTable,
                   cfg: TeraPoolConfig = DEFAULT, *,
                   core: str | None = None,
                   faults=None, fault_mask=None) -> BarrierResult:
    """Simulate directly from a padded :class:`LevelTable`, on the
    table's device.  ``arrivals`` may have any leading batch shape; the
    table's fields may carry leading batch dimensions that broadcast
    against it.  The telescoping core runs at the table's exact
    cumulative-quotient widths."""
    if faults is not None or fault_mask is not None:
        raise NotImplementedError(_FAULTS_TODO)
    table = validate_tail_padding(table, full=False)
    arrivals = torch.as_tensor(arrivals, dtype=torch.float32,
                               device=table.group_sizes.device)
    widths = telescope_widths(table, arrivals.shape[-1])
    return core_fn(core)(arrivals, table, cfg, widths)


def simulate(arrivals, schedule: BarrierSchedule,
             cfg: TeraPoolConfig = DEFAULT, *,
             placement=None, core: str | None = None,
             energy_model: EnergyModel = DEFAULT_ENERGY,
             faults=None, fault_mask=None,
             device="cuda") -> BarrierResult:
    """Simulate one barrier episode (or a leading batch of them) on
    ``device``.

    Args:
      arrivals: (..., n_pes) per-PE barrier-entry cycles.
      schedule: static tree structure from :mod:`repro_torch.core.barrier`.
      cfg: machine model.
      placement: must be ``None`` (ROADMAP.md §1 item 1).
      core: ``"telescope"`` (default) or ``"scan"``.
      energy_model: per-event cost model pricing the ``energy`` column.
      faults, fault_mask: must be ``None`` (ROADMAP.md §1 item 4).
      device: where to simulate; ``"cuda"`` raises without a card.
    """
    dev = resolve_device(device)
    arrivals = torch.as_tensor(arrivals, dtype=torch.float32, device=dev)
    if arrivals.shape[-1] != schedule.n_pes:
        raise ValueError(
            f"arrivals has {arrivals.shape[-1]} PEs, schedule expects "
            f"{schedule.n_pes}")
    table = level_table(schedule, cfg=cfg, placement=placement,
                        energy_model=energy_model, device=dev)
    return simulate_table(arrivals, table, cfg, core=core, faults=faults,
                          fault_mask=fault_mask)


def simulate_reference(arrivals, schedule: BarrierSchedule,
                       cfg: TeraPoolConfig = DEFAULT,
                       energy_model: EnergyModel = DEFAULT_ENERGY, *,
                       device="cuda") -> BarrierResult:
    """The seed per-level loop, kept as the equivalence oracle: each
    level reshapes the survivors into its groups and serializes each
    group's atomics (:func:`_serialize_group`)."""
    dev = resolve_device(device)
    arrivals = torch.as_tensor(arrivals, dtype=torch.float32, device=dev)
    if arrivals.shape[-1] != schedule.n_pes:
        raise ValueError(
            f"arrivals has {arrivals.shape[-1]} PEs, schedule expects "
            f"{schedule.n_pes}")

    # The hardware event unit replaces the software level path: one
    # trigger store on entry, parallel (unserialized) stage aggregation,
    # zero per-level bookkeeping.
    hw = schedule.hw
    entry = cfg.hw_entry_instr if hw else cfg.instr_per_level
    instr = 0 if hw else cfg.instr_per_level
    svc = 0 if hw else None

    ready = arrivals + entry
    for lvl in schedule.levels:
        grouped = ready.reshape(ready.shape[:-1] + (-1, lvl.group_size))
        ready = _serialize_group(grouped, lvl.latency, cfg, svc=svc) + instr

    exit_time = ready[..., 0] + cfg.wakeup_cycles
    last_arrival = arrivals.amax(dim=-1)
    mean_res = (exit_time[..., None] - arrivals).mean(dim=-1)
    stat, act, idle = (torch.tensor(float(x), dtype=torch.float32,
                                    device=dev)
                       for x in schedule_energy_constants(
                           schedule, None, cfg, energy_model))
    zeros = torch.zeros(exit_time.shape, dtype=torch.int32, device=dev)
    return BarrierResult(
        exit_time=exit_time,
        last_arrival=last_arrival,
        span_cycles=exit_time - last_arrival,
        mean_residency=mean_res,
        energy=episode_energy(stat, act, idle, schedule.n_pes, mean_res),
        completed=torch.isfinite(exit_time),
        abandoned_pes=zeros,
        timed_out_levels=zeros,
    )


def uniform_arrivals(key: torch.Tensor, max_delay: float, n_pes: int,
                     n_trials: int = 16, *, device="cuda") -> torch.Tensor:
    """The paper's synthetic benchmark (Sec. 4.1): per-PE delay drawn
    uniformly from [0, max_delay], ``(n_trials, n_pes)`` float32."""
    dev = resolve_device(device)
    if max_delay <= 0:
        return torch.zeros((n_trials, n_pes), dtype=torch.float32,
                           device=dev)
    return prng.uniform(key.to(dev), (n_trials, n_pes), 0.0, max_delay)


def mean_span_cycles(key: torch.Tensor, schedule: BarrierSchedule,
                     max_delay: float, cfg: TeraPoolConfig = DEFAULT,
                     n_trials: int = 16, *, device="cuda") -> torch.Tensor:
    """Average Fig. 4a metric (last-in -> last-out cycles) over trials."""
    arr = uniform_arrivals(key, max_delay, schedule.n_pes, n_trials,
                           device=device)
    return simulate(arr, schedule, cfg, device=device).span_cycles.mean()


def overhead_fraction(key: torch.Tensor, schedule: BarrierSchedule,
                      sfr_cycles: float, max_delay: float,
                      cfg: TeraPoolConfig = DEFAULT,
                      n_trials: int = 16, *, device="cuda") -> torch.Tensor:
    """Fig. 4b metric: mean per-PE barrier residency over total runtime,
    as a function of the synchronization-free region (SFR)."""
    arr = uniform_arrivals(key, max_delay, schedule.n_pes, n_trials,
                           device=device)
    res = simulate(arr, schedule, cfg, device=device)
    barrier_cycles = res.mean_residency.mean()
    return barrier_cycles / (sfr_cycles + barrier_cycles)
