"""Cycle-level simulator of TeraPool barrier synchronization (port of
``repro.core.barrier_sim``).

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

Fault model
-----------

Both cores have degradation-tolerant twins (``faults=`` on
:func:`simulate` / :func:`simulate_table`, :func:`_scan_robust_core` /
:func:`_telescope_robust_core`).  A fail-stop PE arrives at ``+inf``
(``fault_mask=`` sets masked arrivals so); each counter releases at
``min(ceil(quorum_frac * g)-th serviced start, first serviced start +
timeout)`` (:class:`~repro_torch.core.barrier.FaultSpec`); children
whose service starts after their counter's release are abandoned with
their whole original-PE block, and span and residency are taken over
the surviving PEs.  Each robust level adds one stable sort (the service
rank within a group) and one scatter (the abandoned lanes) to the plain
level.  :func:`simulate_robust_reference` is the independent numpy
walk both are held to.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from .barrier import (BarrierSchedule, FaultSpec, LevelTable,
                      default_widths, fault_spec, level_table,
                      telescope_widths, validate_tail_padding)
from .energy import (DEFAULT_ENERGY, EnergyModel, episode_energy,
                     robust_episode_energy, schedule_energy_constants)
from .topology import DEFAULT, TeraPoolConfig
from . import prng

# The selectable simulator cores: "telescope" is the hot path, "scan"
# the full-width oracle.
CORES = ("telescope", "scan")
DEFAULT_CORE = "telescope"


class BarrierResult(NamedTuple):
    """Timing (cycles), energy (pJ) and degradation accounting of one
    barrier episode (or a batch of them).  The plain cores fill the last
    three columns trivially (no abandonment, no watchdog releases); the
    robust cores count them."""

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
                     grp: torch.Tensor, with_lane: bool = False) -> tuple:
    """Sort requests by (bank, ready), ties in lane order, carrying the
    group ids (and, with ``with_lane``, each sorted request's lane): two
    stable passes, by ready and then by bank — the order of the
    reference's stable ``lax.sort((bank, ready, grp), num_keys=2)``,
    which decides whose request a bank serves first."""
    batch = torch.broadcast_shapes(bank.shape, ready.shape, grp.shape)
    a, by_ready = torch.sort(ready.expand(batch), dim=-1, stable=True)
    b = torch.gather(bank.expand(batch), -1, by_ready)
    gs = torch.gather(grp.expand(batch), -1, by_ready)
    b, by_bank = torch.sort(b, dim=-1, stable=True)
    out = (b, torch.gather(a, -1, by_bank), torch.gather(gs, -1, by_bank))
    if with_lane:
        out += (torch.gather(by_ready, -1, by_bank),)
    return out


def _service_starts(ready: torch.Tensor, table: LevelTable, i: int,
                    oracle: bool, with_lane: bool = False) -> tuple:
    """Bank-queue service of every request of level ``i`` over the
    ``w = ready.shape[-1]`` lanes in view.  Returns, in (bank, ready)
    order, the service starts and the group ids, then the level's group
    sizes and its first ``w`` counter latencies (and, with
    ``with_lane``, each sorted request's lane).  ``oracle`` ranks
    requests within a bank queue by a running max of segment starts (the
    scan cores) instead of a search of the sorted bank column (the
    telescoping cores)."""
    w = ready.shape[-1]
    width = table.bank_ids.shape[-1]
    idx = torch.arange(w, device=ready.device)
    g = table.group_sizes[..., i]
    svc = table.service_cycles[..., i, None]
    grp = idx // g[..., None]
    # Masked tail slots can index past the counter columns; clip — their
    # +inf ready times sort to the back of any bank queue they land in.
    bank = _gather_last(table.bank_ids[..., i, :], grp.clamp(max=width - 1))
    b, a, gs, *lane = _sort_bank_ready(bank, ready, grp, with_lane)
    is_start = torch.ones_like(b, dtype=torch.bool)
    is_start[..., 1:] = b[..., 1:] != b[..., :-1]
    if oracle:
        first = torch.cummax(torch.where(is_start, idx, 0), dim=-1).values
    else:
        first = torch.searchsorted(b, b, right=False)
    rank = (idx - first).to(torch.float32)
    start = _segmented_cummax(a - rank * svc, is_start) + rank * svc
    lat = table.latencies[..., i, :].index_select(
        -1, idx.clamp(max=width - 1))
    return (start, gs, g, lat, *lane)


def _segment_max(values: torch.Tensor, segments: torch.Tensor
                 ) -> torch.Tensor:
    """Max of ``values`` per segment id along the last axis, ``-inf``
    for an empty segment (``jax.ops.segment_max``), as many segments as
    lanes."""
    return torch.full_like(values, -torch.inf).scatter_reduce_(
        -1, segments, values, "amax", include_self=True)


def _survivors(done: torch.Tensor, table: LevelTable, i: int,
               m: torch.Tensor, g: torch.Tensor, w_next: int) -> tuple:
    """Each counter's survivor after its bookkeeping, compacted into the
    first ``w_next`` lanes (the rest ``+inf``), and the new live count."""
    m = m // g
    keep = torch.arange(w_next, device=done.device) < m[..., None]
    ready = torch.where(
        keep, done[..., :w_next] + table.instr_cycles[..., i, None],
        torch.inf)
    return ready, m


def _level_step(ready: torch.Tensor, table: LevelTable, i: int,
                m: torch.Tensor, w_next: int, oracle: bool) -> tuple:
    """One tree level over the ``w = ready.shape[-1]`` lanes in view:
    bank-queue service of every live request, each counter's release
    after its last serviced child plus its access latency, and the
    survivors' bookkeeping (:func:`_survivors`).  ``m`` is the live
    count per table row."""
    start, gs, g, lat = _service_starts(ready, table, i, oracle)
    # The counter's last arriver is its latest-serviced request; the
    # fetched value travels back at the counter's access latency.
    done = _segment_max(start, gs) + lat
    return _survivors(done, table, i, m, g, w_next)


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


# ---------------------------------------------------------------------------
# Degradation-tolerant (robust) cores: timeout + quorum release.
# ---------------------------------------------------------------------------

def _timeout_rows(spec: FaultSpec, depth: int) -> torch.Tensor:
    """A spec's timeout as a per-PADDED-level (depth,) row: a scalar
    broadcasts, a shorter row is tail-padded with ``+inf``.  Padding
    levels are singleton pass-throughs under any timeout."""
    t = spec.timeout_cycles.to(torch.float32)
    if t.dim() == 0:
        return t.expand(depth)
    if t.shape[0] < depth:
        return torch.cat([t, t.new_full((depth - t.shape[0],), torch.inf)])
    return t[:depth]


def _group_rank(gs: torch.Tensor) -> torch.Tensor:
    """Service rank of each sorted request WITHIN its group.  ``gs`` is
    the group column in (bank, ready) order, so within a group (one
    counter, one bank) increasing position is service order: a stable
    sort of ``gs`` makes each group a run whose offset from its first
    position is the rank, scattered back to the sorted positions."""
    g2, pos = torch.sort(gs, dim=-1, stable=True)
    idx = torch.arange(gs.shape[-1], device=gs.device)
    rank = idx - torch.searchsorted(g2, g2, right=False)
    return torch.empty_like(rank).scatter_(-1, pos, rank)


def _robust_release(start: torch.Tensor, gs: torch.Tensor,
                    grank: torch.Tensor, g: torch.Tensor,
                    q: torch.Tensor, tmo: torch.Tensor) -> tuple:
    """Per-counter release: the quorum's last start is the max over the
    first ``k = clip(ceil(q * g), 1, g)`` ranks (float32, as the
    reference computes it), the watchdog deadline counts from the first
    serviced child.  Returns per-group-slot ``(release, fired)``.  Empty
    and all-``+inf`` phantom groups neither release finitely nor fire;
    with ``q == 1`` and ``tmo == +inf`` the release is the plain core's
    group max bit for bit."""
    gf = g.to(torch.float32)
    k = torch.minimum(torch.clamp(torch.ceil(q * gf), min=1.0), gf)
    in_quorum = grank.to(torch.float32) < k[..., None]
    qstart = _segment_max(torch.where(in_quorum, start, -torch.inf), gs)
    fstart = -_segment_max(-start, gs)
    deadline = fstart + tmo
    return torch.minimum(qstart, deadline), deadline < qstart


def _robust_level_step(ready: torch.Tensor, table: LevelTable, i: int,
                       m: torch.Tensor, w_next: int, oracle: bool,
                       spec: tuple, ok: torch.Tensor,
                       timed: torch.Tensor) -> tuple:
    """:func:`_level_step` with timeout/quorum release.  Live lane ``l``
    of a level with ``m`` live lanes stands for the contiguous block of
    ``n // m`` original PEs, so an abandoned lane strikes that block
    from the per-PE ``ok`` mask."""
    q, tmo = spec
    start, gs, g, lat, lane = _service_starts(ready, table, i, oracle,
                                              with_lane=True)
    release, fired = _robust_release(start, gs, _group_rank(gs), g, q, tmo)
    done = release + lat
    abandoned = start > torch.gather(release, -1, gs)
    ab_lane = torch.zeros_like(abandoned).scatter_(-1, lane, abandoned)
    n = ok.shape[-1]
    span = n // m
    block = torch.arange(n, device=ready.device) // span[..., None]
    ok = ok & ~_gather_last(ab_lane, block)
    timed = timed + fired.any(dim=-1).to(torch.int32)
    ready, m = _survivors(done, table, i, m, g, w_next)
    return ready, m, ok, timed


def _robust_core(arrivals: torch.Tensor, table: LevelTable,
                 cfg: TeraPoolConfig, widths: tuple, spec: FaultSpec,
                 oracle: bool) -> BarrierResult:
    """The level walk of both robust cores over the given widths."""
    n = arrivals.shape[-1]
    dev = arrivals.device
    arrivals = arrivals.to(torch.float32)
    depth = table.group_sizes.shape[-1]
    spec = spec.to(dev)
    tmo = _timeout_rows(spec, depth)
    q = spec.quorum_frac.to(torch.float32)
    ready = arrivals + table.entry_instr[..., None]
    batch = ready.shape[:-1]
    m = torch.full(batch, n, dtype=torch.int64, device=dev)
    ok = torch.isfinite(arrivals)
    timed = torch.zeros(batch, dtype=torch.int32, device=dev)
    for i in range(depth):
        w = min(int(widths[i]), n)
        w_next = min(int(widths[i + 1]), w)
        ready, m, ok, timed = _robust_level_step(
            ready[..., :w], table, i, m, w_next, oracle, (q, tmo[i]), ok,
            timed)
    exit_time = ready[..., 0] + cfg.wakeup_cycles
    # Final reductions over the SURVIVING PEs; each is a bitwise
    # identity when nothing failed (an all-true mask, mean * n / n).
    last_arrival = torch.where(torch.isfinite(arrivals), arrivals,
                               -torch.inf).amax(dim=-1).expand(batch)
    n_ok = ok.sum(dim=-1, dtype=torch.int32)
    abandoned = n - n_ok
    resid = torch.where(ok, exit_time[..., None] - arrivals, 0.0).mean(
        dim=-1)
    mean_res = resid * (n / n_ok.clamp(min=1).to(torch.float32))
    return BarrierResult(
        exit_time=exit_time,
        last_arrival=last_arrival,
        span_cycles=exit_time - last_arrival,
        mean_residency=mean_res,
        energy=robust_episode_energy(
            table.energy_static, table.active_cycles, table.idle_power, n,
            mean_res, spec.e_timeout_poll, timed.to(torch.float32),
            spec.e_abandon, abandoned.to(torch.float32)),
        completed=torch.isfinite(exit_time),
        abandoned_pes=abandoned,
        timed_out_levels=timed,
    )


def _scan_robust_core(arrivals: torch.Tensor, table: LevelTable,
                      cfg: TeraPoolConfig, widths: tuple | None = None,
                      spec: FaultSpec | None = None) -> BarrierResult:
    """:func:`_scan_core` with timeout/quorum release and per-PE
    completion tracking, every level at full width (``widths`` is
    ignored)."""
    n = arrivals.shape[-1]
    depth = table.group_sizes.shape[-1]
    return _robust_core(arrivals, table, cfg, (n,) * (depth + 1), spec,
                        oracle=True)


def _telescope_robust_core(arrivals: torch.Tensor, table: LevelTable,
                           cfg: TeraPoolConfig,
                           widths: tuple | None = None,
                           spec: FaultSpec | None = None) -> BarrierResult:
    """:func:`_telescope_core` with timeout/quorum release: the same
    shrinking windows, the same release algebra as
    :func:`_scan_robust_core`, and bit for bit its results."""
    n = arrivals.shape[-1]
    depth = table.group_sizes.shape[-1]
    if widths is None:
        widths = default_widths(n, depth)
    if len(widths) != depth + 1:
        raise ValueError(
            f"widths table has {len(widths)} entries for a depth-"
            f"{depth} table; need depth + 1")
    return _robust_core(arrivals, table, cfg, widths, spec, oracle=False)


_CORE_FNS = {"scan": _scan_core, "telescope": _telescope_core}
_ROBUST_CORE_FNS = {"scan": _scan_robust_core,
                    "telescope": _telescope_robust_core}


def resolve_core(core: str | None = None) -> str:
    """Normalize a core selector (``"telescope"`` | ``"scan"`` | ``None``
    for :data:`DEFAULT_CORE`) to a validated core name."""
    name = DEFAULT_CORE if core is None else core
    if name not in _CORE_FNS:
        raise ValueError(
            f"unknown simulator core {name!r}; choose from {CORES}")
    return name


def core_fn(core: str | None = None, *, robust: bool = False):
    """Resolve a core selector to its implementation (``robust=True``
    for the timeout/quorum twin, called with a trailing
    :class:`~repro_torch.core.barrier.FaultSpec`)."""
    name = resolve_core(core)
    return _ROBUST_CORE_FNS[name] if robust else _CORE_FNS[name]


def simulate_table(arrivals, table: LevelTable,
                   cfg: TeraPoolConfig = DEFAULT, *,
                   core: str | None = None,
                   faults=None, fault_mask=None) -> BarrierResult:
    """Simulate directly from a padded :class:`LevelTable`, on the
    table's device.  ``arrivals`` may have any leading batch shape; the
    table's fields may carry leading batch dimensions that broadcast
    against it.  The telescoping core runs at the table's exact
    cumulative-quotient widths.

    ``faults`` (a :class:`~repro_torch.core.barrier.FaultSpec`) switches
    to the robust cores; ``fault_mask`` fail-stops the masked PEs by
    setting their arrivals to ``+inf`` (any shape broadcastable against
    ``arrivals``) and implies the degenerate spec when ``faults`` is
    ``None``."""
    if fault_mask is not None and faults is None:
        faults = fault_spec()
    table = validate_tail_padding(table, full=False)
    dev = table.group_sizes.device
    arrivals = torch.as_tensor(arrivals, dtype=torch.float32, device=dev)
    if fault_mask is not None:
        mask = torch.as_tensor(fault_mask, dtype=torch.bool, device=dev)
        arrivals = torch.where(mask, torch.inf, arrivals)
    widths = telescope_widths(table, arrivals.shape[-1])
    if faults is None:
        return core_fn(core)(arrivals, table, cfg, widths)
    return core_fn(core, robust=True)(arrivals, table, cfg, widths, faults)


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
      placement: explicit counter -> bank mapping
        (:class:`~repro_torch.core.placement.CounterPlacement`); ``None``
        keeps the span heuristic.
      core: ``"telescope"`` (default) or ``"scan"``.
      energy_model: per-event cost model pricing the ``energy`` column.
      faults: a :class:`~repro_torch.core.barrier.FaultSpec` enabling
        timeout/quorum release (the robust cores).
      fault_mask: per-PE bool mask broadcastable against ``arrivals``;
        masked PEs fail-stop (arrival ``+inf``).
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



# ---------------------------------------------------------------------------
# Independent numpy fault oracle (test-only).
# ---------------------------------------------------------------------------

def _oracle_rows(schedule: BarrierSchedule, placement) -> list:
    """Per level: ``(group_size, bank ids per counter, latency per
    counter)``, straight from the schedule and placement (no level
    table).  Without a placement every counter gets its own bank at its
    level's span-heuristic latency."""
    rows = []
    m = schedule.n_pes
    for li, lvl in enumerate(schedule.levels):
        count = m // lvl.group_size
        if placement is not None:
            banks = np.asarray(placement.banks[li][:count], np.int64)
            lats = np.asarray(placement.latencies[li][:count], np.float32)
        else:
            banks = np.arange(count, dtype=np.int64)
            lats = np.full(count, np.float32(lvl.latency), np.float32)
        rows.append((lvl.group_size, banks, lats))
        m = count
    return rows


def _robust_episode(arr: np.ndarray, rows: list, cfg: TeraPoolConfig,
                    hw: bool, timeout_row: np.ndarray, q: float) -> tuple:
    """One degradation-tolerant episode as an explicit numpy walk:
    per-bank FIFO queues served at the bank interval, per-counter
    quorum/timeout release, per-PE abandonment.  Float32 op for op the
    robust cores' sequence, organized as per-bank and per-counter loops
    instead of segmented scans."""
    f32 = np.float32
    n = arr.size
    entry = f32(cfg.hw_entry_instr if hw else cfg.instr_per_level)
    svc = f32(0.0 if hw else cfg.bank_service_cycles)
    instr = f32(0.0 if hw else cfg.instr_per_level)
    ready = arr.astype(f32) + entry
    ok = np.isfinite(arr)
    timed = 0
    m = n
    for li, (g, banks, lats) in enumerate(rows):
        tmo = f32(timeout_row[li])
        n_grp = m // g
        grp = np.arange(m) // g
        bank = banks[grp]
        order = np.lexsort((ready, bank))   # stable: (bank, ready, index)
        a = ready[order]
        b = bank[order]
        gs = grp[order]
        start = np.empty(m, f32)
        pos = 0
        while pos < m:
            end = pos
            while end < m and b[end] == b[pos]:
                end += 1
            r = np.arange(end - pos, dtype=f32) * svc
            start[pos:end] = np.maximum.accumulate(a[pos:end] - r) + r
            pos = end
        k = int(min(max(float(np.ceil(f32(q) * f32(g))), 1.0), float(g)))
        done = np.empty(n_grp, f32)
        ab_lane = np.zeros(m, bool)
        level_fired = False
        for j in range(n_grp):
            sel = np.where(gs == j)[0]      # increasing = service order
            s_g = start[sel]
            qstart = f32(np.max(s_g[:k]))
            deadline = f32(f32(np.min(s_g)) + tmo)
            release = min(qstart, deadline)
            level_fired |= bool(deadline < qstart)
            done[j] = f32(release + f32(lats[j]))
            ab_lane[order[sel[s_g > release]]] = True
        span = n // m
        for lane in np.nonzero(ab_lane)[0]:
            ok[lane * span:(lane + 1) * span] = False
        timed += int(level_fired)
        ready = done + instr
        m = n_grp
    return f32(ready[0] + f32(cfg.wakeup_cycles)), ok, timed


def simulate_robust_reference(arrivals, schedule: BarrierSchedule,
                              cfg: TeraPoolConfig = DEFAULT, *,
                              placement=None,
                              faults: FaultSpec | None = None,
                              fault_mask=None,
                              energy_model: EnergyModel = DEFAULT_ENERGY,
                              device="cuda") -> BarrierResult:
    """Independent numpy oracle for the robust cores: explicit per-bank
    queues, per-counter quorum/timeout release and per-PE abandonment,
    for one episode or a leading batch, on the host; the final
    reductions are the cores' torch ops, and the result lands on
    ``device``."""
    dev = resolve_device(device)
    if faults is None:
        faults = fault_spec()
    arr = np.asarray(torch.as_tensor(arrivals).detach().cpu(), np.float32)
    if arr.shape[-1] != schedule.n_pes:
        raise ValueError(
            f"arrivals has {arr.shape[-1]} PEs, schedule expects "
            f"{schedule.n_pes}")
    if fault_mask is not None:
        mask = np.asarray(torch.as_tensor(fault_mask).detach().cpu(), bool)
        arr = np.where(mask, np.float32(np.inf), arr)
    n = schedule.n_pes
    batch = arr.shape[:-1]
    flat = arr.reshape((-1, n))
    hw = bool(schedule.hw)
    if hw and placement is not None:
        raise ValueError(
            "hardware event-unit barriers have no counters to place")
    rows = _oracle_rows(schedule, placement)
    t = faults.timeout_cycles.detach().cpu().numpy().astype(np.float32)
    depth = len(schedule.levels)
    if t.ndim == 0:
        timeout_row = np.full(depth, t, np.float32)
    else:
        timeout_row = np.full(depth, np.inf, np.float32)
        timeout_row[:min(depth, t.shape[0])] = t[:depth]
    q = float(faults.quorum_frac)

    walks = [_robust_episode(a, rows, cfg, hw, timeout_row, q)
             for a in flat]
    exits = torch.tensor(np.asarray([w[0] for w in walks], np.float32),
                         device=dev)
    oks = torch.tensor(np.stack([w[1] for w in walks]), device=dev)
    timed = torch.tensor([w[2] for w in walks], dtype=torch.int32,
                         device=dev)
    arr_t = torch.tensor(flat, device=dev)
    last = torch.where(torch.isfinite(arr_t), arr_t, -torch.inf).amax(-1)
    n_ok = oks.sum(dim=-1, dtype=torch.int32)
    abandoned = n - n_ok
    resid = torch.where(oks, exits[:, None] - arr_t, 0.0).mean(dim=-1)
    mean_res = resid * (n / n_ok.clamp(min=1).to(torch.float32))
    stat, act, idle = (torch.tensor(float(x), dtype=torch.float32,
                                    device=dev)
                       for x in schedule_energy_constants(
                           schedule, placement, cfg, energy_model))
    spec = faults.to(dev)
    energy = robust_episode_energy(
        stat, act, idle, n, mean_res, spec.e_timeout_poll,
        timed.to(torch.float32), spec.e_abandon,
        abandoned.to(torch.float32))
    return BarrierResult(
        exit_time=exits.reshape(batch),
        last_arrival=last.reshape(batch),
        span_cycles=(exits - last).reshape(batch),
        mean_residency=mean_res.reshape(batch),
        energy=energy.reshape(batch),
        completed=torch.isfinite(exits).reshape(batch),
        abandoned_pes=abandoned.reshape(batch),
        timed_out_levels=timed.reshape(batch),
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
