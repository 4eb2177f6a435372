"""Bank-aware counter placement: WHERE every barrier counter lives (port
of ``repro.core.placement``).

The paper places barrier counters "local to contiguous PE blocks"
(Sec. 5).  This module makes the counter -> L1 bank mapping an explicit
design axis: sibling counters mapped to one bank contend, because their
atomics enter the same single-ported service queue, and each counter's
access latency follows from the locality class of the PEs that reach
it (``TeraPoolConfig.span_bank_latency``).

* :class:`CounterPlacement` — the bank and latency of every counter of
  every tree level.
* :func:`place_counters` — the named strategies of :data:`STRATEGIES`:
  ``leaf_local`` (the paper's policy; reproduces the span-heuristic
  1/3/5 per-level latencies bit for bit), ``tile_interleaved``
  (round-robin across Tiles), ``group_hub`` (one hub bank per Group)
  and ``central`` (every counter on bank 0).
* :func:`explicit_placement` — per-level ``(offset, stride)`` banks.
* :func:`simulate_placed_reference` — an independent numpy oracle that
  walks explicit per-bank request queues; the batched cores of
  :mod:`repro_torch.core.barrier_sim` are held to it bit for bit.

Placements are host-side tables: :func:`repro_torch.core.barrier.
level_table` copies their banks and latencies into the per-counter
columns of a :class:`~repro_torch.core.barrier.LevelTable`, so a placed
grid runs through the same batched core calls as an unplaced one.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from .._device import resolve_device
from .barrier import BarrierSchedule
from .topology import DEFAULT, TeraPoolConfig

# The named strategy set the tuner sweeps by default.
STRATEGIES: Tuple[str, ...] = ("leaf_local", "tile_interleaved",
                               "group_hub", "central")


@dataclasses.dataclass(frozen=True)
class CounterPlacement:
    """Concrete bank assignment for every counter of one schedule.

    ``banks[l][j]`` is the bank holding counter ``j`` of level ``l``
    (counter ``j`` serves the contiguous original-PE span
    ``[j * span_l, (j+1) * span_l)``); ``latencies[l][j]`` is the
    locality-class access latency its farthest accessor pays.  Frozen
    tuples keep the object hashable, so placed level tables cache like
    plain ones.
    """

    strategy: str
    banks: tuple       # tuple[tuple[int, ...], ...], one row per level
    latencies: tuple   # tuple[tuple[int, ...], ...], same shape

    @property
    def n_levels(self) -> int:
        return len(self.banks)

    def shared_bank_counters(self) -> Tuple[int, ...]:
        """Per level, how many counters share a bank with a sibling —
        the static contention exposure of this placement."""
        out = []
        for row in self.banks:
            _, counts = np.unique(np.asarray(row), return_counts=True)
            out.append(int(counts[counts > 1].sum()))
        return tuple(out)


def _counter_spans(schedule: BarrierSchedule) -> List[Tuple[int, int]]:
    """Per level: (span, n_counters)."""
    return [(lvl.span, schedule.n_pes // lvl.span)
            for lvl in schedule.levels]


def _banks_leaf_local(schedule: BarrierSchedule,
                      cfg: TeraPoolConfig) -> List[List[int]]:
    bf = cfg.banking_factor
    return [[j * span * bf for j in range(count)]
            for span, count in _counter_spans(schedule)]


def _banks_tile_interleaved(schedule: BarrierSchedule,
                            cfg: TeraPoolConfig) -> List[List[int]]:
    # Round-robin across the Tiles covered by the barrier, then across
    # each Tile's banks with word stride: the bank pattern of counters
    # allocated one after another from an interleaved heap.
    n_tiles = max(1, schedule.n_pes // cfg.pes_per_tile)
    local_banks = schedule.n_pes * cfg.banking_factor
    return [[((j % n_tiles) * cfg.banks_per_tile
              + (j // n_tiles) * cfg.banking_factor) % local_banks
             for j in range(count)]
            for _, count in _counter_spans(schedule)]


def _banks_group_hub(schedule: BarrierSchedule,
                     cfg: TeraPoolConfig) -> List[List[int]]:
    # Every counter lands on the hub bank (bank 0) of the Group holding
    # its span's first PE.
    return [[(j * span // cfg.pes_per_group) * cfg.banks_per_group
             for j in range(count)]
            for span, count in _counter_spans(schedule)]


def _banks_central(schedule: BarrierSchedule,
                   cfg: TeraPoolConfig) -> List[List[int]]:
    return [[0] * count for _, count in _counter_spans(schedule)]


_STRATEGY_FNS: Dict[str, Callable] = {
    "leaf_local": _banks_leaf_local,
    "tile_interleaved": _banks_tile_interleaved,
    "group_hub": _banks_group_hub,
    "central": _banks_central,
}


def derive_latencies(schedule: BarrierSchedule,
                     banks: Sequence[Sequence[int]],
                     cfg: TeraPoolConfig = DEFAULT) -> tuple:
    """Per-counter access latency from PE <-> bank locality classes:
    counter ``j`` of level ``l`` is reached by the survivors of its span
    ``[j * span_l, (j+1) * span_l)``, and the level charges the
    farthest accessor's class (``cfg.span_bank_latency``)."""
    rows = []
    for (span, count), brow in zip(_counter_spans(schedule), banks):
        if len(brow) != count:
            raise ValueError(
                f"level with span {span} has {count} counters, placement "
                f"maps {len(brow)}")
        rows.append(tuple(cfg.span_bank_latency(j * span, span, int(b))
                          for j, b in enumerate(brow)))
    return tuple(rows)


@functools.lru_cache(maxsize=None)
def place_counters(schedule: BarrierSchedule, strategy: str = "leaf_local",
                   cfg: TeraPoolConfig = DEFAULT) -> CounterPlacement:
    """Map every counter of ``schedule`` to a bank under a named
    strategy and derive the per-counter access latencies (cached per
    (schedule, strategy, cfg)).  Partial (subset) barriers are placed in
    subset-relative bank coordinates: the 256-PE FFT subsets are
    span-aligned, so relative locality classes equal absolute ones."""
    try:
        fn = _STRATEGY_FNS[strategy]
    except KeyError:
        raise ValueError(
            f"unknown placement strategy {strategy!r}; "
            f"choose from {STRATEGIES}") from None
    banks = fn(schedule, cfg)
    return CounterPlacement(
        strategy=strategy,
        banks=tuple(tuple(int(b) for b in row) for row in banks),
        latencies=derive_latencies(schedule, banks, cfg))


def explicit_placement(schedule: BarrierSchedule,
                       bank_offsets: Sequence[int],
                       bank_strides: Sequence[int] | None = None,
                       cfg: TeraPoolConfig = DEFAULT) -> CounterPlacement:
    """Explicit per-level banks: counter ``j`` of level ``l`` sits at
    ``(bank_offsets[l] + j * bank_strides[l]) % n_banks``.
    ``bank_strides`` defaults to the banking factor; a stride of 0
    piles every counter of a level onto one bank."""
    n_levels = schedule.n_levels
    if len(bank_offsets) != n_levels:
        raise ValueError(
            f"schedule has {n_levels} levels, got {len(bank_offsets)} "
            f"bank offsets")
    if bank_strides is None:
        bank_strides = [cfg.banking_factor] * n_levels
    if len(bank_strides) != n_levels:
        raise ValueError(
            f"schedule has {n_levels} levels, got {len(bank_strides)} "
            f"bank strides")
    banks = [[(int(off) + j * int(stride)) % cfg.n_banks
              for j in range(count)]
             for (_, count), off, stride in zip(_counter_spans(schedule),
                                                bank_offsets, bank_strides)]
    return CounterPlacement(
        strategy="explicit",
        banks=tuple(tuple(row) for row in banks),
        latencies=derive_latencies(schedule, banks, cfg))


def all_placements(schedule: BarrierSchedule,
                   strategies: Sequence[str] = STRATEGIES,
                   cfg: TeraPoolConfig = DEFAULT) -> List[CounterPlacement]:
    """One :class:`CounterPlacement` per named strategy."""
    return [place_counters(schedule, s, cfg) for s in strategies]


# ---------------------------------------------------------------------------
# Independent per-bank-queue oracle (numpy, for tests and spot checks).
# ---------------------------------------------------------------------------

def _placed_episode(arr: np.ndarray, schedule: BarrierSchedule,
                    pl: CounterPlacement, cfg: TeraPoolConfig) -> float:
    """One episode via explicit per-bank queues; returns the final
    survivor's ready time (float32 arithmetic, the cores' op order)."""
    svc = np.float32(cfg.bank_service_cycles)
    instr = np.float32(cfg.instr_per_level)
    ready = arr.astype(np.float32) + instr
    for lvl, brow, lrow in zip(schedule.levels, pl.banks, pl.latencies):
        g = lvl.group_size
        m = ready.shape[0]
        grp = np.arange(m) // g
        bank = np.asarray(brow, np.int64)[grp]
        done = np.empty(m // g, np.float32)
        for b in np.unique(bank):
            sel = np.nonzero(bank == b)[0]
            order = sel[np.argsort(ready[sel], kind="stable")]
            a = ready[order]
            r = np.arange(len(a), dtype=np.float32) * svc
            s = np.maximum.accumulate(a - r) + r   # service starts
            for gi in np.unique(grp[order]):
                mask = grp[order] == gi
                done[gi] = np.float32(s[mask].max()
                                      + np.float32(lrow[gi]))
        ready = done + instr
    return float(ready[0])


def simulate_placed_reference(arrivals, schedule: BarrierSchedule,
                              placement: CounterPlacement,
                              cfg: TeraPoolConfig = DEFAULT, *,
                              device="cuda"):
    """Placement-aware equivalence oracle for the batched cores.

    Walks the tree level by level with explicit per-bank request
    queues: all atomics mapped to one bank — across sibling counters —
    serialize in arrival order at ``bank_service_cycles`` apiece, and
    each counter's last arriver proceeds once its own request is
    serviced.  Numpy with per-episode Python loops, on the host; the
    result lands on ``device``."""
    from .barrier_sim import BarrierResult
    from .energy import (DEFAULT_ENERGY, episode_energy,
                         schedule_energy_constants)
    dev = resolve_device(device)
    arr = np.asarray(torch.as_tensor(arrivals).detach().cpu(), np.float32)
    if arr.shape[-1] != schedule.n_pes:
        raise ValueError(
            f"arrivals has {arr.shape[-1]} PEs, schedule expects "
            f"{schedule.n_pes}")
    batch = arr.shape[:-1]
    flat = arr.reshape((-1, arr.shape[-1]))
    wake = np.float32(cfg.wakeup_cycles)
    exits = np.asarray(
        [_placed_episode(a, schedule, placement, cfg) for a in flat],
        np.float32) + wake
    exit_time = torch.tensor(exits.reshape(batch), device=dev)
    arrivals_t = torch.tensor(flat, device=dev)
    last = arrivals_t.amax(dim=-1).reshape(batch)
    resid = (torch.tensor(exits, device=dev)[:, None]
             - arrivals_t).mean(dim=-1).reshape(batch)
    stat, act, idle = (torch.tensor(float(x), dtype=torch.float32,
                                    device=dev)
                       for x in schedule_energy_constants(
                           schedule, placement, cfg, DEFAULT_ENERGY))
    zeros = torch.zeros(batch, dtype=torch.int32, device=dev)
    return BarrierResult(
        exit_time=exit_time,
        last_arrival=last,
        span_cycles=exit_time - last,
        mean_residency=resid,
        energy=episode_energy(stat, act, idle, schedule.n_pes, resid),
        completed=torch.isfinite(exit_time),
        abandoned_pes=zeros,
        timed_out_levels=zeros,
    )
