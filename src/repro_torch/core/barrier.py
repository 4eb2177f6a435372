"""Barrier schedules and their padded level tables (port of
``repro.core.barrier``).

A *schedule* is the static structure of the arrival tree (Sec. 3 of the
paper): how many PEs synchronize per shared counter at every level, and
the locality class (hence latency) of each level's counters.  The
primitive is :func:`mixed_radix_tree`; central counters, k-ary trees,
partial barriers and the hardware event unit are points in its space.

A :class:`LevelTable` encodes a schedule as fixed-shape tensors padded
with identity levels, so every schedule over one cluster size has the
same shapes and a stack of them runs through the simulator cores as one
batch.  Tables are built on the host in numpy (cached per schedule) and
handed to the device as torch tensors; their dtypes are part of the
contract: int32 ``group_sizes``/``bank_ids``, float32 everything else.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from .._device import resolve_device
from .energy import DEFAULT_ENERGY, EnergyModel, schedule_energy_constants
from .topology import DEFAULT, TeraPoolConfig

@dataclasses.dataclass(frozen=True)
class Level:
    """One level of the arrival tree."""

    group_size: int   # PEs (survivors) sharing one counter at this level
    span: int         # contiguous original-PE span covered by one group
    latency: int      # access latency to this level's counters (cycles)


@dataclasses.dataclass(frozen=True)
class BarrierSchedule:
    """Static structure of one barrier instance.  ``radix`` is the
    uniform radix for k-ary trees and ``0`` for a mixed composition;
    ``hw`` marks a hardware event-unit barrier (:func:`hw_event_unit`)."""

    n_pes: int                 # PEs synchronized by this barrier
    radix: int
    levels: tuple              # tuple[Level, ...]
    partial: bool = False      # True if a subset-of-cluster barrier
    hw: bool = False           # True if a hardware event-unit barrier

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    @property
    def sizes(self) -> tuple:
        """Per-level group sizes, leaf level first."""
        return tuple(lvl.group_size for lvl in self.levels)

    @property
    def name(self) -> str:
        """Canonical name, e.g. ``"8x16x8"`` (see :func:`schedule_name`)."""
        return schedule_name(self)


def _check_size(x: int, name: str) -> None:
    """Level sizes are any integer >= 2 (non-power-of-two clusters
    factor into levels like 3 or 12)."""
    if x < 2:
        raise ValueError(f"{name} must be an integer >= 2, got {x}")


def mixed_radix_tree(sizes: Sequence[int], n_pes: int | None = None,
                     cfg: TeraPoolConfig = DEFAULT, *,
                     partial: bool = False) -> BarrierSchedule:
    """The arrival tree with per-level group ``sizes`` (leaf level
    first).  Per-level spans are cumulative products of the sizes; each
    level's counter latency follows from the locality class of its span
    (``cfg.access_latency``)."""
    sizes = tuple(int(g) for g in sizes)
    if not sizes:
        raise ValueError("schedule needs at least one level")
    for g in sizes:
        _check_size(g, "level size")
    n = math.prod(sizes)
    if n_pes is not None and int(n_pes) != n:
        raise ValueError(
            f"level sizes {sizes} cover {n} PEs, expected {n_pes}")
    if n > cfg.n_pes:
        raise ValueError(f"schedule spans {n} PEs, cluster has {cfg.n_pes}")

    levels: List[Level] = []
    span = 1
    for g in sizes:
        span *= g
        levels.append(Level(group_size=g, span=span,
                            latency=cfg.access_latency(span)))

    # A single uniform k describes the tree iff every level past the
    # first is the same size k and the (possibly adapted) first level is
    # no larger — the exact shape kary_tree produces.
    tail = sizes[-1]
    uniform = all(g == tail for g in sizes[1:]) and sizes[0] <= tail
    return BarrierSchedule(n_pes=n, radix=tail if uniform else 0,
                           levels=tuple(levels), partial=partial)


def kary_tree(radix: int, n_pes: int | None = None,
              cfg: TeraPoolConfig = DEFAULT, *,
              partial: bool = False) -> BarrierSchedule:
    """The uniform-radix arrival tree for ``n_pes`` cores: ``e`` tail
    levels of exactly ``radix`` (the largest ``e`` with ``radix**e``
    dividing ``N``) under an adapted first level over the leftover
    ``N / radix**e`` PEs (paper Sec. 3)."""
    n = int(n_pes if n_pes is not None else cfg.n_pes)
    k = int(radix)
    _check_size(n, "n_pes")
    _check_size(k, "radix")
    if k > n:
        raise ValueError(f"radix {k} exceeds n_pes {n}")

    e = 0
    while n % (k ** (e + 1)) == 0:
        e += 1
    if e == 0:
        raise ValueError(f"radix {k} does not divide n_pes {n}")
    first = n // (k ** e)
    sizes: List[int] = ([k] * e if first == 1 else [first] + [k] * e)
    return mixed_radix_tree(sizes, n_pes=n, cfg=cfg, partial=partial)


def central_counter(n_pes: int | None = None,
                    cfg: TeraPoolConfig = DEFAULT) -> BarrierSchedule:
    """Linear central-counter barrier: every PE hits one shared counter."""
    n = int(n_pes if n_pes is not None else cfg.n_pes)
    return mixed_radix_tree((n,), cfg=cfg)


def partial_barrier(group_pes: int, radix: int,
                    cfg: TeraPoolConfig = DEFAULT) -> BarrierSchedule:
    """Barrier over a contiguous subset of ``group_pes`` cores (the
    selective Group/Tile wakeup registers of Fig. 1b)."""
    if group_pes > cfg.n_pes:
        raise ValueError("partial barrier larger than the cluster")
    return kary_tree(radix, n_pes=group_pes, cfg=cfg, partial=True)


def _hw_segments(n: int, cfg: TeraPoolConfig) -> tuple:
    """Aggregation-stage sizes of the event unit over ``n`` PEs: the
    Tile / Group / cluster fan-in hierarchy, greedily factored; any
    leftover factor becomes one final stage."""
    dims = [cfg.pes_per_tile, cfg.tiles_per_group, cfg.n_groups]
    if getattr(cfg, "n_clusters", 1) > 1:
        dims.append(cfg.n_clusters)
    rem = int(n)
    segs: List[int] = []
    for d in dims:
        g = math.gcd(rem, d)
        if g > 1:
            segs.append(g)
            rem //= g
    if rem > 1:
        segs.append(rem)
    return tuple(segs) if segs else (1,)


def hw_event_unit(n_pes: int | None = None,
                  cfg: TeraPoolConfig = DEFAULT) -> BarrierSchedule:
    """The hardware synchronization/event-unit barrier of Glaser et al.
    (arXiv 2004.06662): one trigger-register store per PE, a
    combinational aggregation stage per ``cfg.hw_level_cycles``, no
    counter atomics and no per-level software path."""
    n = int(n_pes if n_pes is not None else cfg.n_pes)
    _check_size(n, "n_pes")
    if n > cfg.n_pes:
        raise ValueError(f"schedule spans {n} PEs, cluster has {cfg.n_pes}")
    levels: List[Level] = []
    span = 1
    for g in _hw_segments(n, cfg):
        span *= g
        levels.append(Level(group_size=g, span=span,
                            latency=cfg.hw_stage_latency(span)))
    return BarrierSchedule(n_pes=n, radix=0, levels=tuple(levels), hw=True)


def all_radices(n_pes: int | None = None,
                cfg: TeraPoolConfig = DEFAULT) -> Sequence[int]:
    """Every valid uniform radix: the divisors >= 2 of ``N``."""
    n = int(n_pes if n_pes is not None else cfg.n_pes)
    return [k for k in range(2, n + 1) if n % k == 0]


def compose(*schedules: BarrierSchedule,
            cfg: TeraPoolConfig = DEFAULT,
            partial: bool = False) -> BarrierSchedule:
    """Stack schedules leaf-to-root into one tree over the product of
    their PE counts: the level sizes concatenate, and spans and
    latencies are re-derived for the combined hierarchy."""
    if not schedules:
        raise ValueError("compose needs at least one schedule")
    sizes: List[int] = []
    for s in schedules:
        sizes.extend(lvl.group_size for lvl in s.levels)
    return mixed_radix_tree(sizes, cfg=cfg, partial=partial)


def schedule_name(schedule: BarrierSchedule, placement=None) -> str:
    """Canonical, sortable name: level sizes joined leaf-to-root
    (``"8x16x8"``), ``hw``-prefixed for the event unit, ``p``-suffixed
    for partial barriers and ``@strategy``-suffixed when a counter
    placement is attached (``"8x16x8@leaf_local"``)."""
    base = "x".join(str(g) for g in schedule.sizes)
    base = ("hw" + base) if schedule.hw else base
    base += "p" if schedule.partial else ""
    return base + (f"@{placement.strategy}" if placement else "")


def describe(schedule: BarrierSchedule) -> str:
    """One-line human description of a schedule's structure."""
    kind = ("hardware event unit" if schedule.hw
            else "central counter" if schedule.n_levels == 1
            and schedule.levels[0].group_size == schedule.n_pes
            else f"radix-{schedule.radix} tree" if schedule.radix
            else "mixed-radix tree")
    spans = ",".join(str(lvl.span) for lvl in schedule.levels)
    lats = ",".join(str(lvl.latency) for lvl in schedule.levels)
    part = " (partial)" if schedule.partial else ""
    return (f"{schedule_name(schedule)}: {kind} over {schedule.n_pes} "
            f"PEs{part}, spans [{spans}], latencies [{lats}]")


# ---------------------------------------------------------------------------
# Padded level tables.
# ---------------------------------------------------------------------------

class LevelTable(NamedTuple):
    """Dense, fixed-shape encoding of a :class:`BarrierSchedule`.

    Every tree over ``n_pes`` cores fits in ``log2(n_pes)`` levels, so
    padding each table to that depth gives every schedule of one
    cluster size the same shapes.  Padding levels are the identity —
    group size 1, zero latency, zero software overhead, distinct banks —
    and appear only as a tail (:func:`validate_tail_padding`).
    ``latencies`` and ``bank_ids`` are per-COUNTER columns of width
    ``G = counter_width(n_pes)``.  Fields may carry leading batch
    dimensions (:func:`stack_tables`); the simulator cores broadcast
    them against the arrivals' batch dimensions.
    """

    group_sizes: torch.Tensor    # (..., L) int32, 1 past the real depth
    latencies: torch.Tensor      # (..., L, G) float32 per counter
    instr_cycles: torch.Tensor   # (..., L) float32, 0 past the real depth
    bank_ids: torch.Tensor       # (..., L, G) int32 counter -> bank
    service_cycles: torch.Tensor  # (..., L) float32 bank service interval
    entry_instr: torch.Tensor    # (...) float32 barrier-entry software path
    energy_static: torch.Tensor  # (...) float32 pJ, arrival-independent
    active_cycles: torch.Tensor  # (...) float32 episode instruction cycles
    idle_power: torch.Tensor     # (...) float32 pJ per idle PE-cycle

    @property
    def max_levels(self) -> int:
        return self.group_sizes.shape[-1]

    @property
    def max_counters(self) -> int:
        return self.bank_ids.shape[-1]


_TABLE_DTYPES = {"group_sizes": torch.int32, "bank_ids": torch.int32}


def validate_tail_padding(table: LevelTable, *,
                          full: bool = True) -> LevelTable:
    """Assert that identity padding (group size 1, zero latency, zero
    software overhead) appears only as a contiguous TAIL after the real
    levels — the invariant the telescoping core's survivor bound rests
    on.  ``full=False`` checks the group-size column only.  Returns the
    table unchanged."""
    depth = table.group_sizes.shape[-1]
    sizes = table.group_sizes.detach().cpu().numpy().reshape((-1, depth))
    pad = sizes == 1
    bad = pad[:, :-1] & ~pad[:, 1:]
    if np.any(bad):
        row, lvl = (int(x) for x in np.argwhere(bad)[0])
        raise ValueError(
            f"level table row {row} has identity padding (group size 1) "
            f"at level {lvl} before a real level {lvl + 1} (group size "
            f"{int(sizes[row, lvl + 1])}); canonical tables are "
            f"tail-padded only — build them with "
            f"level_table()/stack_tables()")
    if not full:
        return table
    width = table.latencies.shape[-1]
    lat = table.latencies.detach().cpu().numpy().reshape((-1, depth, width))
    ins = table.instr_cycles.detach().cpu().numpy().reshape((-1, depth))
    bad = pad & (np.any(lat != 0.0, axis=-1) | (ins != 0.0))
    if np.any(bad):
        row, lvl = (int(x) for x in np.argwhere(bad)[0])
        raise ValueError(
            f"level table row {row}, padding level {lvl} (of width "
            f"{width}): identity padding levels must carry zero latency "
            f"and zero instruction overhead")
    return table


def max_depth(n_pes: int) -> int:
    """Depth of the deepest tree over ``n_pes`` cores (radix 2)."""
    return max(1, int(math.log2(n_pes)))


def counter_width(n_pes: int) -> int:
    """Most counters any level of a tree over ``n_pes`` cores can have."""
    return max(1, n_pes // 2)


def default_widths(n_pes: int, depth: int) -> tuple:
    """The conservative per-step telescope widths ``max(1, N >> i)``,
    valid for any canonical table over ``n_pes`` cores."""
    return tuple(max(1, n_pes >> i) for i in range(depth + 1))


def telescope_widths(table: LevelTable, n_pes: int) -> tuple:
    """Exact per-step entry widths for the telescoping core: entry ``i``
    is the largest live count entering step ``i`` over all stacked rows,
    ``N // (g_0 * ... * g_{i-1})`` (the cumulative quotient).  Reads the
    group sizes on the host."""
    n = int(n_pes)
    depth = table.group_sizes.shape[-1]
    sizes = table.group_sizes.detach().cpu().numpy().astype(
        np.int64).reshape((-1, depth))
    cum = np.cumprod(sizes, axis=1)
    widths = [n]
    for i in range(depth):
        widths.append(int(max(1, np.max(n // cum[:, i]))))
    return tuple(widths)


@functools.lru_cache(maxsize=None)
def _level_arrays(schedule: BarrierSchedule, max_levels: int,
                  cfg: TeraPoolConfig, placement,
                  energy_model: EnergyModel) -> dict:
    """The table of one schedule as numpy arrays (host side, cached)."""
    n = schedule.n_pes
    width = counter_width(n)
    sizes = [lvl.group_size for lvl in schedule.levels]
    if schedule.hw:
        if placement is not None:
            raise ValueError(
                "hardware event-unit barriers have no counters to place")
        # The event unit has no software level path and no bank
        # serialization: signals aggregate combinationally per stage.
        instr = [0.0] * len(sizes)
        svc = [0.0] * len(sizes)
        entry = float(cfg.hw_entry_instr)
    else:
        instr = [float(cfg.instr_per_level)] * len(sizes)
        svc = [float(cfg.bank_service_cycles)] * len(sizes)
        entry = float(cfg.instr_per_level)
    pad = max_levels - len(sizes)
    if pad < 0:
        raise ValueError(
            f"schedule has {len(sizes)} levels, max_levels={max_levels}")

    if placement is None:
        # Span-heuristic latencies (paper leaf-local): one latency per
        # level broadcast across its counters, one distinct bank each.
        lat_rows = [[float(lvl.latency)] * width for lvl in schedule.levels]
        bank_rows = [[j * lvl.span * cfg.banking_factor
                      for j in range(width)] for lvl in schedule.levels]
    else:
        if placement.n_levels != len(sizes):
            raise ValueError(
                f"placement maps {placement.n_levels} levels, schedule "
                f"has {len(sizes)}")
        # Unused counter columns: zero latency and banks past every real
        # bank (and distinct), so phantom counters never contend.
        sentinel = cfg.n_pes * cfg.banking_factor
        lat_rows, bank_rows = [], []
        for lvl, lrow, brow in zip(schedule.levels, placement.latencies,
                                   placement.banks):
            count = n // lvl.span
            if len(brow) != count:
                raise ValueError(
                    f"level with span {lvl.span} has {count} counters, "
                    f"placement maps {len(brow)}")
            lat_rows.append(list(map(float, lrow)) + [0.0] * (width - count))
            bank_rows.append(list(brow)
                             + [sentinel + j for j in range(count, width)])
    # Padding levels: zero latency and distinct identity banks.
    lat_rows += [[0.0] * width] * pad
    bank_rows += [list(range(width))] * pad

    stat, act, idle = schedule_energy_constants(schedule, placement, cfg,
                                                energy_model)
    return {
        "group_sizes": np.asarray(sizes + [1] * pad, np.int32),
        "latencies": np.asarray(lat_rows, np.float32),
        "instr_cycles": np.asarray(instr + [0.0] * pad, np.float32),
        "bank_ids": np.asarray(bank_rows, np.int32),
        "service_cycles": np.asarray(svc + [0.0] * pad, np.float32),
        "entry_instr": np.float32(entry),
        "energy_static": np.float32(stat),
        "active_cycles": np.float32(act),
        "idle_power": np.float32(idle),
    }


def level_table_from_arrays(arrays: dict, *, device="cuda") -> LevelTable:
    """A :class:`LevelTable` from its fields as numpy arrays (for
    example the reference package's table, converted field by field),
    in the contract dtypes, on ``device``."""
    dev = resolve_device(device)
    return LevelTable(**{
        f: torch.tensor(np.asarray(arrays[f]),
                        dtype=_TABLE_DTYPES.get(f, torch.float32),
                        device=dev)
        for f in LevelTable._fields})


def level_table(schedule: BarrierSchedule, max_levels: int | None = None,
                cfg: TeraPoolConfig = DEFAULT, *, placement=None,
                energy_model: EnergyModel = DEFAULT_ENERGY,
                device="cuda") -> LevelTable:
    """Encode ``schedule`` as a padded :class:`LevelTable` on ``device``.

    ``max_levels`` defaults to ``log2(schedule.n_pes)`` so that every
    power-of-two radix over one cluster shares one table shape.
    ``placement`` (a :class:`~repro_torch.core.placement.
    CounterPlacement`) supplies per-counter banks and latencies; ``None``
    keeps the span heuristic with conflict-free banks."""
    if max_levels is None:
        max_levels = max_depth(schedule.n_pes)
    arrays = _level_arrays(schedule, int(max_levels), cfg, placement,
                           energy_model)
    return validate_tail_padding(
        level_table_from_arrays(arrays, device=device))


def stack_tables(schedules: Sequence[BarrierSchedule],
                 cfg: TeraPoolConfig = DEFAULT,
                 placements: Sequence | None = None,
                 energy_model: EnergyModel = DEFAULT_ENERGY, *,
                 device="cuda") -> LevelTable:
    """Stack the tables of same-``n_pes`` schedules along a new leading
    axis, so the cores simulate the whole stack as one batch.
    ``placements`` aligns with ``schedules``; ``None`` entries use the
    span heuristic."""
    if not schedules:
        raise ValueError("no schedules to stack")
    n = schedules[0].n_pes
    if any(s.n_pes != n for s in schedules):
        raise ValueError("stacked schedules must share n_pes")
    if placements is None:
        placements = [None] * len(schedules)
    if len(placements) != len(schedules):
        raise ValueError(
            f"{len(schedules)} schedules but {len(placements)} placements")
    depth = max(max_depth(n), max(s.n_levels for s in schedules))
    rows = [_level_arrays(s, depth, cfg, p, energy_model)
            for s, p in zip(schedules, placements)]
    stacked = {f: np.stack([r[f] for r in rows]) for f in LevelTable._fields}
    return validate_tail_padding(
        level_table_from_arrays(stacked, device=device), full=False)


# ---------------------------------------------------------------------------
# Degradation-tolerant release semantics: timeout and quorum barriers.
# ---------------------------------------------------------------------------

class FaultSpec(NamedTuple):
    """Release semantics of a degradation-tolerant barrier, as tensor
    data: new thresholds change values, never the launch sequence.

    Every counter of every level releases at

        ``release = min(quorum_done, first_serviced + timeout_cycles)``

    * **quorum**: a counter over ``g`` children releases once
      ``ceil(quorum_frac * g)`` of them have been serviced (K-of-N
      release; ``quorum_frac == 1.0`` is the classical barrier).
    * **timeout**: a watchdog armed when the counter services its FIRST
      child forces release ``timeout_cycles`` later (the
      hardware-synchronizer bound of Glaser et al., arXiv 2004.06662);
      ``+inf`` disables it.

    Children still missing at release are *abandoned* and counted in
    ``abandoned_pes``.  With ``timeout = +inf`` and ``quorum_frac = 1``
    the robust cores give the plain cores' results bit for bit.
    ``timeout_cycles`` is a scalar or a per-level row aligned with the
    PADDED level index of the table it runs against.  The tensors live
    on the CPU; the cores copy them to the arrivals' device."""

    timeout_cycles: torch.Tensor  # () or (L,) float32, +inf = never
    quorum_frac: torch.Tensor     # () float32 in (0, 1]
    e_timeout_poll: torch.Tensor  # () float32 pJ per watchdog release
    e_abandon: torch.Tensor       # () float32 pJ per abandoned PE

    def to(self, device) -> "FaultSpec":
        """The spec with every tensor on ``device``."""
        return FaultSpec(*(t.to(device) for t in self))


def fault_spec(timeout_cycles=math.inf, quorum_frac=1.0,
               energy_model: EnergyModel = DEFAULT_ENERGY) -> FaultSpec:
    """Build a :class:`FaultSpec`, validating the thresholds: timeouts
    must be ``>= 0`` and the quorum fraction in ``(0, 1]``."""
    t = torch.as_tensor(np.asarray(timeout_cycles, np.float32))
    q = torch.as_tensor(np.asarray(quorum_frac, np.float32))
    if t.dim() > 1:
        raise ValueError(
            f"timeout_cycles must be a scalar or a per-level row, got "
            f"shape {tuple(t.shape)}")
    if bool((t < 0).any()):
        raise ValueError(f"timeout_cycles must be >= 0, got {t}")
    if not bool(((q > 0) & (q <= 1)).all()):
        raise ValueError(f"quorum_frac must be in (0, 1], got {q}")
    return FaultSpec(t, q,
                     torch.tensor(energy_model.e_timeout_poll,
                                  dtype=torch.float32),
                     torch.tensor(energy_model.e_abandon,
                                  dtype=torch.float32))


def __getattr__(name: str):
    """``NO_FAULTS``, the degenerate spec, built at first use."""
    if name == "NO_FAULTS":
        spec = fault_spec()
        globals()["NO_FAULTS"] = spec
        return spec
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
