"""Exhaustive tuning over the mixed-radix schedule space (port of
``repro.core.tuning``).

The paper's headline 1.6x comes from *fine-tuning* the synchronization
tree to the machine hierarchy (Sec. 5): the best schedule for TeraPool
is often not a uniform radix but a composition matched to the 8/16/8
Tile/Group/Cluster structure.

* :func:`enumerate_compositions` / :func:`hierarchy_compositions` —
  every ordered factorization of ``N`` (512 at N = 1024), or only those
  whose level spans land on Tile/Group boundaries (128).
* :func:`tune_barrier` — every composition (x counter-placement
  strategy) x delay x trial as one batched sweep
  (:func:`repro_torch.core.sweep.sweep_schedules`).
* :func:`best_per_delay`, :func:`pareto_schedules`,
  :func:`pareto_front`, :func:`knee_point` — selection: the argmin per
  delay against the best uniform radix, and the non-dominated designs
  over delays and over the latency x energy plane.
* :func:`sweep_workloads`, :func:`best_per_kernel`,
  :func:`tune_for_workload`, :func:`tune_for_arrivals` — the same grid
  driven by each kernel's measured arrival distribution
  (:mod:`repro_torch.core.workloads`); :func:`tuned_for_workload` is the
  in-process schedule store keyed on (kernel, N, cfg).

Because the uniform radices (and the paper's leaf-local placement) are
a subset of the enumeration, the tuned best can only match or beat the
best uniform radix on the arrivals it was tuned on (claim C6).
"""
from __future__ import annotations

import functools
import math
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from . import barrier, placement as placement_mod, prng, sweep
from . import workloads as workloads_mod
from .barrier import BarrierSchedule
from .placement import CounterPlacement
from .topology import DEFAULT, TeraPoolConfig

_ROBUST_TODO = ("fault models and the completion objective need the "
                "robust cores, not ported yet (ROADMAP.md §1 item 4)")


def enumerate_compositions(n_pes: int | None = None,
                           cfg: TeraPoolConfig = DEFAULT
                           ) -> List[Tuple[int, ...]]:
    """All ordered factorizations of ``N`` into level sizes >= 2, leaf
    level first, in lexicographic order (``2**(log2(N) - 1)`` entries
    for power-of-two ``N``).  Every k-ary tree shape and the central
    counter ``(N,)`` appear among them."""
    n = int(n_pes if n_pes is not None else cfg.n_pes)
    if n < 2:
        raise ValueError(f"n_pes must be >= 2, got {n}")

    def facts(remaining: int):
        if remaining == 1:
            yield ()
            return
        for f in range(2, remaining + 1):
            if remaining % f:
                continue
            for rest in facts(remaining // f):
                yield (f,) + rest

    return list(facts(n))


def _hier_segments(n: int, cfg: TeraPoolConfig) -> List[int]:
    """Locality-class segment sizes of ``n`` PEs, leaf first: Tile
    share, Group share, cluster share — topped by the cluster count on a
    multi-cluster machine that ``n`` spans."""
    top: List[int] = []
    ppc = getattr(cfg, "pes_per_cluster", n)
    if getattr(cfg, "n_clusters", 1) > 1 and n > ppc and n % ppc == 0:
        top = [n // ppc]
        n = ppc
    t = math.gcd(n, cfg.pes_per_tile)
    g = math.gcd(n // t, cfg.tiles_per_group)
    c = n // (t * g)
    return [s for s in (t, g, c) if s > 1] + top


def hierarchy_compositions(n_pes: int | None = None,
                           cfg: TeraPoolConfig = DEFAULT
                           ) -> List[Tuple[int, ...]]:
    """The hierarchy-aware pruned space: compositions whose cumulative
    spans include every Tile/Group (and cluster) boundary inside ``N``
    — the product of per-segment compositions, 4 x 8 x 4 = 128 for the
    full 8/16/8 cluster."""
    n = int(n_pes if n_pes is not None else cfg.n_pes)
    segs = _hier_segments(n, cfg)
    if not segs:
        return [(n,)] if n > 1 else []

    def seg_parts(size: int):
        return enumerate_compositions(size, cfg) if size > 1 else [()]

    def product(i: int):
        if i == len(segs):
            yield ()
            return
        for head in seg_parts(segs[i]):
            for rest in product(i + 1):
                yield head + rest

    return list(product(0))


def all_schedules(n_pes: int | None = None,
                  cfg: TeraPoolConfig = DEFAULT, *,
                  prune: str = "none",
                  partial: bool = False) -> List[BarrierSchedule]:
    """The search space as schedules; ``prune`` in {"none",
    "hierarchy"}."""
    if prune == "none":
        comps = enumerate_compositions(n_pes, cfg)
    elif prune == "hierarchy":
        comps = hierarchy_compositions(n_pes, cfg)
    else:
        raise ValueError(f"unknown prune mode {prune!r}")
    return [barrier.mixed_radix_tree(c, cfg=cfg, partial=partial)
            for c in comps]


def tune_barrier(key: torch.Tensor, n_pes: int | None = None,
                 delays: Sequence[float] = (0.0, 128.0, 512.0, 2048.0),
                 n_trials: int = 16, cfg: TeraPoolConfig = DEFAULT, *,
                 prune: str = "none",
                 schedules: Sequence[BarrierSchedule] | None = None,
                 placements: Sequence[str] | None = None,
                 core: str | None = None,
                 trial_chunk: int | None = None,
                 faults=None) -> sweep.SweepResult:
    """Sweep the mixed-radix design space (or ``schedules``) x delay x
    trial on ``key``'s device.  ``placements`` — strategy names from
    :data:`repro_torch.core.placement.STRATEGIES` — crosses every
    composition with every strategy (the result's ``schedules`` and
    ``placements`` align entry for entry)."""
    if schedules is None:
        schedules = all_schedules(n_pes, cfg, prune=prune)
    scheds, placs = _cross_placements(schedules, placements, cfg)
    return sweep.sweep_schedules(key, scheds, delays, n_trials, cfg,
                                 placements=placs, core=core,
                                 trial_chunk=trial_chunk, faults=faults,
                                 device=key.device)


def _cross_placements(schedules: Sequence[BarrierSchedule],
                      placements: Sequence[str] | None,
                      cfg: TeraPoolConfig) -> tuple:
    """Cross a schedule stack with named placement strategies into
    aligned (schedules, placements) stacks, strategy-major; event-unit
    schedules join once, unplaced.  ``None`` passes the stack through."""
    if placements is None:
        return tuple(schedules), None
    for strat in placements:
        if not isinstance(strat, str):
            raise TypeError(
                "placements must be strategy names; pass explicit "
                "CounterPlacements through sweep.sweep_schedules")
    scheds: List[BarrierSchedule] = []
    placs: List[CounterPlacement | None] = []
    for strat in placements:
        for s in schedules:
            if not s.hw:
                scheds.append(s)
                placs.append(placement_mod.place_counters(s, strat, cfg))
    for s in schedules:
        if s.hw:
            scheds.append(s)
            placs.append(None)
    return scheds, placs


class TunedPoint(NamedTuple):
    """The winning schedule (+ placement) at one arrival scatter."""

    delay: float
    schedule: BarrierSchedule
    mean_span: float              # its Fig. 4a metric
    uniform_schedule: BarrierSchedule   # best uniform radix at this delay
    uniform_span: float
    placement: object = None      # CounterPlacement | None of the winner


def _is_baseline(plc) -> bool:
    """Placements equivalent to the paper's model (span heuristic or
    explicit leaf-local) qualify as the uniform baseline."""
    return plc is None or plc.strategy == "leaf_local"


def _uniform_baseline(res) -> Tuple[tuple, List[int]]:
    """The per-point placements of a sweep result plus the indices of
    its baseline-placed uniform-radix schedules."""
    placs = res.placements or (None,) * len(res.schedules)
    uniform = [i for i, s in enumerate(res.schedules)
               if s.radix and _is_baseline(placs[i])]
    if not uniform:
        raise ValueError(
            "schedule stack contains no baseline-placed uniform radix")
    return placs, uniform


def _column_winners(col: np.ndarray, uniform: List[int]) -> Tuple[int, int]:
    """(overall argmin, argmin among the uniform baseline) of one span
    column (first index on ties)."""
    i = int(np.argmin(col))
    iu = uniform[int(np.argmin(col[uniform]))]
    return i, iu


def _mean_spans(res) -> np.ndarray:
    """(S, columns) float32 mean span over trials, on the host."""
    return res.span_cycles.mean(dim=-1).cpu().numpy()


def best_per_delay(res: sweep.SweepResult) -> List[TunedPoint]:
    """The argmin-span (schedule, placement) at each delay, paired with
    the best uniform radix under the paper's leaf-local placement at
    that delay (the Fig. 4a baseline)."""
    spans = _mean_spans(res)
    placs, uniform = _uniform_baseline(res)
    out = []
    for j, delay in enumerate(res.delays.tolist()):
        col = spans[:, j]
        i, iu = _column_winners(col, uniform)
        out.append(TunedPoint(
            delay=float(delay), schedule=res.schedules[i],
            mean_span=float(col[i]),
            uniform_schedule=res.schedules[iu],
            uniform_span=float(col[iu]),
            placement=placs[i]))
    return out


_OBJECTIVE_GRIDS = ("cycles", "energy", "p99_cycles", "worst_cycles",
                    "completion")


def _objective_grid(res, objective: str) -> np.ndarray:
    """(S, columns) selection metric on the host: mean span
    (``"cycles"``), mean episode energy (``"energy"``), their product
    (``"edp"``), the 99th-percentile span over trials with ``"lower"``
    interpolation (``"p99_cycles"``) or the worst span
    (``"worst_cycles"``).  ``"completion"`` counts abandoned PEs, which
    needs the robust cores, and raises."""
    sp = res.span_cycles.mean(dim=-1)
    if objective == "cycles":
        return sp.cpu().numpy()
    if objective == "p99_cycles":
        trials = res.span_cycles.shape[-1]
        k = int(math.floor(0.99 * (trials - 1)))
        return res.span_cycles.sort(dim=-1).values[..., k].cpu().numpy()
    if objective == "worst_cycles":
        return res.span_cycles.amax(dim=-1).cpu().numpy()
    if objective == "completion":
        raise NotImplementedError(_ROBUST_TODO)
    en = res.energy.mean(dim=-1)
    if objective == "energy":
        return en.cpu().numpy()
    if objective == "edp":
        return (sp * en).cpu().numpy()
    raise ValueError(
        f"unknown objective {objective!r}; choose from "
        f"('cycles', 'energy', 'edp', 'p99_cycles', 'worst_cycles', "
        f"'completion')")


def pareto_schedules(res: sweep.SweepResult,
                     objectives: Sequence[str] = ("cycles",)
                     ) -> List[BarrierSchedule]:
    """Schedules on the Pareto front across delays (and objectives): no
    other schedule is at least as good in every (delay, objective)
    column and strictly better in one."""
    cols = []
    for obj in objectives:
        if obj not in _OBJECTIVE_GRIDS:
            raise ValueError(
                f"unknown objective {obj!r}; choose from "
                f"{_OBJECTIVE_GRIDS}")
        cols.append(_objective_grid(res, obj))
    sp = np.concatenate(cols, axis=1)     # (S, D * n_objectives)
    keep = []
    for i in range(sp.shape[0]):
        dominated = np.any(np.all(sp <= sp[i], axis=1)
                           & np.any(sp < sp[i], axis=1))
        if not dominated:
            keep.append(res.schedules[i])
    return keep


class ParetoPoint(NamedTuple):
    """One non-dominated (schedule, placement) design point of the 2-D
    latency x energy front at a single delay/kernel column."""

    schedule: BarrierSchedule
    placement: object             # CounterPlacement | None
    name: str                     # canonical label incl. @strategy
    mean_span: float              # cycles (Fig. 4a metric)
    mean_energy: float            # pJ per episode


def pareto_front(res, column: int = 0) -> List[ParetoPoint]:
    """The 2-D latency x energy Pareto front at one delay or kernel
    column, sorted fastest-first: every point no other point beats on
    both mean span and mean energy (with one strict)."""
    sp = _mean_spans(res)[:, column]
    en = res.energy.mean(dim=-1).cpu().numpy()[:, column]
    placs = res.placements or (None,) * len(res.schedules)
    names = res.names
    front = []
    for i in range(sp.shape[0]):
        dominated = np.any((sp <= sp[i]) & (en <= en[i])
                           & ((sp < sp[i]) | (en < en[i])))
        if not dominated:
            front.append(ParetoPoint(
                schedule=res.schedules[i], placement=placs[i],
                name=names[i], mean_span=float(sp[i]),
                mean_energy=float(en[i])))
    return sorted(front, key=lambda p: (p.mean_span, p.mean_energy))


def knee_point(front: Sequence[ParetoPoint]) -> ParetoPoint:
    """The knee of a 2-D latency x energy front: the point closest (in
    min-max-normalized Euclidean distance) to the utopia corner."""
    if not front:
        raise ValueError("empty Pareto front")
    if len(front) == 1:
        return front[0]
    sp = np.array([p.mean_span for p in front], np.float64)
    en = np.array([p.mean_energy for p in front], np.float64)
    ns = (sp - sp.min()) / ((sp.max() - sp.min()) or 1.0)
    ne = (en - en.min()) / ((en.max() - en.min()) or 1.0)
    return front[int(np.argmin(np.hypot(ns, ne)))]


class TunedColumn(NamedTuple):
    """Per-kernel-column winner of a batched arrival sweep under one
    objective."""

    schedule: BarrierSchedule
    placement: object             # CounterPlacement | None
    name: str
    mean_span: float
    mean_energy: float


def best_for_arrival_stack(res, objectives) -> List[TunedColumn]:
    """Per-kernel winners of one batched ``sweep_arrivals`` grid, each
    column selected under its own objective (``"cycles"``,
    ``"energy"``, ``"edp"`` or ``"pareto"``, the knee of the 2-D
    front).  ``objectives`` is one string or one entry per column."""
    n_cols = len(res.kernels)
    if isinstance(objectives, str):
        objectives = (objectives,) * n_cols
    if len(objectives) != n_cols:
        raise ValueError(
            f"{len(objectives)} objectives for {n_cols} kernel columns")
    sp = _mean_spans(res)
    en = res.energy.mean(dim=-1).cpu().numpy()
    placs = res.placements or (None,) * len(res.schedules)
    names = res.names
    out = []
    for j, obj in enumerate(objectives):
        if obj == "pareto":
            p = knee_point(pareto_front(res, column=j))
            out.append(TunedColumn(p.schedule, p.placement, p.name,
                                   p.mean_span, p.mean_energy))
            continue
        i = int(np.argmin(_objective_grid(res, obj)[:, j]))
        out.append(TunedColumn(res.schedules[i], placs[i], names[i],
                               float(sp[i, j]), float(en[i, j])))
    return out


def best_schedule(key: torch.Tensor, n_pes: int | None = None,
                  delay: float = 0.0, n_trials: int = 16,
                  cfg: TeraPoolConfig = DEFAULT, *,
                  prune: str = "none", partial: bool = False,
                  core: str | None = None,
                  objective: str = "cycles") -> BarrierSchedule:
    """The single tuned schedule for one uniform arrival scatter (the 5G
    ``sync="tuned"`` modes use it), by ``objective``."""
    schedules = all_schedules(n_pes, cfg, prune=prune, partial=partial)
    res = tune_barrier(key, n_pes, delays=(delay,), n_trials=n_trials,
                       cfg=cfg, schedules=schedules, core=core)
    i = int(np.argmin(_objective_grid(res, objective)[:, 0]))
    return schedules[i]


def best_placed_schedule(key: torch.Tensor, n_pes: int | None = None,
                         delay: float = 0.0, n_trials: int = 16,
                         cfg: TeraPoolConfig = DEFAULT, *,
                         prune: str = "none", partial: bool = False,
                         placements: Sequence[str] = placement_mod.STRATEGIES,
                         core: str | None = None,
                         objective: str = "cycles"
                         ) -> Tuple[BarrierSchedule, CounterPlacement]:
    """The jointly tuned (schedule, placement) pair for one uniform
    arrival scatter: composition x strategy in one sweep (the 5G
    ``sync="placed"`` mode uses it)."""
    schedules = all_schedules(n_pes, cfg, prune=prune, partial=partial)
    res = tune_barrier(key, n_pes, delays=(delay,), n_trials=n_trials,
                       cfg=cfg, schedules=schedules, placements=placements,
                       core=core)
    i = int(np.argmin(_objective_grid(res, objective)[:, 0]))
    return res.schedules[i], res.placements[i]


# ---------------------------------------------------------------------------
# Workload-conditioned tuning: measured arrival distributions as the
# tuning axis (the Fig. 5/6 kernels + the 5G epochs), not uniform delays.
# ---------------------------------------------------------------------------

class WorkloadPoint(NamedTuple):
    """The winning schedule (+ placement) for one kernel's measured
    arrival distribution."""

    kernel: str
    schedule: BarrierSchedule
    mean_span: float              # its Fig. 4a metric on these arrivals
    uniform_schedule: BarrierSchedule   # best baseline-placed uniform radix
    uniform_span: float
    placement: object = None      # CounterPlacement | None of the winner


def sweep_workloads(key: torch.Tensor, kernels: Sequence[str] | None = None,
                    n_pes: int | None = None, n_trials: int = 8,
                    cfg: TeraPoolConfig = DEFAULT, *,
                    prune: str = "none",
                    schedules: Sequence[BarrierSchedule] | None = None,
                    placements: Sequence[str] | None = None,
                    core: str | None = None,
                    trial_chunk: int | None = None,
                    faults=None,
                    fault_model=None) -> sweep.ArrivalSweepResult:
    """Sweep every kernel's measured arrival distribution across the
    schedule (x placement) stack, on ``key``'s device.  Each kernel
    (default: the Fig. 5/6 suite, :data:`repro_torch.core.workloads.
    FIG6_KERNELS`) contributes an ``(n_trials, N)`` batch under its own
    key split.  ``fault_model`` and ``faults`` need the robust cores
    (ROADMAP.md §1 item 4) and raise."""
    if fault_model is not None:
        raise NotImplementedError(_ROBUST_TODO)
    n = int(n_pes if n_pes is not None else cfg.n_pes)
    if kernels is None:
        kernels = workloads_mod.FIG6_KERNELS
    kernels = tuple(kernels)
    if not kernels:
        raise ValueError("need at least one kernel to sweep")
    keys = prng.split(key, len(kernels))
    arrivals = torch.stack([
        workloads_mod.arrival_batch(k, kernel, (n_trials, n), cfg=cfg)
        for k, kernel in zip(keys, kernels)])
    if schedules is None:
        schedules = all_schedules(n, cfg, prune=prune)
    scheds, placs = _cross_placements(schedules, placements, cfg)
    return sweep.sweep_arrivals(arrivals, scheds, cfg, placements=placs,
                                kernels=kernels, core=core,
                                trial_chunk=trial_chunk, faults=faults)


def best_per_kernel(res: sweep.ArrivalSweepResult) -> List[WorkloadPoint]:
    """The argmin-span (schedule, placement) for each kernel's measured
    arrivals, paired with the best baseline-placed uniform radix on the
    same arrivals (the Fig. 6 per-kernel baseline)."""
    spans = _mean_spans(res)
    placs, uniform = _uniform_baseline(res)
    out = []
    for j, kernel in enumerate(res.kernels):
        col = spans[:, j]
        i, iu = _column_winners(col, uniform)
        out.append(WorkloadPoint(
            kernel=str(kernel), schedule=res.schedules[i],
            mean_span=float(col[i]),
            uniform_schedule=res.schedules[iu],
            uniform_span=float(col[iu]),
            placement=placs[i]))
    return out


def tune_for_workload(key: torch.Tensor, kernel: str,
                      n_pes: int | None = None, n_trials: int = 8,
                      cfg: TeraPoolConfig = DEFAULT, *,
                      prune: str = "none",
                      placements: Sequence[str] | None = None,
                      core: str | None = None) -> WorkloadPoint:
    """Tune one kernel: its arrival batch through the full schedule
    (x placement) stack, argmin by mean span — which can only match or
    beat both the best uniform radix and :func:`best_per_delay`'s pick
    when all are evaluated on this kernel's own arrivals (C6)."""
    res = sweep_workloads(key, (kernel,), n_pes, n_trials, cfg,
                          prune=prune, placements=placements, core=core)
    return best_per_kernel(res)[0]


def tune_for_arrivals(arrivals, cfg: TeraPoolConfig = DEFAULT, *,
                      prune: str = "none", partial: bool = False,
                      schedules: Sequence[BarrierSchedule] | None = None,
                      placements: Sequence[str] | None = None,
                      core: str | None = None,
                      objective: str = "cycles") -> tuple:
    """The winning (schedule, placement, mean_span) for an explicit
    ``(n_trials, N)`` arrival matrix (e.g. a trace of one 5G epoch), by
    ``objective`` (``"cycles"``, ``"energy"``, ``"edp"`` or
    ``"pareto"``); the float is always the winner's mean span."""
    arrivals = torch.as_tensor(arrivals, dtype=torch.float32)
    if arrivals.ndim == 1:
        arrivals = arrivals[None]
    if arrivals.ndim != 2:
        raise ValueError(
            f"expected an (n_trials, n_pes) arrival matrix, got shape "
            f"{tuple(arrivals.shape)}")
    n = arrivals.shape[-1]
    if schedules is None:
        schedules = all_schedules(n, cfg, prune=prune, partial=partial)
    scheds, placs = _cross_placements(schedules, placements, cfg)
    res = sweep.sweep_arrivals(arrivals, scheds, cfg, placements=placs,
                               core=core)
    win = best_for_arrival_stack(res, (objective,))[0]
    return win.schedule, win.placement, win.mean_span


# Fixed seed for the workload tuner's arrival draws: tuning is part of
# the schedule construction, deterministic per (kernel, N, cfg).
_WORKLOAD_TUNING_SEED = 65


@functools.lru_cache(maxsize=None)
def tuned_for_workload(kernel: str, n_pes: int | None = None,
                       cfg: TeraPoolConfig = DEFAULT, *,
                       prune: str = "none", n_trials: int = 8,
                       placements: Tuple[str, ...] | None = None,
                       device="cuda") -> tuple:
    """The winning (schedule, placement) for ``kernel`` at ``(n_pes,
    cfg)``, tuned once under a fixed seed and kept for the life of the
    process (an in-process store; the reference's optional on-disk
    layer is not ported)."""
    p = tune_for_workload(prng.PRNGKey(_WORKLOAD_TUNING_SEED, device=device),
                          kernel, n_pes, n_trials, cfg, prune=prune,
                          placements=placements)
    return p.schedule, p.placement
