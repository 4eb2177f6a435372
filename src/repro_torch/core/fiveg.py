"""Model of the paper's 5G PUSCH application (Sec. 4.3, Fig. 7), port of
``repro.core.fiveg``.

OFDM demodulation = N_RX independent 4096-point radix-4 DIF FFTs, each
scheduled on a 256-PE subset (4 FFTs concurrently across the 1024-PE
cluster); every butterfly stage ends with a barrier.  Digital
beamforming = MATMUL of the (N_B x N_RX) coefficient matrix with the
FFT outputs, column-distributed over all 1024 PEs.

Barrier options (the paper's comparison, the hardware floor and the
tuned modes):

* ``central``       — global central-counter barrier after every stage;
* ``tree``          — global k-ary tree barrier after every stage;
* ``partial``       — k-ary tree over each 256-PE FFT subset only,
  global barrier only at the FFT->MATMUL dependency;
* ``hw``            — the hardware event-unit barrier on every barrier;
* ``tuned``         — global mixed-radix tree picked by the tuner
  (:mod:`repro_torch.core.tuning`) for the app's arrival scatter;
* ``tuned_partial`` — tuned tree over each FFT subset, tuned global
  tree at the dependency;
* ``placed``        — jointly tuned (schedule, counter placement) pair
  (:mod:`repro_torch.core.placement`);
* ``workload``      — stage and global barriers tuned separately, each
  on the arrival model of the epochs it closes
  (:func:`repro_torch.core.tuning.tune_for_arrivals`);
* ``pareto``        — as ``workload``, each barrier at the knee of its
  latency x energy front.

Tuned picks come from fixed-seed sweeps (``_TUNING_SEED``) and are kept
per design point for the life of the process; beneath that in-process
store each reads through the persistent on-disk schedule store
(:mod:`repro_torch.runtime.schedule_cache`) when ``REPRO_SCHEDULE_CACHE``
names a directory, so a fresh process serves a tuned mode without
re-running its sweep.  Inside :func:`tuning_server` the ``workload`` and
``pareto`` modes are resolved through a
:class:`repro_torch.runtime.serving.TuningServer` instead (the client
mode).

``faults=`` (a :class:`FiveGFaults`) runs the pipeline under persistent
PE fail-stops with timeout/quorum release on every barrier;
:func:`degradation_curve` sweeps the failure rate per mode.

The epoch loop runs on the device as a Python loop of batched core
calls; every epoch's arrival scatter is drawn up front in one batched
threefry call, bit for bit the reference's per-epoch draws.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from . import barrier, barrier_sim, placement, prng, tuning, workloads
from .barrier import FaultSpec, LevelTable, fault_spec
from .barrier_sim import core_fn
from .energy import DEFAULT_ENERGY, EnergyModel
from .topology import DEFAULT, TeraPoolConfig
from .xla_math import _fma


@dataclasses.dataclass(frozen=True)
class FiveGConfig:
    n_sc: int = 4096            # sub-carriers (FFT length)
    n_rx: int = 64              # antenna streams (FFTs to run)
    n_beams: int = 32           # output beams
    fft_pes: int = 256          # PEs sharing one FFT
    ffts_per_round: int = 4     # FFTs processed between two barriers
    # Per-PE cycles for one butterfly stage of one 4096-pt FFT on 256 PEs,
    # calibrated so the application reproduces the paper's 1.6x
    # tree-vs-central speedup and <=6.2% synchronization fraction.
    stage_cycles: float = 1000.0
    stage_jitter_frac: float = 0.10
    mac_cycles: float = 2.5     # beamforming MAC incl. row broadcast
    mm_jitter_frac: float = 0.05   # beamforming-epoch contention scatter

    @property
    def n_stages(self) -> int:
        return int(math.log(self.n_sc, 4))  # radix-4 DIF

    @property
    def epoch_work(self) -> float:
        """Per-PE cycles of one barrier-to-barrier epoch."""
        return self.stage_cycles * self.ffts_per_round

    @property
    def epoch_jitter(self) -> float:
        """Arrival scatter entering each stage barrier."""
        return self.stage_jitter_frac * self.epoch_work

    @property
    def concurrent_ffts(self) -> int:
        return 1024 // self.fft_pes  # 4 subsets

    @property
    def rounds(self) -> int:
        per_subset = self.n_rx // self.concurrent_ffts
        if per_subset % self.ffts_per_round:
            raise ValueError("ffts_per_round must divide FFTs per subset")
        return per_subset // self.ffts_per_round

    def mm_work(self, n_pes: int) -> float:
        """Per-PE cycles of the beamforming MATMUL epoch."""
        return self.n_beams * self.n_sc / n_pes * self.n_rx \
            * self.mac_cycles

    def mm_jitter(self, n_pes: int) -> float:
        """Arrival scatter entering the barrier that closes the
        beamforming epoch."""
        return self.mm_jitter_frac * self.mm_work(n_pes)


class FiveGResult(NamedTuple):
    total_cycles: torch.Tensor      # end-to-end parallel runtime
    sync_cycles: torch.Tensor       # mean per-PE cycles inside barriers
    sync_fraction: torch.Tensor     # sync_cycles / total_cycles
    serial_cycles: torch.Tensor     # single-Snitch-core runtime
    speedup_serial: torch.Tensor    # serial / parallel
    sync_energy: torch.Tensor       # pJ spent inside barriers, all PEs
    total_energy: torch.Tensor      # sync_energy + compute instruction pJ
    energy_fraction: torch.Tensor   # sync_energy / total_energy
    stage_schedule: str = ""        # stage barrier tree name
    global_schedule: str = ""       # FFT->MATMUL / global tree name
    # Degradation columns of ``faults=`` runs (trivial otherwise): the
    # mean fraction of PEs released per barrier episode, and the
    # watchdog releases over the whole pipeline.
    completion_rate: torch.Tensor | float = 1.0
    timed_out_levels: torch.Tensor | float = 0.0


@dataclasses.dataclass(frozen=True)
class FiveGFaults:
    """PE-failure mode of the 5G app: a persistent fail-stop mask drawn
    once per run (``fail_rate`` Bernoulli per PE under ``seed``) plus
    the timeout/quorum release policy every barrier then runs with, so
    that failed PEs degrade the throughput instead of deadlocking it."""

    fail_rate: float = 0.0
    timeout_cycles: float = 2000.0
    quorum_frac: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if not 0.0 <= float(self.fail_rate) < 1.0:
            raise ValueError(
                f"fail_rate must be in [0, 1), got {self.fail_rate}")


def _epoch_noise(keys: torch.Tensor, jitter, n: int) -> torch.Tensor:
    """Arrival scatter of one epoch per key: ``uniform(0, jitter)`` over
    the ``n`` PEs, shape ``keys.shape[:-1] + (n,)``."""
    return prng.uniform(keys, (n,), 0.0, jitter)


def _epoch_arrivals(key: torch.Tensor, start: torch.Tensor, work,
                    jitter, n: int) -> torch.Tensor:
    return start + work + _epoch_noise(key, jitter, n)


# Fixed seed for the tuner's Monte-Carlo arrival draws: tuning is part
# of the schedule construction, deterministic per design point.
_TUNING_SEED = 1023


def _prune(n_pes: int) -> str:
    """Subset trees (<= 256 PEs) search every composition; the full
    cluster the hierarchy-aligned ones (128 of 512)."""
    return "none" if n_pes <= 256 else "hierarchy"


@functools.lru_cache(maxsize=None)
def _tuned_schedule(n_pes: int, delay: float, partial_tree: bool,
                    cfg: TeraPoolConfig, device: str
                    ) -> barrier.BarrierSchedule:
    """Best mixed-radix composition for one uniform arrival scatter
    (read through the on-disk schedule store)."""
    from ..runtime import schedule_cache
    key = ("fiveg_tuned", int(n_pes), float(delay), bool(partial_tree),
           _prune(n_pes), repr(cfg))
    hit = schedule_cache.load(key)
    if hit is not None:
        return schedule_cache.decode_schedule(hit["schedule"], cfg)
    sched = tuning.best_schedule(
        prng.PRNGKey(_TUNING_SEED, device=device), n_pes, delay=delay,
        n_trials=8, cfg=cfg, prune=_prune(n_pes), partial=partial_tree)
    schedule_cache.store(key,
                         {"schedule": schedule_cache.encode_schedule(sched)})
    return sched


@functools.lru_cache(maxsize=None)
def _placed_schedule(n_pes: int, delay: float, cfg: TeraPoolConfig,
                     device: str) -> tuple:
    """Jointly tuned (schedule, placement) pair for one uniform arrival
    scatter: compositions crossed with every placement strategy (read
    through the on-disk schedule store)."""
    from ..runtime import schedule_cache
    key = ("fiveg_placed", int(n_pes), float(delay), _prune(n_pes),
           repr(cfg))
    hit = schedule_cache.load(key)
    if hit is not None:
        return schedule_cache.decode_pair(hit, cfg)
    sched, plc = tuning.best_placed_schedule(
        prng.PRNGKey(_TUNING_SEED, device=device), n_pes, delay=delay,
        n_trials=8, cfg=cfg, prune=_prune(n_pes))
    schedule_cache.store(key, schedule_cache.encode_pair(sched, plc))
    return sched, plc


def _epoch_arrival_models(app: FiveGConfig, cfg: TeraPoolConfig,
                          device) -> tuple:
    """The two fixed-seed arrival matrices the workload-conditioned
    modes tune on: the FFT stage model (8 trials) for the STAGE barrier,
    and for the GLOBAL barrier the zero-scatter FFT->MATMUL dependency
    (4 trials) stacked with the beamforming epoch (4 trials)."""
    n = cfg.n_pes
    keys = prng.split(prng.PRNGKey(_TUNING_SEED, device=device))
    stage_arr = workloads.arrival_batch(keys[0], "fiveg_fft_stage", (8, n),
                                        cfg=cfg, app=app)
    mm_arr = workloads.arrival_batch(keys[1], "fiveg_matmul_row", (4, n),
                                     cfg=cfg, app=app)
    return stage_arr, torch.cat([torch.zeros_like(mm_arr), mm_arr])


@functools.lru_cache(maxsize=None)
def _epoch_tuned_schedules(app: FiveGConfig, cfg: TeraPoolConfig,
                           objective: str, device: str) -> tuple:
    """(stage schedule, stage placement, global schedule, global
    placement) for the ``workload`` (``objective="cycles"``) and
    ``pareto`` (``"pareto"``) modes: each barrier tuned jointly with
    its counter placement on its own epochs' arrival model (read
    through the on-disk schedule store)."""
    from ..runtime import schedule_cache
    prune = _prune(cfg.n_pes)
    mode = "fiveg_workload" if objective == "cycles" else "fiveg_pareto"
    key = (mode, repr(app), prune, repr(cfg))
    hit = schedule_cache.load(key)
    if hit is not None:
        return (schedule_cache.decode_pair(hit["stage"], cfg)
                + schedule_cache.decode_pair(hit["global"], cfg))
    out = ()
    for arr in _epoch_arrival_models(app, cfg, device):
        sched, plc, _ = tuning.tune_for_arrivals(
            arr, cfg, prune=prune, placements=placement.STRATEGIES,
            objective=objective)
        out += (sched, plc)
    schedule_cache.store(key, {
        "stage": schedule_cache.encode_pair(*out[:2], objective=objective),
        "global": schedule_cache.encode_pair(*out[2:], objective=objective)})
    return out


# ---------------------------------------------------------------------------
# Tuning-server client mode: resolve the workload-conditioned sync modes
# through a long-lived repro_torch.runtime.serving.TuningServer instead
# of tuning inline — many app instances (or processes, via the shared
# schedule cache) then amortize ONE batched sweep dispatch.
# ---------------------------------------------------------------------------

_TUNING_SERVER = None


@contextlib.contextmanager
def tuning_server(server):
    """Route ``sync="workload"`` / ``sync="pareto"`` schedule
    resolution through ``server`` (a
    :class:`repro_torch.runtime.serving.TuningServer`) while the context
    is active.  The stage and global barrier requests share one trial
    count and tuning space, so the server fuses them into a single
    batched ``sweep_arrivals`` dispatch — and both answers carry full
    provenance (exact / cache / degraded)."""
    global _TUNING_SERVER
    prev = _TUNING_SERVER
    _TUNING_SERVER = server
    try:
        yield server
    finally:
        _TUNING_SERVER = prev


def _served_schedules(app: FiveGConfig, cfg: TeraPoolConfig,
                      objective: str) -> tuple:
    """Resolve the (stage, global) pairs through the installed server,
    their arrival models drawn on its device.  Both requests are
    submitted before either result is awaited, so they coalesce into
    one dispatch."""
    from ..runtime.serving import TuneRequest
    placements = tuple(placement.STRATEGIES)
    tickets = [_TUNING_SERVER.submit(TuneRequest(
        arrivals=arr, cfg=cfg, objective=objective, placements=placements))
        for arr in _epoch_arrival_models(app, cfg, _TUNING_SERVER.device)]
    rs, rg = (t.result() for t in tickets)
    for resp in (rs, rg):
        if not resp.ok:
            raise RuntimeError(
                f"tuning server failed the request: {resp.detail}")
    return rs.schedule, rs.placement, rg.schedule, rg.placement


def _resolve_schedules(app: FiveGConfig, sync: str, radix: int,
                       cfg: TeraPoolConfig, device: str):
    """Stage + global schedules, their counter placements (``None`` =
    span heuristic) and the partial-group count of a mode."""
    n = cfg.n_pes
    jitter = app.epoch_jitter
    stage_plc = global_plc = global_sched = None
    if sync == "central":
        stage_sched = barrier.central_counter(cfg=cfg)
        partial_groups = 1
    elif sync == "tree":
        stage_sched = barrier.kary_tree(radix, cfg=cfg)
        partial_groups = 1
    elif sync == "partial":
        stage_sched = barrier.partial_barrier(app.fft_pes, radix, cfg=cfg)
        partial_groups = n // app.fft_pes
    elif sync == "tuned":
        stage_sched = _tuned_schedule(n, jitter, False, cfg, device)
        partial_groups = 1
    elif sync == "tuned_partial":
        stage_sched = _tuned_schedule(app.fft_pes, jitter, True, cfg,
                                      device)
        partial_groups = n // app.fft_pes
    elif sync == "placed":
        stage_sched, stage_plc = _placed_schedule(n, jitter, cfg, device)
        global_sched, global_plc = stage_sched, stage_plc
        partial_groups = 1
    elif sync == "hw":
        stage_sched = barrier.hw_event_unit(cfg=cfg)
        global_sched = stage_sched
        partial_groups = 1
    elif sync in ("workload", "pareto"):
        objective = "cycles" if sync == "workload" else "pareto"
        if _TUNING_SERVER is not None:
            (stage_sched, stage_plc, global_sched,
             global_plc) = _served_schedules(app, cfg, objective)
        else:
            (stage_sched, stage_plc, global_sched,
             global_plc) = _epoch_tuned_schedules(app, cfg, objective,
                                                  device)
        partial_groups = 1
    else:
        raise ValueError(f"unknown sync mode {sync!r}")
    if sync in ("tuned", "tuned_partial"):
        global_sched = _tuned_schedule(n, jitter, False, cfg, device)
    elif global_sched is None:   # modes without their own global tree
        global_sched = barrier.kary_tree(min(radix, 32), cfg=cfg)
    return stage_sched, global_sched, partial_groups, stage_plc, global_plc


def _app_core(key: torch.Tensor, stage_table: LevelTable,
              global_table: LevelTable, epoch_work: torch.Tensor,
              jitter: torch.Tensor, mm_work: torch.Tensor,
              mm_jitter: torch.Tensor, *, n_epochs: int,
              partial_groups: int, n_pes: int,
              cfg: TeraPoolConfig, core: str,
              mask: torch.Tensor | None = None,
              spec: FaultSpec | None = None) -> tuple:
    """The epoch pipeline: ``n_epochs`` stage barriers, the
    FFT->beamforming barrier and the beamforming barrier.  Returns
    (total cycles, summed mean barrier residency, summed barrier
    energy) as float32 scalars on the tables' device.

    Under a fault ``spec`` every barrier runs the robust core, the
    persistent fail-stop ``mask`` turns its PEs' arrivals into ``+inf``
    at every barrier entry, and the result also carries the completion
    rate (mean fraction of PEs released per episode) and the watchdog
    releases, as float32."""
    robust = spec is not None
    sim = core_fn(core, robust=robust)
    dev = stage_table.group_sizes.device
    keys = prng.split(key.to(dev), n_epochs + 2)
    noise = _epoch_noise(keys[:n_epochs], jitter, n_pes)   # (E, n)
    if robust:
        spec = spec.to(dev)
    zero = functools.partial(torch.zeros, (), device=dev)
    sync_acc, energy_acc = zero(dtype=torch.float32), zero(dtype=torch.float32)
    ab_acc, t_acc = zero(dtype=torch.int32), zero(dtype=torch.int32)

    def barrier_at(arr, table, groups=1):
        """One barrier over ``arr`` in ``groups`` equal PE subsets;
        accumulates its residency, energy and degradation counts and
        returns every PE's exit."""
        nonlocal sync_acc, energy_acc, ab_acc, t_acc
        if robust:
            arr = torch.where(mask, torch.inf, arr)
        if groups > 1:
            arr = arr.reshape(groups, -1)
        res = (sim(arr, table, cfg, None, spec) if robust
               else sim(arr, table, cfg))
        if groups > 1:
            sync_acc = sync_acc + res.mean_residency.mean()
            energy_acc = energy_acc + res.energy.sum()
        else:
            sync_acc = sync_acc + res.mean_residency
            energy_acc = energy_acc + res.energy
        if robust:
            ab_acc = ab_acc + res.abandoned_pes.sum(dtype=torch.int32)
            t_acc = t_acc + res.timed_out_levels.sum(dtype=torch.int32)
        return res.exit_time

    t = torch.zeros((n_pes,), dtype=torch.float32, device=dev)
    for e in range(n_epochs):
        exit_time = barrier_at(t + epoch_work + noise[e], stage_table,
                               partial_groups)
        t = (exit_time.repeat_interleave(n_pes // partial_groups)
             if partial_groups > 1 else exit_time.expand(n_pes))

    # FFT -> beamforming data dependency: one global barrier.
    t = barrier_at(t, global_table).expand(n_pes)

    # Beamforming MATMUL: (N_B x N_RX) @ (N_RX x N_SC), column-wise over
    # all PEs; concurrent row reads -> moderate contention scatter.
    total = barrier_at(_epoch_arrivals(keys[n_epochs], t, mm_work,
                                       mm_jitter, n_pes), global_table)
    if not robust:
        return total, sync_acc, energy_acc
    # 1 - abandoned / PE-episodes as XLA compiles it: the division by
    # a constant becomes a product with its float32 reciprocal, fused
    # with the subtraction.
    per_episode = float(np.float32(1.0) / np.float32((n_epochs + 2) * n_pes))
    completion = _fma(ab_acc.to(torch.float32), -per_episode, 1.0)
    return (total, sync_acc, energy_acc, completion,
            t_acc.to(torch.float32))


def _compute_energy(app: FiveGConfig, n: int, n_epochs: int,
                    model: EnergyModel, device) -> torch.Tensor:
    """Instruction energy of the application's COMPUTE cycles (pJ), the
    arrival-independent denominator of ``energy_fraction``."""
    per_pe = n_epochs * app.epoch_work + app.mm_work(n)
    return torch.tensor(model.e_instr * n * per_pe, dtype=torch.float32,
                        device=device)


def _serial_cycles(app: FiveGConfig, device) -> torch.Tensor:
    """Single-core runtime (no barriers, same per-PE work model)."""
    fft_work = app.n_rx * app.n_stages * app.fft_pes * app.stage_cycles
    mm_serial = app.n_beams * app.n_sc * app.n_rx * app.mac_cycles
    return torch.tensor(fft_work + mm_serial, dtype=torch.float32,
                        device=device)


def _result(app, total, sync_acc, energy_acc, n_epochs, model, cfg,
            stage_sched, global_sched, stage_plc, global_plc,
            completion=1.0, timed=0.0) -> FiveGResult:
    dev = total.device
    serial = _serial_cycles(app, dev)
    total_energy = _compute_energy(app, cfg.n_pes, n_epochs, model, dev) \
        + energy_acc
    return FiveGResult(
        total_cycles=total,
        sync_cycles=sync_acc,
        sync_fraction=sync_acc / total,
        serial_cycles=serial,
        speedup_serial=serial / total,
        sync_energy=energy_acc,
        total_energy=total_energy,
        energy_fraction=energy_acc / total_energy,
        stage_schedule=barrier.schedule_name(stage_sched, stage_plc),
        global_schedule=barrier.schedule_name(global_sched, global_plc),
        completion_rate=completion,
        timed_out_levels=timed,
    )


def simulate_app(key: torch.Tensor, app: FiveGConfig = FiveGConfig(),
                 sync: str = "partial", radix: int = 32,
                 cfg: TeraPoolConfig = DEFAULT, *,
                 core: str | None = None,
                 energy_model: EnergyModel = DEFAULT_ENERGY,
                 faults: FiveGFaults | None = None,
                 device="cuda") -> FiveGResult:
    """Simulate the full OFDM + beamforming pipeline under one barrier
    strategy, on ``device``.  ``sync`` in {"central", "tree", "partial",
    "hw", "tuned", "tuned_partial", "placed", "workload", "pareto"};
    ``radix`` is ignored by all but the first three.  ``core`` selects
    the simulator implementation for every barrier; ``energy_model``
    prices the energy columns.  ``faults`` (a :class:`FiveGFaults`)
    runs every barrier on the robust cores under a persistent fail-stop
    mask and fills the ``completion_rate`` / ``timed_out_levels``
    columns; ``None`` runs the plain cores."""
    dev = resolve_device(device)
    n = cfg.n_pes
    (stage_sched, global_sched, partial_groups, stage_plc,
     global_plc) = _resolve_schedules(app, sync, radix, cfg, str(dev))
    stage_table = barrier.level_table(stage_sched, cfg=cfg,
                                      placement=stage_plc,
                                      energy_model=energy_model, device=dev)
    global_table = barrier.level_table(global_sched, cfg=cfg,
                                       placement=global_plc,
                                       energy_model=energy_model,
                                       device=dev)
    n_epochs = app.rounds * app.n_stages

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    args = (key, stage_table, global_table, f32(app.epoch_work),
            f32(app.epoch_jitter), f32(app.mm_work(n)),
            f32(app.mm_jitter(n)))
    static = dict(n_epochs=n_epochs, partial_groups=partial_groups,
                  n_pes=n, cfg=cfg, core=barrier_sim.resolve_core(core))
    if faults is None:
        total, sync_acc, energy_acc = _app_core(*args, **static)
        extra = ()
    else:
        mask = prng.bernoulli(prng.PRNGKey(faults.seed, device=dev),
                              faults.fail_rate, (n,))
        spec = fault_spec(timeout_cycles=faults.timeout_cycles,
                          quorum_frac=faults.quorum_frac,
                          energy_model=energy_model)
        total, sync_acc, energy_acc, *extra = _app_core(
            *args, mask=mask, spec=spec, **static)
    return _result(app, total, sync_acc, energy_acc, n_epochs, energy_model,
                   cfg, stage_sched, global_sched, stage_plc, global_plc,
                   *extra)


def degradation_curve(key: torch.Tensor,
                      fail_rates=(0.0, 0.005, 0.01, 0.02, 0.05),
                      app: FiveGConfig = FiveGConfig(),
                      modes: tuple = ("central", "tree", "hw"),
                      radix: int = 32,
                      cfg: TeraPoolConfig = DEFAULT, *,
                      core: str | None = None,
                      timeout_cycles: float = 2000.0,
                      quorum_frac: float = 1.0,
                      energy_model: EnergyModel = DEFAULT_ENERGY,
                      device="cuda") -> dict:
    """5G throughput against the PE-failure rate, per sync mode: one
    :class:`FiveGResult` per (mode, rate), the rate's fail-stop mask
    drawn under seed ``i`` for the ``i``-th rate.  Returns
    ``{"fail_rates": tuple, mode: [FiveGResult, ...]}`` with each list
    aligned to ``fail_rates``."""
    rates = tuple(float(r) for r in fail_rates)
    out: dict = {"fail_rates": rates}
    for mode in modes:
        out[mode] = [
            simulate_app(key, app, sync=mode, radix=radix, cfg=cfg,
                         core=core, energy_model=energy_model,
                         faults=FiveGFaults(fail_rate=r,
                                            timeout_cycles=timeout_cycles,
                                            quorum_frac=quorum_frac,
                                            seed=i),
                         device=device)
            for i, r in enumerate(rates)]
    return out


def simulate_app_reference(key: torch.Tensor,
                           app: FiveGConfig = FiveGConfig(),
                           sync: str = "partial", radix: int = 32,
                           cfg: TeraPoolConfig = DEFAULT, *,
                           device="cuda") -> FiveGResult:
    """The seed epoch loop over the per-level reference simulator, one
    key draw per epoch — the equivalence oracle for
    :func:`simulate_app`.  Placed barriers go through the per-bank-queue
    oracle of :mod:`repro_torch.core.placement`."""
    dev = resolve_device(device)
    n = cfg.n_pes
    (stage_sched, global_sched, partial_groups, stage_plc,
     global_plc) = _resolve_schedules(app, sync, radix, cfg, str(dev))

    def ref(arr, sched, plc):
        if plc is None:
            return barrier_sim.simulate_reference(arr, sched, cfg,
                                                  device=dev)
        return placement.simulate_placed_reference(arr, sched, plc, cfg,
                                                   device=dev)

    epoch_work = app.epoch_work
    jitter = app.epoch_jitter
    n_epochs = app.rounds * app.n_stages

    t = torch.zeros((n,), dtype=torch.float32, device=dev)
    sync_acc = torch.zeros((), dtype=torch.float32, device=dev)
    energy_acc = torch.zeros((), dtype=torch.float32, device=dev)

    keys = prng.split(key.to(dev), n_epochs + 2)
    for e in range(n_epochs):
        arr = _epoch_arrivals(keys[e], t, epoch_work, jitter, n)
        if partial_groups > 1:
            res = ref(arr.reshape(partial_groups, app.fft_pes), stage_sched,
                      stage_plc)
            t = res.exit_time.repeat_interleave(app.fft_pes)
            sync_acc = sync_acc + res.mean_residency.mean()
            energy_acc = energy_acc + res.energy.sum()
        else:
            res = ref(arr, stage_sched, stage_plc)
            t = res.exit_time.expand(n)
            sync_acc = sync_acc + res.mean_residency
            energy_acc = energy_acc + res.energy

    # FFT -> beamforming data dependency: one global barrier.
    res = ref(t, global_sched, global_plc)
    t = res.exit_time.expand(n)
    sync_acc = sync_acc + res.mean_residency
    energy_acc = energy_acc + res.energy

    # Beamforming MATMUL (see _app_core).
    arr = _epoch_arrivals(keys[-2], t, app.mm_work(n), app.mm_jitter(n), n)
    res = ref(arr, global_sched, global_plc)
    sync_acc = sync_acc + res.mean_residency
    energy_acc = energy_acc + res.energy
    return _result(app, res.exit_time, sync_acc, energy_acc, n_epochs,
                   DEFAULT_ENERGY, cfg, stage_sched, global_sched, stage_plc,
                   global_plc)


def compare_barriers(key: torch.Tensor, app: FiveGConfig = FiveGConfig(),
                     radix: int = 32,
                     cfg: TeraPoolConfig = DEFAULT,
                     modes: tuple = ("central", "tree", "partial"), *,
                     core: str | None = None, device="cuda") -> dict:
    """Fig. 7 comparison; returns per-strategy results plus per-mode
    speedups and sync-energy ratios over the central-counter
    baseline."""
    if "central" not in modes:
        raise ValueError("modes must include the 'central' baseline")
    out = {}
    for mode in modes:
        out[mode] = simulate_app(key, app, sync=mode, radix=radix, cfg=cfg,
                                 core=core, device=device)
    base = out["central"].total_cycles
    base_energy = out["central"].sync_energy
    for mode in modes:
        if mode != "central":
            out[f"speedup_{mode}"] = base / out[mode].total_cycles
            out[f"energy_ratio_{mode}"] = base_energy / out[mode].sync_energy
    return out
