"""Model of the paper's 5G PUSCH application (Sec. 4.3, Fig. 7), port of
``repro.core.fiveg`` (plain sync modes).

OFDM demodulation = N_RX independent 4096-point radix-4 DIF FFTs, each
scheduled on a 256-PE subset (4 FFTs concurrently across the 1024-PE
cluster); every butterfly stage ends with a barrier.  Digital
beamforming = MATMUL of the (N_B x N_RX) coefficient matrix with the
FFT outputs, column-distributed over all 1024 PEs.

Barrier options ported here (the paper's comparison plus the hardware
floor):

* ``central`` — global central-counter barrier after every stage;
* ``tree``    — global k-ary tree barrier after every stage;
* ``partial`` — k-ary tree over each 256-PE FFT subset only, global
  barrier only at the FFT->MATMUL dependency;
* ``hw``      — the hardware event-unit barrier on every barrier.

The tuner-driven modes (``tuned``, ``tuned_partial``, ``placed``,
``workload``, ``pareto``) raise :class:`NotImplementedError` until the
tuner is ported (ROADMAP.md §1 items 1, 5 and 7).

The epoch loop runs on the device as a Python loop of batched core
calls; every epoch's arrival scatter is drawn up front in one batched
threefry call, bit for bit the reference's per-epoch draws.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from .._device import resolve_device
from . import barrier, barrier_sim, prng
from .barrier import LevelTable
from .barrier_sim import core_fn
from .energy import DEFAULT_ENERGY, EnergyModel
from .topology import DEFAULT, TeraPoolConfig

_TUNER_TODO = {
    "tuned": "§1 item 7 (core/tuning.py)",
    "tuned_partial": "§1 item 7 (core/tuning.py)",
    "placed": "§1 items 1 and 7 (core/placement.py, core/tuning.py)",
    "workload": "§1 items 5 and 7 (core/workloads.py, core/tuning.py)",
    "pareto": "§1 items 5 and 7 (core/workloads.py, core/tuning.py)",
}


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
    completion_rate: float = 1.0    # fault-free runs release every PE
    timed_out_levels: float = 0.0   # and never time out


def _epoch_noise(keys: torch.Tensor, jitter, n: int) -> torch.Tensor:
    """Arrival scatter of one epoch per key: ``uniform(0, jitter)`` over
    the ``n`` PEs, shape ``keys.shape[:-1] + (n,)``."""
    return prng.uniform(keys, (n,), 0.0, jitter)


def _epoch_arrivals(key: torch.Tensor, start: torch.Tensor, work,
                    jitter, n: int) -> torch.Tensor:
    return start + work + _epoch_noise(key, jitter, n)


def _resolve_schedules(app: FiveGConfig, sync: str, radix: int,
                       cfg: TeraPoolConfig):
    """Stage + global schedules and the partial-group count of a mode."""
    n = cfg.n_pes
    global_sched = None
    if sync == "central":
        stage_sched = barrier.central_counter(cfg=cfg)
        partial_groups = 1
    elif sync == "tree":
        stage_sched = barrier.kary_tree(radix, cfg=cfg)
        partial_groups = 1
    elif sync == "partial":
        stage_sched = barrier.partial_barrier(app.fft_pes, radix, cfg=cfg)
        partial_groups = n // app.fft_pes
    elif sync == "hw":
        stage_sched = barrier.hw_event_unit(cfg=cfg)
        global_sched = stage_sched
        partial_groups = 1
    elif sync in _TUNER_TODO:
        raise NotImplementedError(
            f"sync mode {sync!r} needs modules not ported yet: "
            f"ROADMAP.md {_TUNER_TODO[sync]}")
    else:
        raise ValueError(f"unknown sync mode {sync!r}")
    if global_sched is None:   # modes without their own global tree
        global_sched = barrier.kary_tree(min(radix, 32), cfg=cfg)
    return stage_sched, global_sched, partial_groups


def _app_core(key: torch.Tensor, stage_table: LevelTable,
              global_table: LevelTable, epoch_work: torch.Tensor,
              jitter: torch.Tensor, mm_work: torch.Tensor,
              mm_jitter: torch.Tensor, *, n_epochs: int,
              partial_groups: int, n_pes: int,
              cfg: TeraPoolConfig, core: str) -> tuple:
    """The epoch pipeline: ``n_epochs`` stage barriers, the
    FFT->beamforming barrier and the beamforming barrier.  Returns
    (total cycles, summed mean barrier residency, summed barrier
    energy) as float32 scalars on the tables' device."""
    sim = core_fn(core)
    dev = stage_table.group_sizes.device
    keys = prng.split(key.to(dev), n_epochs + 2)
    noise = _epoch_noise(keys[:n_epochs], jitter, n_pes)   # (E, n)
    fft_pes = n_pes // partial_groups

    t = torch.zeros((n_pes,), dtype=torch.float32, device=dev)
    sync_acc = torch.zeros((), dtype=torch.float32, device=dev)
    energy_acc = torch.zeros((), dtype=torch.float32, device=dev)
    for e in range(n_epochs):
        arr = t + epoch_work + noise[e]
        if partial_groups > 1:
            res = sim(arr.reshape(partial_groups, fft_pes), stage_table, cfg)
            t = res.exit_time.repeat_interleave(fft_pes)
            sync_acc = sync_acc + res.mean_residency.mean()
            energy_acc = energy_acc + res.energy.sum()
        else:
            res = sim(arr, stage_table, cfg)
            t = res.exit_time.expand(n_pes)
            sync_acc = sync_acc + res.mean_residency
            energy_acc = energy_acc + res.energy

    # FFT -> beamforming data dependency: one global barrier.
    res = sim(t, global_table, cfg)
    t = res.exit_time.expand(n_pes)
    sync_acc = sync_acc + res.mean_residency
    energy_acc = energy_acc + res.energy

    # Beamforming MATMUL: (N_B x N_RX) @ (N_RX x N_SC), column-wise over
    # all PEs; concurrent row reads -> moderate contention scatter.
    arr = _epoch_arrivals(keys[n_epochs], t, mm_work, mm_jitter, n_pes)
    res = sim(arr, global_table, cfg)
    return (res.exit_time, sync_acc + res.mean_residency,
            energy_acc + res.energy)


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
            stage_sched, global_sched) -> FiveGResult:
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
        stage_schedule=barrier.schedule_name(stage_sched),
        global_schedule=barrier.schedule_name(global_sched),
    )


def simulate_app(key: torch.Tensor, app: FiveGConfig = FiveGConfig(),
                 sync: str = "partial", radix: int = 32,
                 cfg: TeraPoolConfig = DEFAULT, *,
                 core: str | None = None,
                 energy_model: EnergyModel = DEFAULT_ENERGY,
                 faults=None, device="cuda") -> FiveGResult:
    """Simulate the full OFDM + beamforming pipeline under one barrier
    strategy, on ``device``.  ``sync`` in {"central", "tree", "partial",
    "hw"}; ``radix`` is ignored by ``hw``.  ``core`` selects the
    simulator implementation for every barrier; ``energy_model`` prices
    the energy columns.  ``faults`` must be ``None`` (ROADMAP.md §1
    item 4)."""
    if faults is not None:
        raise NotImplementedError(barrier_sim._FAULTS_TODO)
    dev = resolve_device(device)
    n = cfg.n_pes
    stage_sched, global_sched, partial_groups = _resolve_schedules(
        app, sync, radix, cfg)
    stage_table = barrier.level_table(stage_sched, cfg=cfg,
                                      energy_model=energy_model, device=dev)
    global_table = barrier.level_table(global_sched, cfg=cfg,
                                       energy_model=energy_model,
                                       device=dev)
    n_epochs = app.rounds * app.n_stages

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    total, sync_acc, energy_acc = _app_core(
        key, stage_table, global_table, f32(app.epoch_work),
        f32(app.epoch_jitter), f32(app.mm_work(n)), f32(app.mm_jitter(n)),
        n_epochs=n_epochs, partial_groups=partial_groups, n_pes=n, cfg=cfg,
        core=barrier_sim.resolve_core(core))
    return _result(app, total, sync_acc, energy_acc, n_epochs, energy_model,
                   cfg, stage_sched, global_sched)


def simulate_app_reference(key: torch.Tensor,
                           app: FiveGConfig = FiveGConfig(),
                           sync: str = "partial", radix: int = 32,
                           cfg: TeraPoolConfig = DEFAULT, *,
                           device="cuda") -> FiveGResult:
    """The seed epoch loop over the per-level reference simulator, one
    key draw per epoch — the equivalence oracle for
    :func:`simulate_app`."""
    dev = resolve_device(device)
    n = cfg.n_pes
    stage_sched, global_sched, partial_groups = _resolve_schedules(
        app, sync, radix, cfg)

    def ref(arr, sched):
        return barrier_sim.simulate_reference(arr, sched, cfg, device=dev)

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
            res = ref(arr.reshape(partial_groups, app.fft_pes), stage_sched)
            t = res.exit_time.repeat_interleave(app.fft_pes)
            sync_acc = sync_acc + res.mean_residency.mean()
            energy_acc = energy_acc + res.energy.sum()
        else:
            res = ref(arr, stage_sched)
            t = res.exit_time.expand(n)
            sync_acc = sync_acc + res.mean_residency
            energy_acc = energy_acc + res.energy

    # FFT -> beamforming data dependency: one global barrier.
    res = ref(t, global_sched)
    t = res.exit_time.expand(n)
    sync_acc = sync_acc + res.mean_residency
    energy_acc = energy_acc + res.energy

    # Beamforming MATMUL (see _app_core).
    arr = _epoch_arrivals(keys[-2], t, app.mm_work(n), app.mm_jitter(n), n)
    res = ref(arr, global_sched)
    sync_acc = sync_acc + res.mean_residency
    energy_acc = energy_acc + res.energy
    return _result(app, res.exit_time, sync_acc, energy_acc, n_epochs,
                   DEFAULT_ENERGY, cfg, stage_sched, global_sched)


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
