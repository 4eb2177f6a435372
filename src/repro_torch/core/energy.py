"""Per-barrier energy accounting (port of ``repro.core.energy``, plain
part).

An episode's energy is a *static* part fixed by the schedule, machine
config and cost model, plus an idle-wait part proportional to the time
PEs spend inside the barrier:

    energy = energy_static
             + idle_power * (n * mean_residency - active_cycles)

The static part and the episode's active instruction-cycle count are
host-side scalars (:func:`schedule_energy_constants`, float64 rounded
once to float32) carried in the :class:`~repro_torch.core.barrier.
LevelTable`; the dynamic part is computed from ``mean_residency`` in
:func:`episode_energy`.  The JAX reference compiles that formula so XLA
contracts it into fused multiply-adds; eager torch does not, so the
energy column matches the reference to a relative 1e-6, not bit for
bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .topology import DEFAULT, TeraPoolConfig


@dataclasses.dataclass(frozen=True)
class EnergyModel:
    """Per-event energy costs (pJ) and idle power (pJ/cycle), scaled to
    22FDX-class numbers after Glaser et al. (arXiv 2004.06662): chosen
    for realistic *ratios*, not absolute calibration.  Frozen and
    hashable so a model can key the level-table cache like the config
    does."""

    e_instr: float = 1.0        # pJ / active instruction cycle
    e_amo_issue: float = 15.0   # pJ / atomic round trip incl. bank RMW
    e_amo_hop: float = 1.5      # pJ / cycle of interconnect distance
    e_hw_signal: float = 0.4    # pJ / event-unit arrival signal
    e_hw_hop: float = 0.2      # pJ / cycle of signal distance
    e_wakeup_write: float = 12.0   # pJ, wakeup-register write (AXI)
    e_wakeup_line: float = 0.6     # pJ / PE wakeup-line toggle
    e_wfi_wake: float = 5.0        # pJ / WFI resume of one core
    p_wfi: float = 0.002       # pJ / cycle, clock-gated in WFI / stalled
    p_poll: float = 0.6        # pJ / cycle, spin-polling the counter
    sleep: str = "wfi"         # "wfi" | "poll"
    # Degradation-tolerant barriers (timeout/quorum release).
    e_timeout_poll: float = 8.0   # pJ / level released by watchdog
    e_abandon: float = 25.0       # pJ / abandoned PE (cleanup traffic)

    @property
    def idle_power(self) -> float:
        """pJ per idle PE-cycle under the selected wait policy."""
        if self.sleep not in ("wfi", "poll"):
            raise ValueError(
                f"unknown sleep policy {self.sleep!r}; 'wfi' or 'poll'")
        return self.p_wfi if self.sleep == "wfi" else self.p_poll


DEFAULT_ENERGY = EnergyModel()


def _level_counts(schedule):
    """Per level: (level, survivors entering, counters)."""
    m = schedule.n_pes
    out = []
    for lvl in schedule.levels:
        count = m // lvl.group_size
        out.append((lvl, m, count))
        m = count
    return out


def schedule_energy_constants(schedule, placement=None,
                              cfg: TeraPoolConfig = DEFAULT,
                              model: EnergyModel = DEFAULT_ENERGY
                              ) -> tuple:
    """The three per-episode scalars the simulator cores carry in the
    level table: ``(energy_static, active_cycles, idle_power)``.

    Computed in float64 and rounded ONCE to float32, exactly as the
    reference does, so the table columns are bit-for-bit the
    reference's.  ``placement`` prices each counter's atomics at its
    placement-derived access latency.
    """
    n = schedule.n_pes
    hw = bool(getattr(schedule, "hw", False))
    if hw and placement is not None:
        raise ValueError(
            "hardware event-unit barriers have no counters to place")
    if hw:
        active = float(n * cfg.hw_entry_instr)
        traffic = sum(
            m * (model.e_hw_signal + model.e_hw_hop * lvl.latency)
            for lvl, m, _ in _level_counts(schedule))
    else:
        active = float(n * cfg.instr_per_level)
        traffic = 0.0
        for li, (lvl, m, count) in enumerate(_level_counts(schedule)):
            lats = (np.asarray(placement.latencies[li], np.float64)
                    if placement is not None
                    else np.full(count, float(lvl.latency)))
            traffic += lvl.group_size * (
                model.e_amo_issue * count + model.e_amo_hop * lats.sum())
            active += count * cfg.instr_per_level

    wakeup = model.e_wakeup_write + n * model.e_wakeup_line
    if model.sleep == "wfi":
        wakeup += (n - 1) * model.e_wfi_wake

    static = model.e_instr * active + traffic + wakeup
    return (np.float32(static), np.float32(active),
            np.float32(model.idle_power))


def episode_energy(energy_static: torch.Tensor, active_cycles: torch.Tensor,
                   idle_power: torch.Tensor, n_pes: int,
                   mean_residency: torch.Tensor) -> torch.Tensor:
    """The shared energy formula: static events + idle leakage over the
    PE-cycles spent waiting (total residency minus active cycles).
    float32 throughout, one rounding per operation."""
    return energy_static + idle_power * (
        n_pes * mean_residency - active_cycles)
