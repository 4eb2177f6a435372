"""Deterministic fault injection for the resilient sweep runtime (port
of ``repro.runtime.inject``).

At thousand-PE scale partial failure is the common case (MemPool,
arXiv 2303.17742; the multi-cluster scaling study, arXiv 2507.05012),
but real faults are useless for testing: they are neither repeatable
nor CPU-portable.  This module makes them both.  A :class:`FaultPlan`
binds simulated faults to *chunk boundaries* of the chunked sweep loop
(:mod:`repro_torch.runtime.resilient_sweep`): right before the driver starts
chunk ``i`` it calls :meth:`FaultPlan.at_chunk`, which raises the
planned fault exactly once — so a test can kill a sweep at ANY chosen
boundary, resume it, and assert bit-for-bit equality with the
uninterrupted run.

Fault taxonomy (all subclasses of :class:`SimulatedFault`):

* :class:`DeviceLoss` — ``n_lost`` devices disappear.  Non-fatal: the
  supervisor shrinks the schedule-axis mesh to the survivors
  (:func:`repro_torch.runtime.elastic.viable_schedule_devices`) and retries.
* :class:`SimulatedOOM` — a transient allocator failure.  Non-fatal:
  plain backoff + retry, same mesh.
* :class:`Preemption` — a hard kill (SIGKILL / spot reclaim).  FATAL:
  re-raised to the caller like real process death; a subsequent call
  with the same checkpoint directory resumes from the last completed
  chunk.

``straggle`` entries inflate the *measured* wall time of a chunk by a
fixed number of seconds (fire-once, like faults) so the per-chunk
straggler watchdog can be driven deterministically without sleeping.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List


class SimulatedFault(RuntimeError):
    """Base class of all injected faults.

    ``fatal`` faults simulate process death: the resilient driver
    re-raises them instead of restarting, and recovery happens on the
    NEXT call against the same checkpoint directory.  Non-fatal faults
    are handled in-process by the supervisor loop (backoff + retry,
    elastic re-shard on device loss)."""

    fatal = False

    def __init__(self, msg: str = "injected fault"):
        super().__init__(msg)


class DeviceLoss(SimulatedFault):
    """``n_lost`` devices vanish at a chunk boundary."""

    def __init__(self, n_lost: int = 1):
        super().__init__(f"injected device loss ({n_lost} device(s))")
        if n_lost < 1:
            raise ValueError(f"n_lost must be >= 1, got {n_lost}")
        self.n_lost = int(n_lost)


class SimulatedOOM(SimulatedFault):
    """Transient out-of-memory: retry (possibly after backoff) succeeds."""

    def __init__(self):
        super().__init__("injected out-of-memory")


class Preemption(SimulatedFault):
    """Hard preemption: kills the sweep like SIGKILL — no in-process
    recovery; the next call resumes from the checkpoint."""

    fatal = True

    def __init__(self):
        super().__init__("injected preemption (hard kill)")


@dataclasses.dataclass
class FaultPlan:
    """A deterministic schedule of faults over chunk indices.

    ``faults[i]`` is raised when the driver reaches the boundary BEFORE
    chunk ``i`` (chunks ``< i`` are already checkpointed at that
    point); ``straggle[i]`` adds that many simulated seconds to chunk
    ``i``'s measured duration.  Every entry fires exactly once — the
    retry (or the resumed call, for fatal faults) sails past it, which
    is what makes kill-at-every-boundary sweep tests terminate.
    ``fired`` records what actually triggered, for reports.
    """

    faults: Dict[int, SimulatedFault] = dataclasses.field(
        default_factory=dict)
    straggle: Dict[int, float] = dataclasses.field(default_factory=dict)
    fired: List[str] = dataclasses.field(default_factory=list)
    _done: set = dataclasses.field(default_factory=set, repr=False)

    def __post_init__(self):
        """Reject malformed plans at construction, not mid-sweep: a
        typo'd plan that silently never fires (or fires something that
        isn't a fault) invalidates whatever resilience property the
        test thought it proved."""
        seen: Dict[int, SimulatedFault] = {}
        for idx, fault in self.faults.items():
            self._check_index(idx, "faults")
            if not isinstance(fault, SimulatedFault):
                raise ValueError(
                    f"unknown fault kind at chunk {idx}: expected a "
                    f"SimulatedFault (DeviceLoss / SimulatedOOM / "
                    f"Preemption), got {type(fault).__name__}: {fault!r}")
            dup = next((j for j, f in seen.items() if f is fault), None)
            if dup is not None:
                raise ValueError(
                    f"duplicate fire point: the same {type(fault).__name__} "
                    f"instance is planned at chunks {dup} and {idx}; "
                    f"each boundary needs its own fault instance "
                    f"(faults fire once and carry per-firing state)")
            seen[idx] = fault
        for idx, secs in self.straggle.items():
            self._check_index(idx, "straggle")
            s = float(secs)
            if not s >= 0.0 or s != s or s == float("inf"):
                raise ValueError(
                    f"straggle seconds at chunk {idx} must be finite "
                    f"and >= 0, got {secs!r}")

    @staticmethod
    def _check_index(idx, where: str) -> None:
        if isinstance(idx, bool) or not isinstance(idx, int):
            raise ValueError(
                f"{where} keys must be chunk indices (int), got "
                f"{idx!r} ({type(idx).__name__})")
        if idx < 0:
            raise ValueError(
                f"{where} keys must be >= 0 (chunk indices), got {idx}")

    def at_chunk(self, idx: int) -> None:
        """Raise the planned fault for boundary ``idx`` (once)."""
        fault = self.faults.get(idx)
        if fault is not None and ("fault", idx) not in self._done:
            self._done.add(("fault", idx))
            self.fired.append(f"chunk {idx}: {fault}")
            raise fault

    def straggle_seconds(self, idx: int) -> float:
        """Simulated extra wall seconds for chunk ``idx`` (once)."""
        extra = self.straggle.get(idx, 0.0)
        if extra and ("straggle", idx) not in self._done:
            self._done.add(("straggle", idx))
            self.fired.append(f"chunk {idx}: straggled +{extra:.3f}s")
            return float(extra)
        return 0.0

    @property
    def exhausted(self) -> bool:
        """True once every planned fault and straggle has fired."""
        return len(self._done) == len(self.faults) + \
            sum(1 for v in self.straggle.values() if v)
