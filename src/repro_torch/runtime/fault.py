"""Fault-tolerant step runtime (port of ``repro.runtime.fault``).

A supervised loop of (state, batch) -> state steps, CPU-testable in
miniature:

* **checkpoint/restart** — periodic atomic checkpoints
  (:mod:`repro_torch.checkpoint`); on any failure the supervisor
  restarts the loop, which resumes from ``latest_step`` (the data
  pipeline is a pure function of step, so no loader state needs
  recovery).
* **straggler mitigation** — per-step wall-time watchdog: steps slower
  than ``straggler_factor`` x the running median are counted; after
  ``max_stragglers`` consecutive slow steps the runner raises
  ``StragglerAbort`` so the supervisor can reschedule the job away from
  the slow host (the paper's arrival-scatter insight: one late PE
  stalls the whole barrier).
* **restart with a fresh runner** — the supervisor builds a new runner
  after every fault, so a runner that picks its devices when it is
  built picks the survivors (the device mesh of the reference's
  elastic re-meshing waits for the port's multi-device slice; see
  :mod:`repro_torch.runtime.elastic`).
"""
from __future__ import annotations

import dataclasses
import random
import statistics
import time
from typing import Any, Callable, Dict, List, Optional

from .. import checkpoint


class StragglerAbort(RuntimeError):
    """Raised when this worker is persistently slower than its peers."""


@dataclasses.dataclass
class FaultConfig:
    ckpt_dir: str = "runs/ckpt"
    ckpt_every: int = 50
    keep: int = 3
    straggler_factor: float = 3.0
    max_stragglers: int = 5
    max_restarts: int = 3
    # Restart backoff: attempt k sleeps ~ base * 2**k, jittered by a
    # capped deterministic fraction, never above ``backoff_cap`` —
    # immediate hot-loop restarts hammer the scheduler the same way
    # simultaneous barrier arrivals hammer a counter bank.
    backoff_base: float = 0.1
    backoff_cap: float = 5.0
    backoff_jitter: float = 0.25


def backoff_delay(attempt: int, *, base: float, cap: float,
                  jitter: float) -> float:
    """Exponential backoff with a capped, DETERMINISTIC jitter: attempt
    ``k`` waits ``min(cap, base * 2**k)`` stretched by a pseudo-random
    fraction in ``[0, min(jitter, 1)]`` seeded on ``k`` — repeatable in
    tests, desynchronized across attempts, and never above ``cap``."""
    raw = min(cap, base * (2.0 ** attempt))
    frac = random.Random(attempt).uniform(0.0, max(0.0, min(jitter, 1.0)))
    return min(cap, raw * (1.0 + frac))


@dataclasses.dataclass
class StepStats:
    step: int
    seconds: float
    metrics: Dict[str, float]


class FaultTolerantRunner:
    """Drives (state, batch) -> state' steps with checkpointing, a
    straggler watchdog and restart-from-checkpoint semantics."""

    def __init__(self, cfg: FaultConfig, *,
                 step_fn: Callable[[Any, Any], tuple],
                 batch_fn: Callable[[int], Any],
                 state_template: Any):
        self.cfg = cfg
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.template = state_template
        self.history: List[StepStats] = []
        self._durations: List[float] = []
        self._slow = 0

    # -- persistence ----------------------------------------------------
    def resume_step(self) -> int:
        latest = checkpoint.latest_step(self.cfg.ckpt_dir)
        return 0 if latest is None else latest + 1

    def load_state(self) -> Any:
        latest = checkpoint.latest_step(self.cfg.ckpt_dir)
        if latest is None:
            return self.template
        state, _ = checkpoint.restore(self.cfg.ckpt_dir, self.template,
                                      step=latest)
        return state

    # -- watchdog ---------------------------------------------------------
    def _watch(self, seconds: float) -> None:
        self._durations.append(seconds)
        if len(self._durations) < 8:
            return
        med = statistics.median(self._durations[-50:])
        if seconds > self.cfg.straggler_factor * med:
            self._slow += 1
            if self._slow >= self.cfg.max_stragglers:
                raise StragglerAbort(
                    f"{self._slow} consecutive steps "
                    f">{self.cfg.straggler_factor}x median ({med:.3f}s)")
        else:
            self._slow = 0

    # -- main loop --------------------------------------------------------
    def run(self, n_steps: int, *, state: Optional[Any] = None,
            on_step: Optional[Callable[[StepStats], None]] = None) -> Any:
        state = self.load_state() if state is None else state
        start = self.resume_step()
        for step in range(start, n_steps):
            t0 = time.perf_counter()
            batch = self.batch_fn(step)
            state, metrics = self.step_fn(state, batch)
            dt = time.perf_counter() - t0
            stats = StepStats(step, dt, {k: float(v)
                                         for k, v in metrics.items()})
            self.history.append(stats)
            if on_step:
                on_step(stats)
            self._watch(dt)
            if (step + 1) % self.cfg.ckpt_every == 0 or step + 1 == n_steps:
                checkpoint.save(self.cfg.ckpt_dir, step, state)
                checkpoint.prune(self.cfg.ckpt_dir, self.cfg.keep)
        return state


def supervise(make_runner: Callable[[], FaultTolerantRunner],
              n_steps: int, cfg: FaultConfig, *,
              sleep: Callable[[float], None] = time.sleep) -> Any:
    """Restart-on-failure supervisor: rebuilds the runner (and hence the
    mesh — elastic re-meshing) after every fault, up to max_restarts.

    Restart ``k`` first sleeps :func:`backoff_delay`(k-1) — exponential
    with capped jitter, never a hot loop — and the failed attempt's
    ``history`` is carried into the fresh runner, so the step record of
    a supervised run is continuous across faults instead of silently
    resetting.  ``sleep`` is injectable for tests."""
    last_exc: Optional[BaseException] = None
    carried: List[StepStats] = []
    for attempt in range(cfg.max_restarts + 1):
        if attempt:
            sleep(backoff_delay(attempt - 1, base=cfg.backoff_base,
                                cap=cfg.backoff_cap,
                                jitter=cfg.backoff_jitter))
        runner = make_runner()
        runner.history.extend(carried)
        try:
            return runner.run(n_steps)
        except StragglerAbort as e:
            last_exc = e
            carried = list(runner.history)
            continue          # reschedule: new runner, resumes from ckpt
        except Exception as e:  # noqa: BLE001 — any node fault
            last_exc = e
            carried = list(runner.history)
            continue
    raise RuntimeError(
        f"giving up after {cfg.max_restarts} restarts") from last_exc
