"""Resilient sweeps: checkpoint/resume, fault injection and supervised
retry for the chunked barrier sweeps (port of
``repro.runtime.resilient_sweep``).

* **Per-chunk atomic checkpointing** — every completed trial chunk is
  published with :mod:`repro_torch.checkpoint`'s tmp-dir +
  ``os.replace`` pattern.  Each chunk is a pure function of ``(key, lo,
  hi)`` (the Monte-Carlo unit block is drawn once, up front, exactly as
  :func:`repro_torch.core.sweep.sweep_schedules` draws it), so a killed
  sweep resumed from its checkpoint directory returns bit for bit the
  arrays of an uninterrupted run.
* **Deterministic fault injection** — a
  :class:`~repro_torch.runtime.inject.FaultPlan` raises simulated
  device-loss / OOM / preemption faults at chosen chunk boundaries.
* **Supervised retry** — non-fatal faults restart the chunk loop with
  exponential, jitter-capped backoff
  (:func:`repro_torch.runtime.fault.backoff_delay`) up to
  ``max_restarts``; chunks already in memory or on disk are never
  recomputed.  A per-chunk wall-time straggler watchdog (median-
  relative) raises :class:`~repro_torch.runtime.fault.StragglerAbort`.
* **Device loss** — the survivors are the leading devices of the list;
  the sweep goes on while :mod:`repro_torch.runtime.elastic` finds them
  viable and raises otherwise.  The port runs every chunk on one device,
  the first of the list (sharding a grid across devices waits for the
  port's multi-device slice); nothing falls back to the CPU.
* **Multi-host chunk stores** — ``host_id``/``host_count`` in
  :class:`ResilienceConfig` interleave chunk ownership across hosts
  sharing one checkpoint directory: each host computes chunks
  ``idx % host_count == host_id``, restores the rest from the store, and
  raises listing the foreign chunks still missing, so an orchestrator
  can re-poll until the grid assembles.

Entry points mirror the plain engines one for one:
:func:`resilient_sweep_schedules` / :func:`resilient_sweep_arrivals`
drive :func:`repro_torch.core.sweep.sweep_schedules` /
:func:`~repro_torch.core.sweep.sweep_arrivals` semantics, and
:func:`resilient_tune_barrier` / :func:`resilient_sweep_workloads` wrap
the tuner grids of :mod:`repro_torch.core.tuning`.  Each returns a
:class:`SweepReport`: the ordinary result plus the resilience ledger.
Chunks are pulled to host numpy arrays once computed and the result is
assembled back on the sweep's device.  The store's layout is the
reference's, so either package restores the other's chunks.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import statistics
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import checkpoint
from .._device import resolve_device
from ..core import barrier, barrier_sim, prng
from ..core import sweep as sweep_mod
from ..core.barrier_sim import BarrierResult
from ..core.topology import DEFAULT, TeraPoolConfig
from . import elastic
from .fault import StragglerAbort, backoff_delay
from .inject import DeviceLoss, FaultPlan, SimulatedFault

# Per-chunk trial-axis width when the caller does not choose one: small
# enough that a kill forfeits little work, large enough that the
# checkpoint write stays small next to the N = 1024 grid compute.
DEFAULT_TRIAL_CHUNK = 8


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Knobs of the resilient chunk loop."""

    ckpt_dir: str
    trial_chunk: int = DEFAULT_TRIAL_CHUNK
    max_restarts: int = 8
    backoff_base: float = 0.02
    backoff_cap: float = 1.0
    backoff_jitter: float = 0.25
    # Chunks slower than factor x the running median (and above the
    # floor, so the first chunk's set-up never trips it) abort the
    # attempt so the supervisor can reschedule.
    straggler_factor: float = 50.0
    straggler_floor: float = 30.0
    min_devices: int = 1
    cleanup: bool = False     # drop the chunk store once the result is out
    # Multi-host chunk ownership: host ``host_id`` of ``host_count``
    # computes the chunks with ``idx % host_count == host_id`` and
    # restores every other chunk from the shared store.  A host whose
    # unowned chunks are not on disk yet raises listing the missing
    # indices; rerun it after the owners have published.
    host_id: int = 0
    host_count: int = 1

    def __post_init__(self):
        if self.host_count < 1:
            raise ValueError(f"host_count must be >= 1, got "
                             f"{self.host_count}")
        if not 0 <= self.host_id < self.host_count:
            raise ValueError(
                f"host_id {self.host_id} outside [0, {self.host_count})")


@dataclasses.dataclass
class SweepReport:
    """A sweep result plus the resilience ledger of how it was made."""

    result: object                 # SweepResult | ArrivalSweepResult
    chunks_total: int = 0
    chunks_resumed: int = 0        # restored from the checkpoint store
    chunks_computed: int = 0       # executed (and checkpointed) now
    restarts: int = 0              # in-process supervisor restarts
    faults: List[str] = dataclasses.field(default_factory=list)
    fault_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    device_history: List[int] = dataclasses.field(default_factory=list)
    wall_seconds: float = 0.0
    ckpt_seconds: float = 0.0      # time inside checkpoint save/restore
    backoff_seconds: float = 0.0   # total supervisor backoff slept


def _run_digest(parts: Sequence) -> str:
    """Stable digest of everything a chunked run's results depend on: a
    checkpoint store only resumes a run with the SAME digest."""
    h = hashlib.sha256()
    for p in parts:
        if isinstance(p, torch.Tensor):
            h.update(p.detach().cpu().contiguous().numpy().tobytes())
        else:
            h.update(repr(p).encode())
        h.update(b"\x00")
    return h.hexdigest()


class _ChunkedGrid:
    """Chunk-by-chunk executor of one grid with checkpoint/resume, fault
    injection, a straggler watchdog and device-loss accounting.
    ``chunk_fn(lo, hi)`` is the block of one trial chunk and
    ``body(block, widths)`` its grid, the plain sweep's own
    ``_sweep_body`` or ``_grid`` call; ``chunk_shape(lo, hi)`` the shape
    of that chunk's result arrays (for the restore template)."""

    def __init__(self, kind: str, tables, body, chunk_fn, chunk_shape,
                 n_trials: int, cfg: TeraPoolConfig, core: str,
                 rcfg: ResilienceConfig, plan: Optional[FaultPlan],
                 devices: Sequence, digest: str,
                 sleep: Callable[[float], None],
                 clock: Callable[[], float],
                 n_kernels: Optional[int] = None):
        self.kind = kind
        self.n_kernels = n_kernels
        self.tables = tables
        self.body = body
        self.widths = barrier.telescope_widths(tables,
                                               chunk_fn(0, 1).shape[-1])
        self.chunk_fn = chunk_fn
        self.chunk_shape = chunk_shape
        self.cfg = cfg
        self.core = core
        self.rcfg = rcfg
        self.plan = plan
        self.devices = tuple(devices)
        self.sleep = sleep
        self.clock = clock
        self.root = Path(rcfg.ckpt_dir)
        self.chunks = list(sweep_mod._trial_chunks(n_trials,
                                                   rcfg.trial_chunk))
        self.report = SweepReport(result=None,
                                  chunks_total=len(self.chunks))
        self.report.device_history.append(len(self.devices))
        self._parts: dict = {}          # chunk idx -> BarrierResult (numpy)
        self._durations: List[float] = []
        self._prepare_store(digest)

    # -- checkpoint store -------------------------------------------------
    def _prepare_store(self, digest: str) -> None:
        """Bind the store to this run's digest; wipe a stale store left
        by a DIFFERENT run (never silently mix chunk sets)."""
        meta_path = self.root / "meta.json"
        if meta_path.exists():
            try:
                meta = json.loads(meta_path.read_text())
            except (OSError, json.JSONDecodeError):
                meta = {}
            if meta.get("digest") == digest:
                return
            shutil.rmtree(self.root)
        self.root.mkdir(parents=True, exist_ok=True)
        tmp = self.root / "meta.json.tmp"
        tmp.write_text(json.dumps({"digest": digest,
                                   "chunks": len(self.chunks)}, indent=1))
        os.replace(tmp, meta_path)

    def _template(self, lo: int, hi: int) -> dict:
        shape = self.chunk_shape(lo, hi)
        dtypes = {"completed": np.bool_, "abandoned_pes": np.int32,
                  "timed_out_levels": np.int32}
        return {f: np.zeros(shape, dtypes.get(f, np.float32))
                for f in BarrierResult._fields}

    def _restore_chunk(self, idx: int, lo: int, hi: int
                       ) -> Optional[BarrierResult]:
        """The chunk's checkpointed result, or ``None`` if absent or
        unreadable (unreadable == recompute, never trust)."""
        step_dir = self.root / f"step_{idx:08d}"
        if not step_dir.exists():
            return None
        t0 = self.clock()
        try:
            tree, _ = checkpoint.restore(self.root, self._template(lo, hi),
                                         step=idx)
        except Exception:           # torn/corrupt chunk: recompute it
            return None
        finally:
            self.report.ckpt_seconds += self.clock() - t0
        return BarrierResult(**{f: np.asarray(tree[f])
                                for f in BarrierResult._fields})

    def _save_chunk(self, idx: int, res: BarrierResult) -> None:
        t0 = self.clock()
        checkpoint.save(self.root, idx,
                        {f: v for f, v in zip(BarrierResult._fields, res)})
        self.report.ckpt_seconds += self.clock() - t0

    # -- watchdog ---------------------------------------------------------
    def _watch(self, seconds: float) -> None:
        if len(self._durations) >= 3:
            med = statistics.median(self._durations)
            limit = max(self.rcfg.straggler_floor,
                        self.rcfg.straggler_factor * med)
            if seconds > limit:
                raise StragglerAbort(
                    f"chunk took {seconds:.3f}s > {limit:.3f}s "
                    f"({self.rcfg.straggler_factor}x median {med:.3f}s)")
        self._durations.append(seconds)

    def _owns(self, idx: int) -> bool:
        """Chunk ownership under the interleaved multi-host split."""
        return idx % self.rcfg.host_count == self.rcfg.host_id

    # -- chunk loop -------------------------------------------------------
    def _attempt(self) -> None:
        missing: List[int] = []
        for idx, (lo, hi) in enumerate(self.chunks):
            if self.plan is not None:
                self.plan.at_chunk(idx)
            if idx in self._parts:
                continue
            restored = self._restore_chunk(idx, lo, hi)
            if restored is not None:
                self._parts[idx] = restored
                self.report.chunks_resumed += 1
                continue
            if not self._owns(idx):
                # Another host's chunk, not published yet: keep computing
                # our own share and report the gap at the end.
                missing.append(idx)
                continue
            t0 = self.clock()
            res = self.body(self.chunk_fn(lo, hi), self.widths)
            # Pull the chunk to host arrays (this also waits for the
            # device): the store holds numpy, and device-to-host copies
            # are bit-exact.
            res = BarrierResult(*(f.cpu().numpy() for f in res))
            dt = self.clock() - t0
            if self.plan is not None:
                dt += self.plan.straggle_seconds(idx)
            self._watch(dt)
            self._save_chunk(idx, res)
            self._parts[idx] = res
            self.report.chunks_computed += 1
        if missing:
            raise RuntimeError(
                f"host {self.rcfg.host_id}/{self.rcfg.host_count} "
                f"computed its own chunks but chunk(s) {missing} owned "
                f"by other host(s) are not in the store yet; rerun "
                f"after the owners publish")

    def _remesh(self, survivors: Sequence) -> Optional[tuple]:
        """The viable survivors, counted the way the reference shapes a
        fresh dispatch of this grid."""
        n_sched = self.tables.group_sizes.shape[0]
        if self.kind == "arrival" and self.n_kernels is not None:
            return elastic.viable_grid_devices(
                survivors, n_sched, self.n_kernels,
                min_devices=self.rcfg.min_devices)
        return elastic.viable_schedule_devices(
            survivors, n_sched, min_devices=self.rcfg.min_devices)

    def _on_fault(self, exc: Exception) -> None:
        self.report.faults.append(str(exc))
        cls = type(exc).__name__
        self.report.fault_counts[cls] = (
            self.report.fault_counts.get(cls, 0) + 1)
        if self.report.restarts >= self.rcfg.max_restarts:
            raise RuntimeError(
                f"giving up after {self.rcfg.max_restarts} restarts "
                f"(faults: {self.report.faults})") from exc
        if isinstance(exc, DeviceLoss):
            survivors = self.devices[:max(0, len(self.devices)
                                          - exc.n_lost)]
            mesh = self._remesh(survivors)
            if mesh is None:
                raise RuntimeError(
                    f"only {len(survivors)} device(s) survive; need "
                    f">= {self.rcfg.min_devices}") from exc
            self.devices = mesh
            self.report.device_history.append(len(mesh))
        delay = backoff_delay(self.report.restarts,
                              base=self.rcfg.backoff_base,
                              cap=self.rcfg.backoff_cap,
                              jitter=self.rcfg.backoff_jitter)
        self.report.backoff_seconds += delay
        self.sleep(delay)
        self.report.restarts += 1
        self._durations.clear()       # fresh watchdog baseline

    def run(self, device: torch.device) -> BarrierResult:
        """Every chunk, resumed or computed, assembled on ``device``."""
        t0 = self.clock()
        while True:
            try:
                self._attempt()
                break
            except SimulatedFault as e:
                if e.fatal:
                    raise               # process death: resume next call
                self._on_fault(e)
            except StragglerAbort as e:
                self._on_fault(e)
        out = BarrierResult(*(
            torch.from_numpy(np.concatenate(xs, axis=-1)).to(device)
            for xs in zip(*(self._parts[i]
                            for i in range(len(self.chunks))))))
        self.report.wall_seconds = self.clock() - t0
        if self.rcfg.cleanup:
            shutil.rmtree(self.root, ignore_errors=True)
        return out


def resilient_sweep_schedules(
        key: torch.Tensor, schedules: Sequence[barrier.BarrierSchedule],
        delays: Sequence[float] = (0.0, 128.0, 512.0, 2048.0),
        n_trials: int = 16, cfg: TeraPoolConfig = DEFAULT,
        placements: Sequence | None = None, *,
        resilience: ResilienceConfig, core: str | None = None,
        fault_plan: Optional[FaultPlan] = None,
        devices: Optional[Sequence] = None,
        sleep: Callable[[float], None] = time.sleep,
        clock: Callable[[], float] = time.perf_counter,
        device="cuda") -> SweepReport:
    """:func:`repro_torch.core.sweep.sweep_schedules` on ``device``,
    chunk by chunk with checkpoint/resume.  The unit block is drawn as
    the plain engine draws it and each chunk is the same
    ``_sweep_body`` call the plain chunked path makes, so the
    assembled :class:`~repro_torch.core.sweep.SweepResult` equals an
    uninterrupted sweep bit for bit, killed and resumed or not.
    ``devices`` (default: ``device`` alone) is the device list that a
    :class:`~repro_torch.runtime.inject.DeviceLoss` shrinks."""
    dev = resolve_device(device)
    schedules = tuple(schedules)
    tables = barrier.stack_tables(schedules, cfg, placements, device=dev)
    n = schedules[0].n_pes
    unit = prng.uniform(key.to(dev), (n_trials, n), 0.0, 1.0)
    d = torch.as_tensor(delays, dtype=torch.float32, device=dev)
    core = barrier_sim.resolve_core(core)
    placements = tuple(placements) if placements is not None else ()
    names = sweep_mod._stack_names(schedules, placements)
    digest = _run_digest(["sweep", names, unit, d, n_trials,
                          resilience.trial_chunk, cfg, core])
    s_count = len(schedules)
    driver = _ChunkedGrid(
        "sweep", tables,
        lambda unit_chunk, widths: sweep_mod._sweep_body(
            tables, d, unit_chunk, cfg, core, widths),
        chunk_fn=lambda lo, hi: unit[lo:hi],
        chunk_shape=lambda lo, hi: (s_count, d.shape[0], hi - lo),
        n_trials=n_trials, cfg=cfg, core=core, rcfg=resilience,
        plan=fault_plan, devices=devices if devices is not None else (dev,),
        digest=digest, sleep=sleep, clock=clock)
    res = driver.run(dev)
    driver.report.result = sweep_mod.SweepResult(
        schedules=schedules, delays=d, placements=placements,
        **res._asdict())
    return driver.report


def resilient_sweep_arrivals(
        arrivals, schedules: Sequence[barrier.BarrierSchedule],
        cfg: TeraPoolConfig = DEFAULT, placements: Sequence | None = None,
        kernels: Sequence[str] | None = None, *,
        resilience: ResilienceConfig, core: str | None = None,
        fault_plan: Optional[FaultPlan] = None,
        devices: Optional[Sequence] = None,
        sleep: Callable[[float], None] = time.sleep,
        clock: Callable[[], float] = time.perf_counter,
        device="cuda") -> SweepReport:
    """:func:`repro_torch.core.sweep.sweep_arrivals` with the resilient
    chunk loop, the arrivals moved to ``device``: the same validation,
    the same grid calls and the same bit-for-bit guarantee as
    :func:`resilient_sweep_schedules`."""
    dev = resolve_device(device)
    arrivals = torch.as_tensor(arrivals, dtype=torch.float32).to(dev)
    if arrivals.ndim == 2:
        arrivals = arrivals[None]
    if arrivals.ndim != 3:
        raise ValueError(
            f"arrivals must be (n_kernels, n_trials, n_pes) or "
            f"(n_trials, n_pes), got shape {tuple(arrivals.shape)}")
    schedules = tuple(schedules)
    if schedules and arrivals.shape[-1] != schedules[0].n_pes:
        raise ValueError(
            f"arrivals has {arrivals.shape[-1]} PEs, schedules expect "
            f"{schedules[0].n_pes}")
    if kernels is not None and len(kernels) != arrivals.shape[0]:
        raise ValueError(
            f"{arrivals.shape[0]} arrival stacks but {len(kernels)} "
            f"kernel names")
    tables = barrier.stack_tables(schedules, cfg, placements, device=dev)
    core = barrier_sim.resolve_core(core)
    n_trials = arrivals.shape[1]
    placements = tuple(placements) if placements is not None else ()
    names = sweep_mod._stack_names(schedules, placements)
    digest = _run_digest(["arrival", names, arrivals,
                          resilience.trial_chunk, cfg, core])
    s_count, k_count = len(schedules), arrivals.shape[0]
    driver = _ChunkedGrid(
        "arrival", tables,
        lambda block, widths: sweep_mod._grid(block, tables, cfg, core,
                                              widths, None),
        chunk_fn=lambda lo, hi: arrivals[:, lo:hi],
        chunk_shape=lambda lo, hi: (s_count, k_count, hi - lo),
        n_trials=n_trials, cfg=cfg, core=core, rcfg=resilience,
        plan=fault_plan, devices=devices if devices is not None else (dev,),
        digest=digest, sleep=sleep, clock=clock, n_kernels=k_count)
    res = driver.run(dev)
    kernels = (tuple(kernels) if kernels is not None
               else tuple(f"workload{i}" for i in range(k_count)))
    driver.report.result = sweep_mod.ArrivalSweepResult(
        schedules=schedules, kernels=kernels, placements=placements,
        **res._asdict())
    return driver.report


def resilient_tune_barrier(
        key, n_pes: int | None = None,
        delays: Sequence[float] = (0.0, 128.0, 512.0, 2048.0),
        n_trials: int = 16, cfg: TeraPoolConfig = DEFAULT, *,
        prune: str = "none", schedules=None,
        placements: Sequence[str] | None = None,
        resilience: ResilienceConfig, core: str | None = None,
        fault_plan: Optional[FaultPlan] = None,
        devices: Optional[Sequence] = None,
        sleep: Callable[[float], None] = time.sleep,
        clock: Callable[[], float] = time.perf_counter) -> SweepReport:
    """:func:`repro_torch.core.tuning.tune_barrier` under the resilient
    loop, on ``key``'s device: the full composition x placement x delay
    x trial grid, checkpointed per trial chunk."""
    from ..core import tuning
    if schedules is None:
        schedules = tuning.all_schedules(n_pes, cfg, prune=prune)
    scheds, placs = tuning._cross_placements(schedules, placements, cfg)
    return resilient_sweep_schedules(
        key, scheds, delays, n_trials, cfg, placements=placs,
        resilience=resilience, core=core, fault_plan=fault_plan,
        devices=devices, sleep=sleep, clock=clock, device=key.device)


def resilient_sweep_workloads(
        key, kernels: Sequence[str] | None = None,
        n_pes: int | None = None, n_trials: int = 8,
        cfg: TeraPoolConfig = DEFAULT, *, prune: str = "none",
        schedules=None, placements: Sequence[str] | None = None,
        resilience: ResilienceConfig, core: str | None = None,
        fault_plan: Optional[FaultPlan] = None,
        devices: Optional[Sequence] = None,
        sleep: Callable[[float], None] = time.sleep,
        clock: Callable[[], float] = time.perf_counter) -> SweepReport:
    """:func:`repro_torch.core.tuning.sweep_workloads` under the
    resilient loop, on ``key``'s device: every kernel's measured arrival
    batch (drawn exactly as the plain tuner draws it) across the
    schedule stack, checkpointed per trial chunk."""
    from ..core import tuning, workloads as workloads_mod
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
        schedules = tuning.all_schedules(n, cfg, prune=prune)
    scheds, placs = tuning._cross_placements(schedules, placements, cfg)
    return resilient_sweep_arrivals(
        arrivals, scheds, cfg, placements=placs, kernels=kernels,
        resilience=resilience, core=core, fault_plan=fault_plan,
        devices=devices, sleep=sleep, clock=clock, device=key.device)
