"""Tuning-as-a-service: a long-lived, thread-driven request server (port
of ``repro.runtime.serving``).

A :class:`TuningServer` accepts :class:`TuneRequest`\\ s (a named kernel
or an explicit arrival trace, an objective, a deadline, a priority),
coalesces compatible requests into ONE batched
:func:`repro_torch.core.sweep.sweep_arrivals` call on the kernel axis,
and returns :class:`TuneResponse`\\ s with per-request provenance.

* **Bounded queue with admission control** — ``queue_depth`` caps
  accepted work; an overloaded server rejects with
  :class:`ServerOverloaded` carrying a ``retry_after`` estimate.
* **Deadline enforcement + a three-tier degradation ladder** — a
  request whose remaining budget can't cover the EWMA-estimated sweep
  degrades from (1) the *exact* batched sweep to (2) a persistent
  :mod:`~repro_torch.runtime.schedule_cache` hit to (3) a *closed-form
  best-uniform fallback* ranked analytically over
  :func:`repro_torch.core.barrier.all_radices` on the host.  Every
  response labels its tier (``"exact"`` / ``"cache"`` / ``"fallback"``).
* **Idempotent dedup** — requests are keyed on the schedule cache's
  digest scheme (kind, params, N, cfg, code version); identical
  in-flight requests attach to one pending entry and identical later
  requests are served from cache.
* **Retry with backoff + circuit breaker** — failed batch dispatches
  retry through :func:`repro_torch.runtime.fault.backoff_delay`;
  repeated :class:`~repro_torch.runtime.inject.DeviceLoss` /
  :class:`~repro_torch.runtime.inject.SimulatedOOM` faults trip a
  breaker that serves cache/fallback only until a probe batch succeeds.
* **Resilient dispatch** — with a :class:`ResilienceConfig` the batch
  runs through
  :func:`~repro_torch.runtime.resilient_sweep.resilient_sweep_arrivals`:
  per-chunk checkpointing, straggler watchdog, and a device list that a
  device loss shrinks.
* **Drain-based shutdown** — ``close(drain=True)`` flushes every
  in-flight batch; ``close(drain=False)`` checkpoints the undispatched
  queue to ``ckpt_dir/queue.json`` (atomic tmp + ``os.replace``) in the
  reference's layout, so either package restores the other's parked
  queue.

The server runs on one device (``device=``, the card by default).  A
kernel request's arrivals are drawn in :meth:`TuningServer.submit`, on
the calling thread and its current stream; the draw is complete before
the request is queued, so the worker thread, which sweeps on its own
current stream, never reads a tensor still being written.

The batching guarantee: the kernel axis of ``sweep_arrivals`` is a
plain batch dimension, so the per-request slice of a batched grid
(:func:`repro_torch.core.sweep.split_kernels`) is bit for bit the
result of an unbatched call.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..core import barrier, prng, sweep as sweep_mod, tuning, workloads
from ..core import energy as energy_mod
from ..core import topology as topology_mod
from ..core.topology import DEFAULT, TeraPoolConfig
from . import schedule_cache
from .fault import backoff_delay
from .inject import DeviceLoss, FaultPlan, SimulatedOOM
from .resilient_sweep import ResilienceConfig, resilient_sweep_arrivals

# Provenance labels: how the response was produced.
CACHE_HIT = "cache_hit"      # served from the schedule cache, no sweep
BATCHED = "batched"          # exact result from a batched sweep dispatch
DEGRADED = "degraded"        # deadline/breaker/failure forced a lower tier
FAILED = "failed"            # every tier failed (response carries error)

# Ladder tiers: which rung produced the schedule.
TIER_EXACT = "exact"         # the batched sweep itself
TIER_CACHE = "cache"         # persistent schedule_cache entry
TIER_FALLBACK = "fallback"   # closed-form best-uniform estimate
TIER_NONE = "none"           # no schedule could be produced

# Fixed seed for kernel-request arrival draws: serving is deterministic
# per (kernel, N, cfg) and independent of batch composition — each
# kernel's key is folded from its name, never from its batch slot.
_SERVING_SEED = 907


class ServerError(RuntimeError):
    """Base class of serving-side errors."""


class ServerOverloaded(ServerError):
    """Admission control rejected the request: the queue is full.

    ``retry_after`` estimates (seconds) when capacity should free up —
    clients back off instead of piling on."""

    def __init__(self, retry_after: float):
        super().__init__(
            f"queue full; retry after ~{retry_after:.2f}s")
        self.retry_after = float(retry_after)


class ServerClosed(ServerError):
    """The server is shutting down and accepts no new requests."""


@dataclasses.dataclass
class ServerConfig:
    """Knobs of the serving loop."""

    queue_depth: int = 64         # admission-control cap on pending requests
    batch_window: float = 0.02    # coalescing wait before dispatch (s)
    max_batch: int = 16           # max requests fused into one dispatch
    max_batch_retries: int = 2    # re-dispatch attempts for a failed batch
    backoff_base: float = 0.02    # fault.backoff_delay parameters for
    backoff_cap: float = 1.0      # batch retries (the resilient chunk
    backoff_jitter: float = 0.25  # loop has its own, via ResilienceConfig)
    breaker_threshold: int = 3    # consecutive faulted batches that trip it
    breaker_probe_after: float = 1.0   # open -> half-open delay (s)
    ckpt_dir: Optional[str] = None     # queue checkpoint + batch chunk stores
    resilience: Optional[ResilienceConfig] = None  # resilient dispatch
    default_n_trials: int = 8     # arrival draws for kernel requests
    ewma_alpha: float = 0.5       # batch wall-time estimator smoothing


@dataclasses.dataclass
class TuneRequest:
    """One tuning question: EITHER a named workload kernel (arrivals
    drawn from its measured model under a fixed seed) OR an explicit
    ``(n_trials, n_pes)`` arrival trace (numpy or a tensor).

    ``objective`` selects the winner: ``"cycles"``, ``"energy"``,
    ``"edp"``, or ``"pareto"`` (knee of the 2-D latency x energy
    front).  ``deadline`` is a soft budget in seconds from submission —
    a request that can't make it degrades down the ladder instead of
    blocking.  Higher ``priority`` batches dispatch first."""

    kernel: Optional[str] = None
    arrivals: Optional[object] = None   # (n_trials, n_pes) array-like
    n_pes: Optional[int] = None
    cfg: TeraPoolConfig = DEFAULT
    objective: str = "cycles"
    deadline: Optional[float] = None    # seconds from submit; None = no limit
    priority: int = 0
    n_trials: Optional[int] = None      # kernel requests only
    prune: Optional[str] = None         # None = auto (hierarchy above 256 PEs)
    placements: Optional[Tuple[str, ...]] = None
    core: Optional[str] = None


@dataclasses.dataclass
class TuneResponse:
    """The answer, with full provenance: WHAT schedule, WHICH ladder
    tier produced it, and HOW (batched exactly, cache-served,
    explicitly degraded, or failed)."""

    schedule: Optional[barrier.BarrierSchedule]
    placement: object
    name: str
    objective: str
    provenance: str               # cache_hit | batched | degraded | failed
    tier: str                     # exact | cache | fallback | none
    mean_span: float = float("nan")
    mean_energy: float = float("nan")
    latency_s: float = 0.0        # submit -> response wall time
    batch_size: int = 0           # requests fused into this dispatch
    detail: str = ""              # degradation reason / error text
    result: object = None         # per-request ArrivalSweepResult (exact only)

    @property
    def ok(self) -> bool:
        return self.provenance != FAILED


@dataclasses.dataclass
class ServerStats:
    """Serving-side counters (monotonic over the server's lifetime)."""

    accepted: int = 0
    rejected: int = 0
    deduped: int = 0
    restored: int = 0             # requests re-enqueued from a queue ckpt
    batches: int = 0              # successful batch dispatches
    batch_requests: int = 0       # requests served by those dispatches
    batch_failures: int = 0       # dispatch attempts that raised
    exact: int = 0
    cache_hits: int = 0
    degraded: int = 0
    failed: int = 0
    backoff_seconds: float = 0.0
    faults: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def batch_efficiency(self) -> float:
        """Mean requests per dispatch (1.0 = no batching win)."""
        return self.batch_requests / self.batches if self.batches else 0.0


class Ticket:
    """A claim on one submitted request; ``result()`` blocks until the
    server answers (multiple identical requests share one pending entry
    via dedup — every waiter sees the same response object)."""

    def __init__(self):
        self._event = threading.Event()
        self._response: Optional[TuneResponse] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> TuneResponse:
        if not self._event.wait(timeout):
            raise TimeoutError("request not answered within timeout")
        return self._response

    def _finish(self, response: TuneResponse) -> None:
        self._response = response
        self._event.set()


class _Pending:
    """One queue entry: a normalized request plus every ticket waiting
    on it (dedup attaches later identical requests here)."""

    def __init__(self, req: TuneRequest, arrivals: torch.Tensor, label: str,
                 key: tuple, group: tuple, seq: int, submit_at: float):
        self.req = req
        self.arrivals = arrivals      # (n_trials, n_pes) float32, on device
        self.label = label
        self.key = key                # schedule_cache digest key
        self.group = group            # batch-compatibility key
        self.seq = seq
        self.submit_at = submit_at
        self.deadline_at = (None if req.deadline is None
                            else submit_at + float(req.deadline))
        self.tickets: List[Ticket] = [Ticket()]

    @property
    def done(self) -> bool:
        return self.tickets[0].done()


def _auto_prune(n: int) -> str:
    return "none" if n <= 256 else "hierarchy"


def _host(arrivals) -> np.ndarray:
    """A trace as a host float32 array (a device tensor is copied back)."""
    if isinstance(arrivals, torch.Tensor):
        arrivals = arrivals.detach().cpu().numpy()
    return np.asarray(arrivals, np.float32)


def _trace_digest(arrivals) -> str:
    arr = np.ascontiguousarray(_host(arrivals))
    h = hashlib.sha256()
    h.update(arr.tobytes())
    h.update(repr(arr.shape).encode())
    return h.hexdigest()[:16]


def _kernel_fold(kernel: str) -> int:
    """Stable per-kernel fold constant for the arrival-draw key."""
    return int.from_bytes(hashlib.sha256(kernel.encode()).digest()[:4],
                          "big") & 0x7FFFFFFF


def _kernel_key(kernel: str, device="cuda") -> torch.Tensor:
    """The key a kernel request's arrivals are drawn under: the serving
    seed folded with the kernel's name (the reference's
    ``fold_in(PRNGKey(907), _kernel_fold(kernel))``)."""
    return prng.fold_in(prng.PRNGKey(_SERVING_SEED, device=device),
                        _kernel_fold(kernel))


def request_key(req: TuneRequest, arrivals, n: int, trials: int,
                prune: str) -> tuple:
    """The idempotency / cache key of one normalized request — the same
    (kind, params, N, cfg, code-version) digest scheme every
    :mod:`~repro_torch.runtime.schedule_cache` consumer uses, so serving
    results interoperate with the rest of the store."""
    src = (("kernel", req.kernel) if req.kernel is not None
           else ("trace", _trace_digest(arrivals)))
    return ("serve", src, int(n), repr(req.cfg), req.objective, prune,
            int(trials), req.placements, req.core)


# ---------------------------------------------------------------------------
# Tier 3: the closed-form best-uniform fallback.  Host float64, no
# device — an analytic span/energy estimate over every uniform radix of
# N, good enough to rank them when the exact sweep can't run in budget.
# ---------------------------------------------------------------------------

def _analytic_span(schedule: barrier.BarrierSchedule,
                   cfg: TeraPoolConfig) -> float:
    """Zero-jitter span estimate (cycles): per level, the bank
    serializes ``group_size - 1`` follower atomics plus the round trip
    and bookkeeping; plus the wakeup chain once."""
    span = float(cfg.wakeup_write + cfg.wakeup_trigger + cfg.wfi_resume)
    for lvl in schedule.levels:
        span += float(cfg.bank_service_cycles) * (lvl.group_size - 1)
        span += 2.0 * float(lvl.latency) + float(cfg.instr_per_level)
    return span


def fallback_uniform(n: int, cfg: TeraPoolConfig,
                     objective: str = "cycles"
                     ) -> Tuple[barrier.BarrierSchedule, float, float]:
    """The best uniform-radix tree for ``n`` PEs by closed-form
    estimate — the bottom rung of the degradation ladder.  Returns
    ``(schedule, est_span, est_energy)``; for ``objective="pareto"``
    the knee of the analytic (span, energy) set is picked."""
    points = []
    for k in barrier.all_radices(n, cfg):
        sched = barrier.kary_tree(k, n_pes=n, cfg=cfg)
        sp = _analytic_span(sched, cfg)
        e_static, _, idle_p = energy_mod.schedule_energy_constants(
            sched, None, cfg)
        en = float(e_static) + float(idle_p) * n * sp
        points.append((sched, sp, en))
    if not points:
        raise ValueError(f"no uniform radix divides n_pes={n}")
    if objective == "cycles":
        return min(points, key=lambda p: p[1])
    if objective == "energy":
        return min(points, key=lambda p: p[2])
    if objective == "edp":
        return min(points, key=lambda p: p[1] * p[2])
    if objective == "pareto":
        sp = np.array([p[1] for p in points])
        en = np.array([p[2] for p in points])
        ns = (sp - sp.min()) / ((sp.max() - sp.min()) or 1.0)
        ne = (en - en.min()) / ((en.max() - en.min()) or 1.0)
        return points[int(np.argmin(np.hypot(ns, ne)))]
    raise ValueError(
        f"unknown objective {objective!r}; choose from "
        f"('cycles', 'energy', 'edp', 'pareto')")


def _drain(device: torch.device) -> None:
    """Wait for the current thread's stream on ``device`` (no-op on the
    CPU)."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


# ---------------------------------------------------------------------------
# The server.
# ---------------------------------------------------------------------------

class TuningServer:
    """See the module docstring.  Thread-safe: ``submit``/``tune`` may
    be called from any number of client threads; one worker thread
    drains the queue.  Use as a context manager for drain-on-exit:

        with TuningServer(ServerConfig(...)) as srv:
            resp = srv.tune(TuneRequest(kernel="dotp_1Mi", n_pes=1024))

    ``device`` is where arrivals are drawn, stacked and swept (the card
    by default; asking for it without one raises).  ``devices`` is the
    device list a resilient dispatch shrinks on a
    :class:`~repro_torch.runtime.inject.DeviceLoss`; the plain dispatch
    runs on ``device`` alone, so it takes at most one."""

    def __init__(self, config: Optional[ServerConfig] = None, *,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 fault_plan: Optional[FaultPlan] = None,
                 devices: Optional[Sequence] = None,
                 start: bool = True,
                 device="cuda"):
        self.config = config or ServerConfig()
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # The worker thread enters this device by index.
            self.device = torch.device("cuda", torch.cuda.current_device())
        if (devices is not None and len(devices) > 1
                and self.config.resilience is None):
            raise NotImplementedError(
                f"a plain dispatch over {len(devices)} devices needs the "
                f"sharded sweep (ROADMAP queue 1 item 2, collectives and "
                f"multi-device); pass one device, or a ResilienceConfig "
                f"whose chunk loop takes a device list")
        self.stats = ServerStats()
        self._clock = clock
        self._sleep = sleep
        self._fault_plan = fault_plan
        self._devices = devices
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: List[_Pending] = []
        self._processing = False
        self._closing = False
        self._drain = True
        self._seq = 0
        self._n_dispatches = 0
        self._ewma: Optional[float] = None
        self._memo: Dict[tuple, dict] = {}      # in-process payload cache
        self._stacks: Dict[tuple, tuple] = {}   # group -> (scheds, placs)
        self._breaker_failures = 0
        self._breaker_open_since: Optional[float] = None
        self._breaker_probing = False
        self._thread: Optional[threading.Thread] = None
        self._restore_queue()
        if start:
            self.start()

    # -- lifecycle ----------------------------------------------------------

    def _spawn_locked(self) -> None:
        self._thread = threading.Thread(
            target=self._serve_loop, name="tuning-server", daemon=True)
        self._thread.start()

    def start(self) -> "TuningServer":
        with self._lock:
            if self._closing:
                raise ServerClosed("server already closed")
            if self._thread is None:
                self._spawn_locked()
        return self

    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """Stop the server.  ``drain=True`` answers every pending
        request exactly (flushing in-flight batches) before returning;
        ``drain=False`` checkpoints the undispatched queue to
        ``ckpt_dir/queue.json`` for the next server instance and
        answers the parked tickets through the degradation ladder."""
        with self._cond:
            self._closing = True
            self._drain = bool(drain)
            parked: List[_Pending] = []
            if not drain:
                parked, self._queue = self._queue, []
            elif self._queue and self._thread is None:
                # Never-started server with queued work: drain needs a
                # worker after all.
                self._spawn_locked()
            self._cond.notify_all()
        if parked:
            self._checkpoint_queue(parked)
            for p in parked:
                self._degrade(p, "server shutdown: request checkpointed "
                                 "for replay at restart")
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError("serving thread did not stop in time")

    def __enter__(self) -> "TuningServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close(drain=True)

    def flush(self, timeout: Optional[float] = None) -> None:
        """Block until the queue is empty and no batch is in flight."""
        end = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._queue or self._processing:
                remaining = None if end is None else end - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError("queue did not drain in time")
                self._cond.wait(0.05 if remaining is None
                                else min(0.05, remaining))

    # -- client API ---------------------------------------------------------

    def submit(self, req: TuneRequest) -> Ticket:
        """Admit one request; returns a :class:`Ticket` immediately.
        Raises :class:`ServerOverloaded` (with ``retry_after``) when the
        queue is full and :class:`ServerClosed` after shutdown began."""
        pending = self._normalize(req)
        with self._cond:
            if self._closing:
                raise ServerClosed("server is shutting down")
            for other in self._queue:
                if other.key == pending.key:
                    ticket = Ticket()
                    other.tickets.append(ticket)
                    self.stats.deduped += 1
                    return ticket
            if len(self._queue) >= self.config.queue_depth:
                self.stats.rejected += 1
                raise ServerOverloaded(self._retry_after_locked())
            self.stats.accepted += 1
            self._queue.append(pending)
            self._cond.notify_all()
        return pending.tickets[0]

    def tune(self, req: TuneRequest,
             timeout: Optional[float] = None) -> TuneResponse:
        """Convenience: ``submit`` + blocking ``result``."""
        return self.submit(req).result(timeout)

    @property
    def breaker_state(self) -> str:
        """``"closed"`` | ``"open"`` | ``"half_open"`` (probe-ready)."""
        if self._breaker_open_since is None:
            return "closed"
        if (self._clock() - self._breaker_open_since
                >= self.config.breaker_probe_after):
            return "half_open"
        return "open"

    # -- request normalization ---------------------------------------------

    def _normalize(self, req: TuneRequest) -> _Pending:
        if (req.kernel is None) == (req.arrivals is None):
            raise ValueError(
                "a TuneRequest needs exactly one of kernel= or arrivals=")
        if req.objective not in ("cycles", "energy", "edp", "pareto"):
            raise ValueError(
                f"unknown objective {req.objective!r}; choose from "
                f"('cycles', 'energy', 'edp', 'pareto')")
        if req.kernel is not None:
            if req.kernel not in workloads.ARRIVAL_KERNELS:
                raise ValueError(
                    f"unknown kernel {req.kernel!r}; choose from "
                    f"{workloads.ARRIVAL_KERNELS}")
            n = int(req.n_pes or req.cfg.n_pes)
            trials = int(req.n_trials or self.config.default_n_trials)
            arrivals = workloads.arrival_batch(
                _kernel_key(req.kernel, self.device), req.kernel,
                (trials, n), req.cfg).to(torch.float32)
            label = req.kernel
        else:
            arrivals = torch.as_tensor(req.arrivals, dtype=torch.float32,
                                       device=self.device)
            if arrivals.ndim == 1:
                arrivals = arrivals[None]
            if arrivals.ndim != 2:
                raise ValueError(
                    f"arrivals must be (n_trials, n_pes), got shape "
                    f"{tuple(arrivals.shape)}")
            if req.n_pes is not None and int(req.n_pes) != arrivals.shape[-1]:
                raise ValueError(
                    f"n_pes={req.n_pes} but the trace has "
                    f"{arrivals.shape[-1]} PEs")
            n = arrivals.shape[-1]
            trials = arrivals.shape[0]
            label = f"trace:{_trace_digest(arrivals)[:8]}"
        # The worker reads the arrivals on its own stream: they must be
        # complete before the request is queued.
        _drain(self.device)
        prune = req.prune or _auto_prune(n)
        key = request_key(req, arrivals, n, trials, prune)
        group = (n, repr(req.cfg), prune, trials, req.placements, req.core)
        with self._lock:
            seq = self._seq
            self._seq += 1
        return _Pending(req, arrivals, label, key, group, seq,
                        self._clock())

    def _retry_after_locked(self) -> float:
        per_batch = max(self._ewma or 0.0, self.config.batch_window)
        batches_ahead = 1 + len(self._queue) // max(1, self.config.max_batch)
        return per_batch * batches_ahead

    # -- worker -------------------------------------------------------------

    def _serve_loop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)   # this thread's device
        while True:
            with self._cond:
                while not self._queue and not self._closing:
                    self._cond.wait(0.1)
                if not self._queue:
                    return                   # closing and fully drained
                if not self._closing and self.config.batch_window > 0:
                    self._cond.wait(self.config.batch_window)
                if not self._queue:
                    continue     # drained by a non-drain close mid-wait
                batch = self._take_batch_locked()
                self._processing = True
            try:
                self._process(batch)
            except BaseException as e:       # never kill the worker
                for p in batch:
                    if not p.done:
                        self._finish(p, TuneResponse(
                            schedule=None, placement=None, name="",
                            objective=p.req.objective, provenance=FAILED,
                            tier=TIER_NONE, detail=f"internal error: {e!r}"))
            finally:
                with self._cond:
                    self._processing = False
                    self._cond.notify_all()

    def _take_batch_locked(self) -> List[_Pending]:
        self._queue.sort(key=lambda p: (-p.req.priority, p.seq))
        group = self._queue[0].group
        batch, rest = [], []
        for p in self._queue:
            if len(batch) < self.config.max_batch and p.group == group:
                batch.append(p)
            else:
                rest.append(p)
        self._queue = rest
        return batch

    def _process(self, batch: List[_Pending]) -> None:
        now = self._clock()
        todo = []
        for p in batch:
            payload = self._cached(p.key)
            if payload is not None:
                self._finish_from_payload(p, payload, CACHE_HIT, TIER_CACHE)
                continue
            todo.append(p)
        ready = []
        for p in todo:
            if p.deadline_at is not None:
                remaining = p.deadline_at - now
                estimate = self._ewma or 0.0
                if remaining <= estimate:
                    self._degrade(
                        p, f"deadline: {remaining:.3f}s budget left, "
                           f"sweep estimated at {estimate:.3f}s")
                    continue
            ready.append(p)
        if not ready:
            return
        if not self._breaker_allows():
            for p in ready:
                self._degrade(p, "circuit breaker open: serving "
                                 "cache/fallback only")
            return
        t0 = self._clock()
        try:
            res, fault_counts = self._dispatch(ready)
            # The estimate covers the device's work, not its enqueueing.
            _drain(self.device)
        except Exception as e:
            self._note_batch_outcome(ok=False, fault_counts={})
            for p in ready:
                self._degrade(p, f"batch dispatch failed: {e}")
            return
        dt = self._clock() - t0
        a = self.config.ewma_alpha
        self._ewma = dt if self._ewma is None else a * dt + (1 - a) * self._ewma
        self._note_batch_outcome(ok=True, fault_counts=fault_counts)
        self.stats.batches += 1
        self.stats.batch_requests += len(ready)
        winners = tuning.best_for_arrival_stack(
            res, tuple(p.req.objective for p in ready))
        slices = sweep_mod.split_kernels(res)
        for p, win, piece in zip(ready, winners, slices):
            payload = {
                "pair": schedule_cache.encode_pair(
                    win.schedule, win.placement, objective=p.req.objective),
                "name": win.name,
                "mean_span": win.mean_span,
                "mean_energy": win.mean_energy,
            }
            self._memo[p.key] = payload
            schedule_cache.store(p.key, payload)
            self.stats.exact += 1
            self._finish(p, TuneResponse(
                schedule=win.schedule, placement=win.placement,
                name=win.name, objective=p.req.objective,
                provenance=BATCHED, tier=TIER_EXACT,
                mean_span=win.mean_span, mean_energy=win.mean_energy,
                batch_size=len(ready), result=piece))

    # -- dispatch -----------------------------------------------------------

    def _stack_for(self, sample: _Pending) -> tuple:
        if sample.group not in self._stacks:
            n, _, prune, _, placements, _ = sample.group
            schedules = tuning.all_schedules(n, sample.req.cfg, prune=prune)
            scheds, placs = tuning._cross_placements(
                schedules, placements, sample.req.cfg)
            self._stacks[sample.group] = (scheds, placs)
        return self._stacks[sample.group]

    def _dispatch(self, ready: List[_Pending]):
        """One batched sweep over every request in ``ready`` (same
        group), with retry + backoff.  Returns ``(result,
        fault_counts)``; raises after ``max_batch_retries``."""
        scheds, placs = self._stack_for(ready[0])
        arrivals = torch.stack([p.arrivals for p in ready])
        labels = tuple(p.label for p in ready)
        cfg = ready[0].req.cfg
        core = ready[0].req.core
        rcfg = self._batch_resilience()
        attempt = 0
        while True:
            idx = self._n_dispatches
            self._n_dispatches += 1
            try:
                if self._fault_plan is not None and rcfg is None:
                    # The resilient path feeds the plan to its own chunk
                    # boundaries; the plain path fires it here.
                    self._fault_plan.at_chunk(idx)
                if rcfg is not None:
                    rep = resilient_sweep_arrivals(
                        arrivals, scheds, cfg, placements=placs,
                        kernels=labels, resilience=rcfg, core=core,
                        fault_plan=self._fault_plan, devices=self._devices,
                        sleep=self._sleep, device=self.device)
                    self.stats.backoff_seconds += rep.backoff_seconds
                    return rep.result, dict(rep.fault_counts)
                res = sweep_mod.sweep_arrivals(
                    arrivals, scheds, cfg, placements=placs,
                    kernels=labels, core=core)
                return res, {}
            except Exception as e:
                cls = type(e).__name__
                self.stats.faults[cls] = self.stats.faults.get(cls, 0) + 1
                self.stats.batch_failures += 1
                if attempt >= self.config.max_batch_retries:
                    raise
                delay = backoff_delay(attempt,
                                      base=self.config.backoff_base,
                                      cap=self.config.backoff_cap,
                                      jitter=self.config.backoff_jitter)
                self.stats.backoff_seconds += delay
                self._sleep(delay)
                attempt += 1

    def _batch_resilience(self) -> Optional[ResilienceConfig]:
        rcfg = self.config.resilience
        if rcfg is None:
            return None
        # Each dispatch gets its own chunk store under the configured
        # root; retries of the same batch reuse it (resume, not redo).
        sub = os.path.join(rcfg.ckpt_dir, f"batch{self._n_dispatches:06d}")
        return dataclasses.replace(rcfg, ckpt_dir=sub)

    # -- circuit breaker ----------------------------------------------------

    def _breaker_allows(self) -> bool:
        if self._breaker_open_since is None:
            return True
        if (self._clock() - self._breaker_open_since
                >= self.config.breaker_probe_after):
            self._breaker_probing = True     # half-open: one probe batch
            return True
        return False

    def _note_batch_outcome(self, ok: bool,
                            fault_counts: Dict[str, int]) -> None:
        for cls, count in fault_counts.items():
            self.stats.faults[cls] = self.stats.faults.get(cls, 0) + count
        breaker_faults = (fault_counts.get(DeviceLoss.__name__, 0)
                          + fault_counts.get(SimulatedOOM.__name__, 0))
        if ok and breaker_faults == 0:
            self._breaker_failures = 0
            self._breaker_open_since = None
        else:
            self._breaker_failures += 1
            if (self._breaker_failures >= self.config.breaker_threshold
                    or self._breaker_probing):
                self._breaker_open_since = self._clock()
        self._breaker_probing = False

    # -- the degradation ladder ---------------------------------------------

    def _cached(self, key: tuple) -> Optional[dict]:
        payload = self._memo.get(key)
        if payload is None:
            payload = schedule_cache.load(key)
            if payload is not None:
                self._memo[key] = payload
        return payload

    def _finish_from_payload(self, p: _Pending, payload: dict,
                             provenance: str, tier: str,
                             detail: str = "") -> None:
        sched, plc = schedule_cache.decode_pair(payload["pair"], p.req.cfg)
        if provenance == CACHE_HIT:
            self.stats.cache_hits += 1
        else:
            self.stats.degraded += 1
        self._finish(p, TuneResponse(
            schedule=sched, placement=plc,
            name=payload.get("name",
                             barrier.schedule_name(sched, plc)),
            objective=p.req.objective, provenance=provenance, tier=tier,
            mean_span=float(payload.get("mean_span", float("nan"))),
            mean_energy=float(payload.get("mean_energy", float("nan"))),
            detail=detail))

    def _degrade(self, p: _Pending, reason: str) -> None:
        """Tiers 2-3: cache hit, else closed-form best-uniform.  A
        degraded response is always labeled, never silently wrong, and
        never dropped."""
        payload = self._cached(p.key)
        if payload is not None:
            self._finish_from_payload(p, payload, DEGRADED, TIER_CACHE,
                                      detail=reason)
            return
        try:
            sched, sp, en = fallback_uniform(
                p.arrivals.shape[-1], p.req.cfg, p.req.objective)
            self.stats.degraded += 1
            self._finish(p, TuneResponse(
                schedule=sched, placement=None,
                name=barrier.schedule_name(sched),
                objective=p.req.objective, provenance=DEGRADED,
                tier=TIER_FALLBACK, mean_span=sp, mean_energy=en,
                detail=reason))
        except Exception as e:
            self.stats.failed += 1
            self._finish(p, TuneResponse(
                schedule=None, placement=None, name="",
                objective=p.req.objective, provenance=FAILED,
                tier=TIER_NONE, detail=f"{reason}; fallback failed: {e}"))

    def _finish(self, p: _Pending, response: TuneResponse) -> None:
        response.latency_s = self._clock() - p.submit_at
        for ticket in p.tickets:
            ticket._finish(response)

    # -- queue checkpoint ---------------------------------------------------

    def _queue_ckpt_path(self) -> Optional[Path]:
        if self.config.ckpt_dir is None:
            return None
        return Path(self.config.ckpt_dir) / "queue.json"

    def _checkpoint_queue(self, parked: List[_Pending]) -> None:
        path = self._queue_ckpt_path()
        if path is None or not parked:
            return
        path.parent.mkdir(parents=True, exist_ok=True)
        entries = [self._encode_request(p.req) for p in parked]
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps(entries, indent=1))
        os.replace(tmp, path)

    def _restore_queue(self) -> None:
        path = self._queue_ckpt_path()
        if path is None or not path.exists():
            return
        try:
            entries = json.loads(path.read_text())
        except (OSError, json.JSONDecodeError):
            return
        try:
            path.unlink()
        except OSError:
            pass
        for entry in entries:
            try:
                req = self._decode_request(entry)
                self._queue.append(self._normalize(req))
                self.stats.restored += 1
            except Exception:
                continue              # an unrestorable entry is dropped

    @staticmethod
    def _encode_request(req: TuneRequest) -> dict:
        d = {"objective": req.objective, "priority": req.priority,
             "n_pes": req.n_pes, "n_trials": req.n_trials,
             "prune": req.prune, "core": req.core,
             "placements": (list(req.placements)
                            if req.placements is not None else None),
             "cfg_class": type(req.cfg).__name__,
             "cfg": dataclasses.asdict(req.cfg)}
        if req.kernel is not None:
            d["kernel"] = req.kernel
        else:
            d["arrivals"] = _host(req.arrivals).tolist()
        return d

    @staticmethod
    def _decode_request(entry: dict) -> TuneRequest:
        cls = getattr(topology_mod, entry["cfg_class"])
        cfg = cls(**entry["cfg"])
        placements = entry.get("placements")
        return TuneRequest(
            kernel=entry.get("kernel"),
            arrivals=(np.asarray(entry["arrivals"], np.float32)
                      if "arrivals" in entry else None),
            n_pes=entry.get("n_pes"), cfg=cfg,
            objective=entry.get("objective", "cycles"),
            deadline=None,            # budgets don't survive a restart
            priority=int(entry.get("priority", 0)),
            n_trials=entry.get("n_trials"), prune=entry.get("prune"),
            placements=(tuple(placements) if placements else None),
            core=entry.get("core"))
