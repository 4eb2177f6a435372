"""Resilience benchmark on an NVIDIA GPU: what durability costs, and how
fast a killed sweep comes back; the port's counterpart of
``benchmarks/bench_resilience.py``, with its sizes (the hierarchy-pruned
compositions at N = 1024, delays 0 and 512, 16 trials).

* **Checkpoint overhead** — steady wall of the resilient chunk loop
  (:func:`repro_torch.runtime.resilient_sweep_schedules`, a fresh store
  every call, so every chunk is computed AND checkpointed) against the
  plain chunked sweep (:func:`repro_torch.core.sweep.sweep_schedules` at
  the same ``trial_chunk``), at chunks of 4, ``DEFAULT_TRIAL_CHUNK`` and
  16 trials.  The reference's bar is <= 10 % at ``DEFAULT_TRIAL_CHUNK``
  (``accept_overhead_le_10pct``, reported as measured).
* **Recovery latency** — a run killed by an injected
  :class:`~repro_torch.runtime.inject.Preemption` halfway through the
  grid, then resumed: the resumed call's wall, the chunks it restored
  and recomputed, and whether its result equals the plain sweep bit for
  bit.

Walls are host seconds with the device drained (first call and the mean
of two more); chunk stores live under ``--work`` and are removed after.

    PYTHONPATH=src python -m repro_torch.examples.bench_resilience \
        [--device cpu] [--n 1024] [--out build/BENCH_torch_resilience.json]
"""
from __future__ import annotations

import argparse
import json
import shutil
import time
from pathlib import Path

import torch

from repro_torch._device import resolve_device
from repro_torch.core import prng, sweep, tuning
from repro_torch.core.topology import DEFAULT, TeraPoolConfig
from repro_torch.examples.figure_rows import card, write_record
from repro_torch.runtime import (FaultPlan, Preemption, ResilienceConfig,
                                 SimulatedFault, resilient_sweep_schedules)
from repro_torch.runtime.resilient_sweep import DEFAULT_TRIAL_CHUNK
from repro_torch.timing import wall_us

KEY = 0
DELAYS = (0.0, 512.0)
N = 1024
N_TRIALS = 16
CHUNKS = tuple(sorted({4, DEFAULT_TRIAL_CHUNK, 16}))
OUT = Path("build") / "BENCH_torch_resilience.json"
WORK = Path("build") / "bench_resilience"


def _cfg(n: int) -> TeraPoolConfig:
    return DEFAULT if n == DEFAULT.n_pes else TeraPoolConfig(n_pes=n)


def measure(device="cuda", n: int = N, work: Path = WORK) -> dict:
    """The benchmark's record: per chunk size the plain and resilient
    walls and the overhead, then the recovery after a preemption."""
    dev = resolve_device(device)
    cfg = _cfg(n)
    key = prng.PRNGKey(KEY, device=dev)
    prune = "hierarchy" if n > 256 else "none"
    scheds = tuning.all_schedules(n, cfg, prune=prune)
    shutil.rmtree(work, ignore_errors=True)
    record = {"device": card(dev), "n_pes": n, "n_schedules": len(scheds),
              "n_trials": N_TRIALS, "delays": list(DELAYS),
              "default_chunk": DEFAULT_TRIAL_CHUNK, "chunks": {}}
    try:
        for chunk in CHUNKS:
            _, plain_us, plain_first = wall_us(
                lambda: sweep.sweep_schedules(
                    key, scheds, DELAYS, N_TRIALS, cfg, trial_chunk=chunk,
                    device=dev).span_cycles, dev, iters=2, warmup=0)

            def resilient():
                # a fresh store: every timed call computes (and
                # checkpoints) every chunk, never resumes
                d = work / f"chunk{chunk}"
                shutil.rmtree(d, ignore_errors=True)
                rc = ResilienceConfig(ckpt_dir=str(d), trial_chunk=chunk)
                return resilient_sweep_schedules(
                    key, scheds, DELAYS, N_TRIALS, cfg, resilience=rc,
                    device=dev).result.span_cycles

            _, ckpt_us, ckpt_first = wall_us(resilient, dev, iters=2,
                                             warmup=0)
            record["chunks"][str(chunk)] = {
                "plain_us": plain_us, "plain_first_us": plain_first,
                "ckpt_us": ckpt_us, "ckpt_first_us": ckpt_first,
                "overhead_pct": 100.0 * (ckpt_us - plain_us) / plain_us}
        record["accept_overhead_le_10pct"] = bool(
            record["chunks"][str(DEFAULT_TRIAL_CHUNK)]["overhead_pct"]
            <= 10.0)

        # Recovery: kill halfway, then time the resumed call.
        chunk = DEFAULT_TRIAL_CHUNK
        kill_at = -(-N_TRIALS // chunk) // 2
        rc = ResilienceConfig(ckpt_dir=str(work / "recovery"),
                              trial_chunk=chunk)
        plan = FaultPlan(faults={kill_at: Preemption()})
        t0 = time.perf_counter()
        try:
            resilient_sweep_schedules(key, scheds, DELAYS, N_TRIALS, cfg,
                                      resilience=rc, fault_plan=plan,
                                      device=dev)
            raise RuntimeError("the injected preemption never fired")
        except SimulatedFault:
            killed_us = (time.perf_counter() - t0) * 1e6
        t0 = time.perf_counter()
        rep = resilient_sweep_schedules(key, scheds, DELAYS, N_TRIALS, cfg,
                                        resilience=rc, fault_plan=plan,
                                        device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        resumed_us = (time.perf_counter() - t0) * 1e6
        plain = sweep.sweep_schedules(key, scheds, DELAYS, N_TRIALS, cfg,
                                      trial_chunk=chunk, device=dev)
        same = all(torch.equal(getattr(rep.result, f), getattr(plain, f))
                   for f in sweep.BarrierResult._fields)
        record["recovery"] = {
            "chunk": chunk, "killed_at": kill_at, "killed_us": killed_us,
            "resumed_us": resumed_us, "chunks_total": rep.chunks_total,
            "chunks_resumed": rep.chunks_resumed,
            "chunks_computed": rep.chunks_computed,
            "ckpt_seconds": rep.ckpt_seconds,
            "resumed_equals_plain": same}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return record


def rows(record: dict) -> list:
    """The reference benchmark's rows ``(name, us, derived, first_us)``."""
    n = record["n_pes"]
    out = []
    for chunk, c in record["chunks"].items():
        out.append((f"resilience_plain_N{n}_c{chunk}", c["plain_us"],
                    f"{record['n_schedules']}sched", c["plain_first_us"]))
        out.append((f"resilience_ckpt_N{n}_c{chunk}", c["ckpt_us"],
                    f"overhead={c['overhead_pct']:.1f}%", c["ckpt_first_us"]))
    r = record["recovery"]
    out.append((f"resilience_killed_N{n}", r["killed_us"],
                f"killed@chunk{r['killed_at']}", 0.0))
    out.append((f"resilience_recovery_N{n}", r["resumed_us"],
                f"resumed{r['chunks_resumed']}/{r['chunks_total']}", 0.0))
    return out


def run(device="cuda") -> list:
    """Measure at the reference's sizes, write the record to
    :data:`OUT` and return the rows."""
    return rows(write_record(measure(device, N, WORK), OUT))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--out", type=Path, default=OUT)
    ap.add_argument("--work", type=Path, default=WORK,
                    help="directory of the chunk stores (removed after)")
    args = ap.parse_args(argv)
    record = write_record(measure(args.device, args.n, args.work), args.out)
    print(json.dumps({"resilience": record}), flush=True)
    return record


if __name__ == "__main__":
    main()
