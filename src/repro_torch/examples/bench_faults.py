"""Barrier tail latency and the 5G pipeline under PE failures, on an
NVIDIA GPU: the two measurements of ``benchmarks/bench_faults.py`` with
the same defaults, computed by the port.

1. **Degradation sweep.**  One base draw of uniform arrivals (scatter
   512 cycles, 64 trials, N = 1024) is fail-stop masked at each PE
   failure rate and stacked along the kernel axis of one
   ``sweep.sweep_arrivals`` call, across the hierarchy-pruned
   compositions plus the radix-32 tree and the central counter (130
   schedules), under a 2000-cycle watchdog and a 0.95 quorum.  Per
   rate: the fault-free latency tuner's pick (argmin mean span on the
   clean arrivals, plain cores) against the robust pick (argmin p99
   span at that rate, ``"lower"`` interpolation), both on the same
   faulted arrivals.
2. **5G under PE loss.**  ``fiveg.degradation_curve`` for the central
   counter, the radix-32 tree and the hardware event unit at (16, 1).

Both draw from the partitionable threefry stream, today's JAX default;
``--threefry original`` draws them from the original stream
(``prng.threefry_partitionable(False)``), in which the reference's
``BENCH_faults.json`` was drawn, and then reproduces that file.

Prints one JSON line per measurement, rounded as the reference's file
rounds them; ``--out PATH`` also writes the record there (the
reference's ``BENCH_faults.json`` is never written).

    PYTHONPATH=src python -m repro_torch.examples.bench_faults \
        [--threefry original] [--out P]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import barrier, fiveg, prng, sweep, tuning
from repro_torch.core.topology import DEFAULT, TeraPoolConfig

KEY = 0
DELAY = 512.0       # base arrival scatter (cycles), the Fig. 4 mid-regime
N_PES = 1024
RATES = (0.0, 0.005, 0.01, 0.02, 0.05)
TRIALS = 64
TIMEOUT = 2000.0
QUORUM = 0.95
FIVEG_APP = dict(n_rx=16, ffts_per_round=1)
FIVEG_MODES = ("central", "tree", "hw")


def _cfg(n: int) -> TeraPoolConfig:
    return DEFAULT if n == DEFAULT.n_pes else TeraPoolConfig(n_pes=n)


def schedule_stack(cfg: TeraPoolConfig) -> list:
    """The hierarchy-pruned compositions plus the wide shallow baselines
    (radix-32 tree, central counter) when the pruning leaves them out."""
    scheds = list(tuning.all_schedules(cfg.n_pes, cfg, prune="hierarchy"))
    names = {barrier.schedule_name(s) for s in scheds}
    for extra in (barrier.kary_tree(min(32, cfg.n_pes), cfg=cfg),
                  barrier.central_counter(cfg=cfg)):
        if barrier.schedule_name(extra) not in names:
            scheds.append(extra)
    return scheds


def faulted_stack(key: torch.Tensor, n: int, n_trials: int) -> torch.Tensor:
    """(R, T, N) arrivals on ``key``'s device: one base draw, fail-stop
    masked per rate (the rate-0 slice is the clean workload)."""
    k = prng.split(key)
    base = prng.uniform(k[0], (n_trials, n), 0.0, DELAY)
    return torch.stack([
        torch.where(prng.bernoulli(prng.fold_in(k[1], i), rate,
                                   (n_trials, n)), torch.inf, base)
        for i, rate in enumerate(RATES)])


def degradation_sweep(n_pes: int = N_PES, n_trials: int = TRIALS,
                      device="cuda") -> tuple:
    """The degradation sweep (smaller machines and trial counts for
    tests).  Returns ``(record, res, i_lat)``: the record as the
    reference's file holds it (rounded), the robust
    :class:`~repro_torch.core.sweep.ArrivalSweepResult` ``(S, R, T)``
    and the latency tuner's schedule index."""
    cfg = _cfg(n_pes)
    scheds = schedule_stack(cfg)
    arrivals = faulted_stack(prng.PRNGKey(KEY, device=device), n_pes,
                             n_trials)
    labels = tuple(f"fail_{r:g}" for r in RATES)
    chunk = min(16, n_trials)
    res = sweep.sweep_arrivals(arrivals, scheds, cfg, kernels=labels,
                               faults=barrier.fault_spec(TIMEOUT, QUORUM),
                               trial_chunk=chunk)
    clean = sweep.sweep_arrivals(arrivals[:1], scheds, cfg,
                                 kernels=labels[:1], trial_chunk=chunk)
    i_lat = int(np.argmin(clean.mean_span.cpu().numpy()[:, 0]))
    spans = res.mean_span.cpu().numpy()
    p99 = tuning._objective_grid(res, "p99_cycles")
    completion = res.completion_rate.cpu().numpy()
    abandoned = res.abandoned_pes.to(torch.float32).mean(dim=-1).cpu()

    def point(i: int, j: int) -> dict:
        return {"schedule": res.names[i],
                "p99_cycles": round(float(p99[i, j]), 1),
                "mean_cycles": round(float(spans[i, j]), 1),
                "completion_rate": round(float(completion[i, j]), 5),
                "abandoned_pes_mean": round(float(abandoned[i, j]), 2)}

    curve = []
    for j, rate in enumerate(RATES):
        lat = point(i_lat, j)
        rob = point(int(np.argmin(p99[:, j])), j)
        curve.append({"fail_rate": rate, "latency_tuned": lat,
                      "robust_tuned": rob,
                      "p99_improvement": round(
                          lat["p99_cycles"] / max(rob["p99_cycles"], 1e-9),
                          4)})
    beats = [c["p99_improvement"] > 1.0 for c in curve
             if c["fail_rate"] >= 0.01]
    record = {"n_pes": n_pes, "n_schedules": len(scheds),
              "n_trials": n_trials, "base_delay": DELAY,
              "timeout_cycles": TIMEOUT, "quorum_frac": QUORUM,
              "curve": curve,
              "robust_beats_latency_at_1pct": bool(beats and all(beats))}
    return record, res, i_lat


def fiveg_degradation(device="cuda") -> tuple:
    """The 5G degradation curve.  Returns ``(record, curve)``: the
    rounded record and :func:`~repro_torch.core.fiveg.degradation_curve`'s
    results."""
    curve = fiveg.degradation_curve(
        prng.PRNGKey(KEY, device=device), RATES,
        fiveg.FiveGConfig(**FIVEG_APP), modes=FIVEG_MODES, core="scan",
        timeout_cycles=TIMEOUT, quorum_frac=QUORUM, device=device)
    record = {"n_pes": N_PES, "fail_rates": list(RATES)}
    for mode in FIVEG_MODES:
        record[mode] = [{
            "fail_rate": r,
            "total_cycles": round(res.total_cycles.item(), 1),
            "completion_rate": round(res.completion_rate.item(), 5),
            "timed_out_levels": round(res.timed_out_levels.item(), 1),
        } for r, res in zip(RATES, curve[mode])]
    return record, curve


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the record as JSON to this path")
    ap.add_argument("--threefry", choices=("partitionable", "original"),
                    default="partitionable",
                    help="the random stream of both measurements")
    args = ap.parse_args(argv)
    with prng.threefry_partitionable(args.threefry == "partitionable"):
        record = {"degradation": degradation_sweep()[0],
                  "fiveg": fiveg_degradation()[0]}
    for name, value in record.items():
        print(json.dumps({name: value}), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(record, indent=2) + "\n")


if __name__ == "__main__":
    main()
