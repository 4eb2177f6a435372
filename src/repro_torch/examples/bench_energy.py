"""Hardware-against-software barriers on the latency x energy plane, on
an NVIDIA GPU: the three measurements of ``benchmarks/bench_energy.py``
with the same defaults, computed by the port.

1. **Energy per barrier against N**: mean episode energy (pJ) and span
   (cycles) of the central counter, the radix-32 tree and the hardware
   event unit at 64, 256 and 1024 PEs, simultaneous arrival, 8 trials.
2. **Pareto front at the largest N**: the latency x energy front over
   every composition of the 1024-PE cluster (512 schedules) at delay 0,
   with the event unit's point beside it.
3. **5G energy overhead**: ``fiveg.compare_barriers`` for the central
   counter, the radix-32 tree and the event unit at 1024 PEs.  The
   reference's file was drawn with ``jax_threefry_partitionable`` off,
   so this section draws from the port's original threefry stream
   (``prng.threefry_partitionable(False)``).

Prints one JSON line per section, rounded as the reference's file rounds
them, and the wall time of each; ``--out PATH`` writes the record
(default ``build/BENCH_torch_energy.json``; the reference's
``BENCH_energy.json`` is never written).

    PYTHONPATH=src python -m repro_torch.examples.bench_energy [--device cpu]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.core import barrier, fiveg, prng, sweep, tuning
from repro_torch.core.topology import DEFAULT, TeraPoolConfig
from repro_torch.timing import wall_us

KEY = 0
N_TRIALS = 8
DELAY = 0.0       # simultaneous arrival: the contention-bound regime
NS = (64, 256, 1024)
FIVEG_N = 1024
FIVEG_MODES = ("central", "tree", "hw")
OUT = Path("build") / "BENCH_torch_energy.json"


def _cfg(n: int) -> TeraPoolConfig:
    return DEFAULT if n == DEFAULT.n_pes else TeraPoolConfig(n_pes=n)


def mode_stack(cfg: TeraPoolConfig) -> list:
    """``(name, schedule)``: central counter, radix-32 tree, event unit."""
    k = min(32, cfg.n_pes)
    return [("central", barrier.central_counter(cfg=cfg)),
            (f"tree{k}", barrier.kary_tree(k, cfg=cfg)),
            ("hw", barrier.hw_event_unit(cfg=cfg))]


def energy_per_barrier(ns=NS, device="cuda") -> tuple:
    """Section 1; returns ``(record, wall)``, the wall seconds per N."""
    out, wall = {}, {}
    for n in ns:
        cfg = _cfg(n)
        names, scheds = zip(*mode_stack(cfg))
        res, steady_us, first_us = wall_us(lambda: sweep.sweep_schedules(
            prng.PRNGKey(KEY, device=device), list(scheds), delays=(DELAY,),
            n_trials=N_TRIALS, cfg=cfg, device=device), device)
        span = res.mean_span[:, 0].tolist()
        energy = res.mean_energy[:, 0].tolist()
        entry = {name: {"span_cycles": round(span[i], 1),
                        "energy_pj": round(energy[i], 1)}
                 for i, name in enumerate(names)}
        hw = names.index("hw")
        entry["hw_dominates_software"] = all(
            span[hw] < span[i] and energy[hw] < energy[i]
            for i, name in enumerate(names) if name != "hw")
        out[f"N={n}"] = entry
        wall[f"N={n}"] = {"steady_us": steady_us, "first_us": first_us}
    return out, wall


def pareto(n: int = max(NS), device="cuda") -> tuple:
    """Section 2; returns ``(record, wall)``."""
    cfg = _cfg(n)
    scheds = tuning.all_schedules(n, cfg, prune="none")
    res, steady_us, first_us = wall_us(lambda: tuning.tune_barrier(
        prng.PRNGKey(KEY, device=device), n, delays=(DELAY,),
        n_trials=N_TRIALS, cfg=cfg, schedules=scheds), device, iters=1)
    front = tuning.pareto_front(res)
    hw = sweep.sweep_schedules(
        prng.PRNGKey(KEY, device=device), [barrier.hw_event_unit(cfg=cfg)],
        delays=(DELAY,), n_trials=N_TRIALS, cfg=cfg, device=device)
    hw_span = hw.mean_span[0, 0].item()
    hw_energy = hw.mean_energy[0, 0].item()
    record = {
        "n_pes": n, "delay": DELAY, "n_schedules": len(scheds),
        "n_software_points": len(front),
        "front": [{"name": p.name, "span_cycles": round(p.mean_span, 1),
                   "energy_pj": round(p.mean_energy, 1)} for p in front],
        "hw_point": {"name": "hw", "span_cycles": round(hw_span, 1),
                     "energy_pj": round(hw_energy, 1)},
        "hw_dominates_front": all(hw_span < p.mean_span
                                  and hw_energy < p.mean_energy
                                  for p in front)}
    return record, {"steady_us": steady_us, "first_us": first_us}


def fiveg_energy(n: int = FIVEG_N, device="cuda") -> tuple:
    """Section 3, on the original threefry stream; returns ``(record,
    wall)``."""
    cfg = _cfg(n)
    with prng.threefry_partitionable(False):
        out, steady_us, first_us = wall_us(lambda: fiveg.compare_barriers(
            prng.PRNGKey(KEY, device=device), modes=FIVEG_MODES, cfg=cfg,
            device=device), device, iters=1)
    record = {"n_pes": n}
    for mode in FIVEG_MODES:
        r = out[mode]
        record[mode] = {
            "total_cycles": round(r.total_cycles.item(), 1),
            "sync_energy_pj": round(r.sync_energy.item(), 1),
            "energy_fraction": round(r.energy_fraction.item(), 5),
            "stage_schedule": r.stage_schedule}
    record["speedup_hw"] = round(out["speedup_hw"].item(), 3)
    record["energy_ratio_hw"] = round(out["energy_ratio_hw"].item(), 2)
    record["energy_ratio_tree"] = round(out["energy_ratio_tree"].item(), 2)
    return record, {"steady_us": steady_us, "first_us": first_us}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args(argv)
    record, wall = {}, {}
    record["energy_per_barrier"], wall["energy_per_barrier"] = \
        energy_per_barrier(device=args.device)
    record["pareto"], wall["pareto"] = pareto(device=args.device)
    record["fiveg"], wall["fiveg"] = fiveg_energy(device=args.device)
    for name, value in record.items():
        print(json.dumps({name: value, "wall_us": wall[name]}), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({**record, "wall_us": wall}, indent=2)
                        + "\n")


if __name__ == "__main__":
    main()
