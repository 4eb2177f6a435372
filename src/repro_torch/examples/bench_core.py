"""Core-performance benchmark on an NVIDIA GPU: the simulator cores head
to head; the port's counterpart of ``benchmarks/bench_core.py``, with
its grids.

Times the three hot grids — the Fig. 4 uniform-radix sweep
(``sweep_barrier``, 16 trials), the exhaustive mixed-radix tuner grid
(``tune_barrier``: every composition, 4 trials) and the workload
arrival sweep (``tuning.sweep_workloads`` over three kernels, 4
trials), each over delays 0/128/512/2048 where it has them — under
both simulator cores (the full-width ``scan`` core and the shrinking-
width ``telescope`` core) at N = 256 and 1024.

Reports steady microseconds per grid POINT (one simulated barrier
episode; host wall with the device drained, the mean of two calls after
one warm-up) with the first call apart, and whether both cores gave
equal spans on every grid.

    PYTHONPATH=src python -m repro_torch.examples.bench_core \
        [--device cpu] [--ns 256,1024] [--out build/BENCH_torch_core.json]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from repro_torch._device import resolve_device
from repro_torch.core import prng, sweep, tuning
from repro_torch.examples.figure_rows import card, write_record
from repro_torch.timing import wall_us

KEY = 0
DELAYS = (0.0, 128.0, 512.0, 2048.0)
CORES = ("scan", "telescope")
KERNELS = ("dotp_1Mi", "conv2d_256x256", "matmul_256x128x256")
NS = (256, 1024)
OUT = Path("build") / "BENCH_torch_core.json"


def grids(n: int, device):
    """``(grid_name, n_points, fn(core))`` for the three hot grids."""
    key = prng.PRNGKey(KEY, device=device)
    n_sched = len(tuning.enumerate_compositions(n))
    n_radices = n.bit_length() - 1
    yield ("sweep_barrier", n_radices * len(DELAYS) * 16,
           lambda core: sweep.sweep_barrier(
               key, n_pes=n, delays=DELAYS, n_trials=16, core=core,
               device=device))
    yield ("tune_barrier", n_sched * len(DELAYS) * 4,
           lambda core: tuning.tune_barrier(
               key, n, delays=DELAYS, n_trials=4, core=core))
    yield ("sweep_arrivals", n_sched * len(KERNELS) * 4,
           lambda core: tuning.sweep_workloads(
               key, KERNELS, n, n_trials=4, core=core))


def measure(device="cuda", ns=NS) -> dict:
    """The benchmark's record: per N and grid, each core's steady and
    first-call walls and microseconds per point, the speedup of the
    telescope core and whether the two cores' spans are equal."""
    dev = resolve_device(device)
    record = {"device": card(dev)}
    for n in ns:
        record[f"N={n}"] = {}
        for gname, n_points, fn in grids(n, dev):
            entry = {"points": n_points}
            spans = {}
            for core in CORES:
                spans[core], steady_us, first_us = wall_us(
                    lambda: fn(core).span_cycles, dev, iters=2)
                entry[core] = {"steady_us": steady_us, "first_us": first_us,
                               "us_per_point": steady_us / n_points}
            entry["speedup"] = (entry["scan"]["us_per_point"]
                                / entry["telescope"]["us_per_point"])
            entry["cores_equal"] = torch.equal(spans["scan"],
                                               spans["telescope"])
            record[f"N={n}"][gname] = entry
    return record


def rows(record: dict) -> list:
    """The reference benchmark's rows ``(name, us, derived, first_us)``."""
    out = []
    for nkey, grids_ in record.items():
        if not nkey.startswith("N="):
            continue
        n = nkey[2:]
        for gname, entry in grids_.items():
            for core in CORES:
                c = entry[core]
                out.append((f"core_{gname}_N{n}_{core}", c["us_per_point"],
                            f"{entry['points']}pts", c["first_us"]))
            out.append((f"core_{gname}_N{n}_speedup", 0.0,
                        round(entry["speedup"], 2), 0.0))
    return out


def run(device="cuda") -> list:
    """Measure at the reference's sizes, write the record to
    :data:`OUT` and return the rows."""
    return rows(write_record(measure(device, NS), OUT))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ns", default=",".join(map(str, NS)),
                    help="comma-separated cluster sizes")
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args(argv)
    ns = tuple(int(x) for x in args.ns.split(","))
    record = write_record(measure(args.device, ns), args.out)
    print(json.dumps({"core": record}), flush=True)
    return record


if __name__ == "__main__":
    main()
