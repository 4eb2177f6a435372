"""Fig. 4a/4b on an NVIDIA GPU: barrier cycles against radix and arrival
scatter, the synchronization-free region (SFR) needed for < 10 %
overhead, and claim C3; the port's counterpart of
``benchmarks/fig4_random_delay.py``.

* **fig4a**: every uniform radix of the 1024-PE cluster x 4 delays x 16
  trials in one ``sweep.sweep_barrier`` call; one row per (radix,
  delay), the mean span.
* **fig4b**: from the same sweep, at each delay's best radix (least mean
  span), the barrier's mean residency ``c`` and the overhead
  ``c / (SFR + c)`` at each SFR.
* **C3**: the draws of the reference's own test of the claim
  (``tests/test_barrier_sim.py``): radices 16, 32, 64 and 1024, 8 trials
  at delays 256 and 2048 (not on the fig4 grid).  The SFR for < 10 %
  overhead, 9 times the least mean residency, must fall in (500, 4000)
  cycles at delay 256 and in (4000, 16000) at delay 2048.

Prints one JSON line per section; ``--out PATH`` also writes the record
(default ``build/BENCH_torch_fig4.json``).

    PYTHONPATH=src python -m repro_torch.examples.fig4 [--device cpu]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.core import barrier, barrier_sim, prng, sweep
from repro_torch.timing import wall_us

KEY = 0
N_PES = 1024
DELAYS = (0.0, 128.0, 512.0, 2048.0)
SFRS = (500, 1000, 2000, 5000, 10000, 20000)
N_TRIALS = 16
C3_RADICES = (16, 32, 64, 1024)
C3_TRIALS = 8
# (delay, lower, upper): the claim's band of SFRs at each scatter.
C3_BANDS = ((256.0, 500.0, 4000.0), (2048.0, 4000.0, 16000.0))
OUT = Path("build") / "BENCH_torch_fig4.json"


def run_sweep(device="cuda", n_trials: int = N_TRIALS) -> tuple:
    """The Fig. 4a grid over every radix of the 1024-PE cluster; returns
    ``(res, steady_us, first_us)``."""
    radices = barrier.all_radices(N_PES)
    return wall_us(lambda: sweep.sweep_barrier(
        prng.PRNGKey(KEY, device=device), radices=radices, delays=DELAYS,
        n_pes=N_PES, n_trials=n_trials, device=device), device)


def fig4a(res) -> list:
    """``{"radix", "delay", "mean_span"}`` per grid point."""
    spans = res.mean_span.cpu().tolist()
    return [{"radix": int(r), "delay": d, "mean_span": spans[i][j]}
            for i, r in enumerate(res.radices.tolist())
            for j, d in enumerate(res.delays.tolist())]


def fig4b(res) -> list:
    """Per delay: the best radix, its mean residency and the overhead at
    each SFR, from the fig4a sweep (no new simulation)."""
    spans = res.mean_span.cpu().numpy()
    resid = res.mean_residency_grid.cpu().numpy()
    radices = res.radices.tolist()
    rows = []
    for j, delay in enumerate(res.delays.tolist()):
        i = int(spans[:, j].argmin())
        cost = float(resid[i, j])
        rows.append({"delay": delay, "radix": radices[i],
                     "mean_residency": cost,
                     "overhead": {str(sfr): round(cost / (sfr + cost), 4)
                                  for sfr in SFRS}})
    return rows


def claim_c3(device="cuda", n_trials: int = C3_TRIALS) -> list:
    """Claim C3 on the reference test's draws: per delay, the least mean
    residency over ``C3_RADICES``, the SFR it needs (9 times that) and
    whether the SFR falls in the claim's band."""
    key = prng.PRNGKey(KEY, device=device)
    out = []
    for delay, lo, hi in C3_BANDS:
        arr = barrier_sim.uniform_arrivals(key, delay, N_PES, n_trials,
                                           device=device)
        costs = [barrier_sim.simulate(arr, barrier.kary_tree(r),
                                      device=device)
                 .mean_residency.mean().item() for r in C3_RADICES]
        sfr = min(costs) * 9.0
        out.append({"delay": delay, "costs": dict(zip(
            map(str, C3_RADICES), costs)), "sfr_needed": sfr,
            "band": [lo, hi], "holds": lo < sfr < hi})
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args(argv)
    res, steady_us, first_us = run_sweep(args.device)
    record = {"fig4a": fig4a(res), "fig4b": fig4b(res),
              "c3": claim_c3(args.device),
              "timing": {"grid": list(res.span_cycles.shape),
                         "steady_us": steady_us, "first_us": first_us}}
    for name, value in record.items():
        print(json.dumps({name: value}), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(record, indent=2) + "\n")
    if not all(c["holds"] for c in record["c3"]):
        raise SystemExit(f"claim C3 does not hold: {record['c3']}")


if __name__ == "__main__":
    main()
