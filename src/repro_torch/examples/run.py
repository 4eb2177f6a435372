"""Benchmark runner of the port: one tag per ported driver; the port's
counterpart of ``benchmarks/run.py``.

Prints CSV rows under the reference's header,
``name,us_per_call,derived,compile_us``; the last column holds each
driver's first-call wall in place of the reference's compile time (0.0
where a driver reports none).  Each tag
calls its driver's own entry functions on the card (``--device``):

    PYTHONPATH=src python -m repro_torch.examples.run --list
    PYTHONPATH=src python -m repro_torch.examples.run serving [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.run          # every tag

``collectives`` and ``roofline`` have no driver in the port yet: asking
for one raises ``NotImplementedError`` naming its ``ROADMAP.md`` item,
and a run of every tag raises the same after the ported ones.
"""
from __future__ import annotations

import argparse

from repro_torch.examples import (bench_core, bench_energy, bench_faults,
                                  bench_multicluster, bench_resilience,
                                  bench_serving, fig4, fig5, fig6, fig7,
                                  fig_placement, fig_tuned_tree,
                                  fig_workload_tuned)
from repro_torch.timing import wall_us

HEADER = "name,us_per_call,derived,compile_us"

# Tags of the reference's runner that the port does not run yet.
NOT_PORTED = {
    "collectives": "benchmarks/collectives_bench.py needs the port's "
                   "collectives and device meshes (ROADMAP.md queue 1 "
                   "item 2, collectives and multi-device)",
    "roofline": "benchmarks/roofline_table.py needs the port's launch "
                "analysis (ROADMAP.md queue 1 item 5, launch analysis)",
}


def _fig4(device) -> list:
    res, steady_us, first_us = fig4.run_sweep(device)
    out = [("fig4a_sweep_grid", steady_us,
            "x".join(map(str, res.span_cycles.shape)), first_us)]
    out += [(f"fig4a_radix{p['radix']}_delay{int(p['delay'])}", 0.0,
             round(p["mean_span"], 1), 0.0) for p in fig4.fig4a(res)]
    out += [(f"fig4b_delay{int(p['delay'])}_sfr{sfr}_radix{p['radix']}", 0.0,
             frac, 0.0)
            for p in fig4.fig4b(res) for sfr, frac in p["overhead"].items()]
    return out


def _multicluster(device) -> list:
    out = []
    for n in bench_multicluster.NS:
        entry = bench_multicluster.bench_machine(n, device)
        s = entry["sweep"]
        out.append((f"mc_sweep_N{n}", s["us_per_point"], f"{s['points']}pts",
                    s["first_us"] / s["points"]))
        out.append((f"mc_hier_vs_central_N{n}", 0.0,
                    entry["hier_vs_flat"]["speedup_vs_central"], 0.0))
        w = entry["widths"]
        out.append((f"mc_widths_N{n}", w["tight"]["steady_us"],
                    round(w["speedup"], 2), w["tight"]["first_us"]))
    return out


def _energy(device) -> list:
    record, wall = bench_energy.energy_per_barrier(device=device)
    out = [(f"energy_modes_{nkey.replace('=', '')}", wall[nkey]["steady_us"],
            f"hwE={entry['hw']['energy_pj']}pJ", wall[nkey]["first_us"])
           for nkey, entry in record.items()]
    pareto, w = bench_energy.pareto(device=device)
    out.append((f"energy_pareto_N{pareto['n_pes']}", w["steady_us"],
                f"{pareto['n_software_points']}pts", w["first_us"]))
    fiveg, w = bench_energy.fiveg_energy(device=device)
    out.append((f"energy_5g_N{fiveg['n_pes']}", w["steady_us"],
                f"ratio={fiveg['energy_ratio_hw']}", w["first_us"]))
    return out


def _faults(device) -> list:
    (record, _, _), steady_us, first_us = wall_us(
        lambda: bench_faults.degradation_sweep(device=device), device,
        iters=1, warmup=0)
    n, k = record["n_pes"], len(record["curve"])
    out = [(f"faults_rate{c['fail_rate']:g}_N{n}", steady_us / k,
            f"p99 {c['latency_tuned']['p99_cycles']}->"
            f"{c['robust_tuned']['p99_cycles']}", first_us / k)
           for c in record["curve"]]
    (fiveg, _), steady_us, first_us = wall_us(
        lambda: bench_faults.fiveg_degradation(device=device), device,
        iters=1, warmup=0)
    out.append((f"faults_5g_N{fiveg['n_pes']}", steady_us,
                f"{len(fiveg['fail_rates'])}rates x "
                f"{len(bench_faults.FIVEG_MODES)}modes", first_us))
    return out


# The reference runner's tags, in its order, and each one's driver
# (``None``: not ported yet).
DRIVERS = {
    "fig4": fig4, "fig5": fig5, "fig6": fig6, "fig7": fig7,
    "tuned": fig_tuned_tree, "placement": fig_placement,
    "workload": fig_workload_tuned, "core": bench_core,
    "multicluster": bench_multicluster, "energy": bench_energy,
    "collectives": None, "resilience": bench_resilience,
    "faults": bench_faults, "serving": bench_serving, "roofline": None,
}
# Drivers that return records: their rows are made here.  The others'
# ``run(device)`` returns the rows.
ADAPTERS = {"fig4": _fig4, "multicluster": _multicluster,
            "energy": _energy, "faults": _faults}


def describe(tag: str) -> str:
    """The first line of the tag's driver's docstring."""
    if DRIVERS[tag] is None:
        return f"not ported: {NOT_PORTED[tag]}"
    return DRIVERS[tag].__doc__.strip().splitlines()[0]


def rows(tag: str, device) -> list:
    """The rows of one tag's driver; raises for the tags not ported."""
    if DRIVERS[tag] is None:
        raise NotImplementedError(f"{tag}: {NOT_PORTED[tag]}")
    if tag in ADAPTERS:
        return ADAPTERS[tag](device)
    return DRIVERS[tag].run(device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tag", nargs="?", choices=tuple(DRIVERS),
                    help="one driver (default: every tag)")
    ap.add_argument("--list", action="store_true",
                    help="print every tag with its driver's description")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.list:
        for tag in DRIVERS:
            print(f"{tag:14s} {describe(tag)}")
        return
    tags = [args.tag] if args.tag else [t for t in DRIVERS
                                        if DRIVERS[t] is not None]
    print(HEADER)
    for tag in tags:
        for name, us, derived, first in rows(tag, args.device):
            print(f"{name},{us:.1f},{derived},{first:.1f}", flush=True)
    if args.tag is None:
        raise NotImplementedError("; ".join(
            f"{tag}: {why}" for tag, why in NOT_PORTED.items()))


if __name__ == "__main__":
    main()
