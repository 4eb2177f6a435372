"""Workload-conditioned tuning on an NVIDIA GPU (beyond the paper's
figures): the hierarchy-pruned compositions of the 1024-PE cluster and
every uniform radix swept over each Fig. 5/6 kernel's measured arrivals
(kernel x schedule x 4 trials in one ``tuning.sweep_workloads`` call),
each kernel's winner against its best uniform radix; then the 5G
application under ``sync="workload"`` beside ``placed``, with the trees
each picks.  The port's counterpart of
``benchmarks/fig_workload_tuned.py`` (``workload_tuned_kernels``,
``workload_5g``), with its key, sizes and row names.

    PYTHONPATH=src python -m repro_torch.examples.fig_workload_tuned [--device cpu]

Prints ``name,us_per_call,derived,first_us`` rows and writes
``build/BENCH_torch_fig_workload_tuned.json`` (``--out``).
"""
from __future__ import annotations

from repro_torch.core import barrier, fiveg, prng, tuning
from repro_torch.examples.figure_rows import main as figure_main
from repro_torch.examples.figure_rows import measure

KEY = 4
N_TRIALS = 4
FIVEG_MODES = ("central", "partial", "placed", "workload")


def schedules() -> list:
    """The hierarchy-pruned compositions plus every uniform radix not
    among them, so the baseline is the true best uniform tree."""
    scheds = tuning.all_schedules(prune="hierarchy")
    scheds += [s for r in barrier.all_radices()
               if (s := barrier.kary_tree(r)) not in scheds]
    return scheds


def workload_tuned_kernels(device="cuda") -> list:
    """Per kernel: its winner's mean span, its best uniform radix's (0.1
    cycle) and the gain (4 digits)."""
    scheds = schedules()
    res, steady_us, first_us = measure(
        lambda: tuning.sweep_workloads(prng.PRNGKey(KEY, device=device),
                                       n_trials=N_TRIALS,
                                       schedules=scheds), device)
    rows = [("workload_sweep_grid", steady_us,
             f"{len(res.schedules)}x{len(res.kernels)}x{N_TRIALS}",
             first_us)]
    for p in tuning.best_per_kernel(res):
        rows += [(f"workload_{p.kernel}_best_{p.schedule.name}", 0.0,
                  round(p.mean_span, 1), 0.0),
                 (f"workload_{p.kernel}_uniform_{p.uniform_schedule.name}",
                  0.0, round(p.uniform_span, 1), 0.0),
                 (f"workload_{p.kernel}_gain", 0.0,
                  round(p.uniform_span / max(p.mean_span, 1e-9), 4), 0.0)]
    return rows


def workload_5g(device="cuda") -> list:
    """The paper's 5G design point (64 antennas, 4 FFTs a round): speedup
    over central (3 digits) and sync fraction (4 digits) of the partial,
    placed and workload modes, and the placed and workload modes'
    trees."""
    res, steady_us, first_us = measure(
        lambda: fiveg.compare_barriers(prng.PRNGKey(KEY, device=device),
                                       fiveg.FiveGConfig(), radix=32,
                                       modes=FIVEG_MODES, device=device),
        device)
    rows = [("workload_5g_compare", steady_us, "4modes", first_us)]
    for mode in FIVEG_MODES[1:]:
        rows += [(f"workload_5g_speedup_{mode}", 0.0,
                  round(float(res[f"speedup_{mode}"]), 3), 0.0),
                 (f"workload_5g_syncfrac_{mode}", 0.0,
                  round(float(res[mode].sync_fraction), 4), 0.0)]
    for mode in ("placed", "workload"):
        rows += [(f"workload_5g_{mode}_stage_sched", 0.0,
                  res[mode].stage_schedule, 0.0),
                 (f"workload_5g_{mode}_global_sched", 0.0,
                  res[mode].global_schedule, 0.0)]
    return rows


def run(device="cuda") -> list:
    return workload_tuned_kernels(device) + workload_5g(device)


def main(argv=None) -> list:
    return figure_main("fig_workload_tuned", __doc__, run, argv)


if __name__ == "__main__":
    main()
