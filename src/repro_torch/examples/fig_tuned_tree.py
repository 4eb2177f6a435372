"""Tuned mixed-radix trees against the best uniform radix on an NVIDIA
GPU (beyond the paper's figures): every composition of the 1024-PE
cluster x 4 delays x 4 trials in one ``tuning.tune_barrier`` call, the
winner per delay against the best uniform radix, the latency Pareto
front, then the 5G application under the tuned sync modes; the port's
counterpart of ``benchmarks/fig_tuned_tree.py`` (``tuned_vs_uniform``,
``tuned_5g``), with its key, sizes and row names.

    PYTHONPATH=src python -m repro_torch.examples.fig_tuned_tree [--device cpu]

Prints ``name,us_per_call,derived,first_us`` rows and writes
``build/BENCH_torch_fig_tuned_tree.json`` (``--out``).
"""
from __future__ import annotations

from repro_torch.core import fiveg, prng, tuning
from repro_torch.examples.figure_rows import main as figure_main
from repro_torch.examples.figure_rows import measure

KEY = 0
DELAYS = (0.0, 128.0, 512.0, 2048.0)
N_TRIALS = 4
FIVEG_MODES = ("central", "partial", "tuned", "tuned_partial")


def tuned_vs_uniform(device="cuda") -> list:
    """The composition x delay x trial sweep, the winner per delay
    against the best uniform radix (mean span to 0.1 cycle, the gain to
    4 digits) and the Pareto front."""
    res, steady_us, first_us = measure(
        lambda: tuning.tune_barrier(prng.PRNGKey(KEY, device=device),
                                    delays=DELAYS, n_trials=N_TRIALS),
        device)
    rows = [("tuned_sweep_grid", steady_us,
             f"{len(res.schedules)}x{len(DELAYS)}x{N_TRIALS}", first_us)]
    for p in tuning.best_per_delay(res):
        d = int(p.delay)
        rows += [(f"tuned_delay{d}_best_{p.schedule.name}", 0.0,
                  round(p.mean_span, 1), 0.0),
                 (f"tuned_delay{d}_uniform_{p.uniform_schedule.name}", 0.0,
                  round(p.uniform_span, 1), 0.0),
                 (f"tuned_delay{d}_gain", 0.0,
                  round(p.uniform_span / p.mean_span, 4), 0.0)]
    rows.append(("tuned_pareto_front", 0.0,
                 "|".join(s.name for s in tuning.pareto_schedules(res)),
                 0.0))
    return rows


def tuned_5g(device="cuda") -> list:
    """The 5G app at (16, 1) under the paper's partial barrier and the
    two tuned modes: speedup over central (3 digits) and sync fraction
    (4 digits)."""
    app = fiveg.FiveGConfig(n_rx=16, ffts_per_round=1)
    res, steady_us, first_us = measure(
        lambda: fiveg.compare_barriers(prng.PRNGKey(KEY, device=device),
                                       app, radix=32, modes=FIVEG_MODES,
                                       device=device), device)
    rows = [("tuned_5g_compare", steady_us, "4modes", first_us)]
    for mode in FIVEG_MODES[1:]:
        rows += [(f"tuned_5g_speedup_{mode}", 0.0,
                  round(float(res[f"speedup_{mode}"]), 3), 0.0),
                 (f"tuned_5g_syncfrac_{mode}", 0.0,
                  round(float(res[mode].sync_fraction), 4), 0.0)]
    return rows


def run(device="cuda") -> list:
    return tuned_vs_uniform(device) + tuned_5g(device)


def main(argv=None) -> list:
    return figure_main("fig_tuned_tree", __doc__, run, argv)


if __name__ == "__main__":
    main()
