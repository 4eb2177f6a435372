"""Fig. 7 on an NVIDIA GPU: the 5G OFDM + beamforming application under
central, tree and partial barriers (cycles, speedup over the central
counter, the partial barrier's sync fraction and its speedup over the
serial run) at 16, 32 and 64 antennas and 1 or 4 FFTs a round, then the
trees each tuned sync mode picks at (16, 1); the port's counterpart of
``benchmarks/fig7_5g_app.py`` (with ``tuned_schedule_rows``), with its
key, grid and row names.

    PYTHONPATH=src python -m repro_torch.examples.fig7 [--device cpu]

Prints ``name,us_per_call,derived,first_us`` rows and writes
``build/BENCH_torch_fig7.json`` (``--out``).  Each grid point's
``compare_barriers`` is timed on its first call and once more.
"""
from __future__ import annotations

from repro_torch.core import fiveg, prng
from repro_torch.examples.figure_rows import main as figure_main
from repro_torch.examples.figure_rows import measure

KEY = 3
RADIX = 32
# (antennas, FFTs a round): every (n_rx, fpr) of 16/32/64 x 1/4 with
# fpr dividing the FFTs of one 256-PE subset.
GRID = tuple((n_rx, fpr) for n_rx in (16, 32, 64) for fpr in (1, 4)
             if (n_rx // 4) % fpr == 0)
MODES = ("central", "tree", "partial")
TUNED_APP = (16, 1)
TUNED_MODES = ("tuned", "tuned_partial", "placed", "workload")


def grid(device="cuda", modes=MODES) -> list:
    """``compare_barriers`` over :data:`GRID`: ``{"n_rx",
    "ffts_per_round", "res", "steady_us", "first_us"}`` per point."""
    key = prng.PRNGKey(KEY, device=device)
    out = []
    for n_rx, fpr in GRID:
        app = fiveg.FiveGConfig(n_rx=n_rx, ffts_per_round=fpr)
        res, steady_us, first_us = measure(
            lambda: fiveg.compare_barriers(key, app, radix=RADIX,
                                           modes=modes, device=device),
            device)
        out.append({"n_rx": n_rx, "ffts_per_round": fpr, "res": res,
                    "steady_us": steady_us, "first_us": first_us})
    return out


def grid_rows(points: list) -> list:
    """The reference benchmark's five rows per grid point."""
    out = []
    for p in points:
        res, us, first = p["res"], p["steady_us"], p["first_us"]
        tag = f"fig7_nrx{p['n_rx']}_fpr{p['ffts_per_round']}"
        partial = res["partial"]
        out += [
            (f"{tag}_cycles_central", us,
             round(float(res["central"].total_cycles)), first),
            (f"{tag}_cycles_partial32", us,
             round(float(partial.total_cycles)), first),
            (f"{tag}_speedup_partial", us,
             round(float(res["speedup_partial"]), 3), first),
            (f"{tag}_syncfrac_partial", us,
             round(float(partial.sync_fraction), 4), first),
            (f"{tag}_speedup_serial", us,
             round(float(partial.speedup_serial), 1), first)]
    return out


def tuned_modes(device="cuda", app=TUNED_APP, modes=TUNED_MODES) -> dict:
    """``simulate_app`` at ``app`` (antennas, FFTs a round) under each
    tuned mode: ``{mode: result}``."""
    key = prng.PRNGKey(KEY, device=device)
    n_rx, fpr = app
    cfg = fiveg.FiveGConfig(n_rx=n_rx, ffts_per_round=fpr)
    return {mode: fiveg.simulate_app(key, cfg, sync=mode, device=device)
            for mode in modes}


def tuned_schedule_rows(results: dict) -> list:
    """The winning stage and global trees of each tuned mode (the
    reference's ``tuned_schedule_rows``)."""
    out = []
    for mode in TUNED_MODES:
        out.append((f"fig7_{mode}_stage_sched", 0.0,
                    results[mode].stage_schedule, 0.0))
        out.append((f"fig7_{mode}_global_sched", 0.0,
                    results[mode].global_schedule, 0.0))
    return out


def run(device="cuda") -> list:
    return grid_rows(grid(device)) + tuned_schedule_rows(tuned_modes(device))


def main(argv=None) -> list:
    return figure_main("fig7", __doc__, run, argv)


if __name__ == "__main__":
    main()
