"""Fig. 6a/6b/6c on an NVIDIA GPU: per kernel and input, the best radix
of the arrival tree, the barrier's share of the runtime under it, and
the speedup of the best radix over the worst; the port's counterpart of
``benchmarks/fig6_kernel_colormap.py``, with its key, radices and row
names.  The whole kernel x input x radix grid is one
``sweep.sweep_arrivals`` call.

    PYTHONPATH=src python -m repro_torch.examples.fig6 [--device cpu]

Prints ``name,us_per_call,derived,first_us`` rows and writes
``build/BENCH_torch_fig6.json`` (``--out``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import barrier, prng, sweep, workloads
from repro_torch.examples.figure_rows import main as figure_main
from repro_torch.examples.figure_rows import measure

KEY = 2
RADICES = (2, 8, 16, 32, 64, 256, 1024)


def grid(device="cuda") -> dict:
    """The radix x kernel grid on one draw per kernel/input: ``{"labels",
    "res", "steady_us", "first_us"}``."""
    key = prng.PRNGKey(KEY, device=device)
    suite = workloads.benchmark_suite()
    labels = [(kernel, label) for kernel, dims in suite.items()
              for label in dims]
    arrivals = torch.stack([suite[k][l](key) for k, l in labels])[:, None]
    scheds = [barrier.kary_tree(r) for r in RADICES]
    res, steady_us, first_us = measure(
        lambda: sweep.sweep_arrivals(
            arrivals, scheds, kernels=[f"{k}_{l}" for k, l in labels]),
        device)
    return {"labels": labels, "res": res, "steady_us": steady_us,
            "first_us": first_us}


def rows(g: dict) -> list:
    """The reference benchmark's rows: the grid's timing, then per
    kernel/input the best radix, its barrier fraction (4 digits) and
    the best-over-worst speedup (3 digits)."""
    labels, res = g["labels"], g["res"]
    out = [("fig6_sweep_grid", g["steady_us"],
            f"{len(RADICES)}x{len(labels)}x1", g["first_us"])]
    totals = res.exit_time[:, :, 0].cpu().numpy()          # (R, K)
    fracs = res.mean_residency[:, :, 0].cpu().numpy() / totals
    for j, (kernel, label) in enumerate(labels):
        best_i = int(np.argmin(totals[:, j]))
        speedup = float(np.max(totals[:, j]) / totals[best_i, j])
        out.append((f"fig6a_{kernel}_{label}_bestradix", 0.0,
                    RADICES[best_i], 0.0))
        out.append((f"fig6b_{kernel}_{label}_frac", 0.0,
                    round(float(fracs[best_i, j]), 4), 0.0))
        out.append((f"fig6c_{kernel}_{label}_speedup", 0.0,
                    round(speedup, 3), 0.0))
    return out


def run(device="cuda") -> list:
    return rows(grid(device))


def main(argv=None) -> list:
    return figure_main("fig6", __doc__, run, argv)


if __name__ == "__main__":
    main()
