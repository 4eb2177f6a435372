"""Fig. 5 on an NVIDIA GPU: the spread of per-PE arrival times of every
benchmark kernel and input (the gap between the fastest and the slowest
PE, and the median arrival past the first); the port's counterpart of
``benchmarks/fig5_kernel_cdf.py``, with its key and row names.

    PYTHONPATH=src python -m repro_torch.examples.fig5 [--device cpu]

Prints ``name,us_per_call,derived,first_us`` rows and writes
``build/BENCH_torch_fig5.json`` (``--out``); each kernel's draw is timed
on its first call and in steady state.
"""
from __future__ import annotations

import torch

from repro_torch.core import prng, workloads
from repro_torch.examples.figure_rows import main as figure_main
from repro_torch.examples.figure_rows import measure

KEY = 1


def suite(device="cuda") -> list:
    """One draw of every kernel/input of the Fig. 5/6 suite: ``{"name",
    "arrivals", "gap", "p50", "steady_us", "first_us"}`` each."""
    key = prng.PRNGKey(KEY, device=device)
    out = []
    for kernel, dims in workloads.benchmark_suite().items():
        for label, fn in dims.items():
            arr, steady_us, first_us = measure(lambda: fn(key), device)
            out.append({
                "name": f"{kernel}_{label}", "arrivals": arr,
                "gap": workloads.cdf_first_last_gap(arr).item(),
                "p50": torch.quantile(arr - arr.min(), 0.5).item(),
                "steady_us": steady_us, "first_us": first_us})
    return out


def rows(points: list) -> list:
    """The reference benchmark's rows: gap and median per kernel/input,
    to 0.1 cycle."""
    out = []
    for p in points:
        for stat in ("gap", "p50"):
            out.append((f"fig5_{p['name']}_{stat}", p["steady_us"],
                        round(p[stat], 1), p["first_us"]))
    return out


def run(device="cuda") -> list:
    return rows(suite(device))


def main(argv=None) -> list:
    return figure_main("fig5", __doc__, run, argv)


if __name__ == "__main__":
    main()
