"""Counter placement as a tuned design axis on an NVIDIA GPU (beyond
the paper's figures): the hierarchy-pruned compositions of the 1024-PE
cluster crossed with every placement strategy, x 4 delays x 4 trials in
one ``tuning.tune_barrier`` call, and per strategy the best span, its
tree, its bank-sharing counters and its penalty against leaf-local
counters; then the 5G application under ``sync="placed"``; then the
banking-factor sweep (2, 4, 8) of the placed tuner and of a fixed
32-bank-stride heap allocator.  The port's counterpart of
``benchmarks/fig_placement.py`` (``placement_tradeoff``, ``placed_5g``,
``banking_sensitivity``), with its key, sizes and row names.

    PYTHONPATH=src python -m repro_torch.examples.fig_placement [--device cpu]

Prints ``name,us_per_call,derived,first_us`` rows and writes
``build/BENCH_torch_fig_placement.json`` (``--out``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import (barrier, barrier_sim, fiveg, placement, prng,
                              topology, tuning)
from repro_torch.examples.figure_rows import main as figure_main
from repro_torch.examples.figure_rows import measure

KEY = 0
DELAYS = (0.0, 128.0, 512.0, 2048.0)
N_TRIALS = 4
BANKING_FACTORS = (2, 4, 8)
HEAP_SIZES = (8, 16, 8)         # the heap allocator's tree
FIVEG_MODES = ("central", "partial", "tuned", "placed")


def _by_strategy(res) -> dict:
    return {s: [i for i, p in enumerate(res.placements) if p.strategy == s]
            for s in placement.STRATEGIES}


def placement_tradeoff(device="cuda") -> list:
    """Per delay and strategy: the best mean span (0.1 cycle), its tree,
    its counters sharing a bank and its penalty over leaf-local (3
    digits)."""
    res, steady_us, first_us = measure(
        lambda: tuning.tune_barrier(prng.PRNGKey(KEY, device=device),
                                    delays=DELAYS, n_trials=N_TRIALS,
                                    prune="hierarchy",
                                    placements=placement.STRATEGIES),
        device)
    rows = [("placement_sweep_grid", steady_us,
             f"{len(res.schedules)}x{len(DELAYS)}x{N_TRIALS}", first_us)]
    spans = res.mean_span.cpu().numpy()                  # (S, D)
    by_strategy = _by_strategy(res)
    for j, delay in enumerate(res.delays.tolist()):
        d = int(delay)
        base = None
        for strat in placement.STRATEGIES:
            col = spans[by_strategy[strat], j]
            k = int(np.argmin(col))
            i = by_strategy[strat][k]
            best = float(col[k])
            if strat == "leaf_local":
                base = best
            rows += [(f"placement_delay{d}_{strat}", 0.0, round(best, 1),
                      0.0),
                     (f"placement_delay{d}_{strat}_sched", 0.0,
                      res.schedules[i].name, 0.0),
                     (f"placement_delay{d}_{strat}_shared", 0.0,
                      sum(res.placements[i].shared_bank_counters()), 0.0)]
            if strat != "leaf_local":
                rows.append((f"placement_delay{d}_{strat}_penalty", 0.0,
                             round(best / base, 3), 0.0))
    return rows


def placed_5g(device="cuda") -> list:
    """The 5G app at (16, 1): speedup over central (3 digits) and sync
    fraction (4 digits) of the partial, tuned and placed modes."""
    app = fiveg.FiveGConfig(n_rx=16, ffts_per_round=1)
    res, steady_us, first_us = measure(
        lambda: fiveg.compare_barriers(prng.PRNGKey(KEY, device=device),
                                       app, radix=32, modes=FIVEG_MODES,
                                       device=device), device)
    rows = [("placement_5g_compare", steady_us, "4modes", first_us)]
    for mode in FIVEG_MODES[1:]:
        rows += [(f"placement_5g_speedup_{mode}", 0.0,
                  round(float(res[f"speedup_{mode}"]), 3), 0.0),
                 (f"placement_5g_syncfrac_{mode}", 0.0,
                  round(float(res[mode].sync_fraction), 4), 0.0)]
    return rows


def banking_sensitivity(device="cuda") -> list:
    """Under banking factors 2, 4 and 8: each strategy's best span of
    the placed tuner (delays 0 and 512, 2 trials) and the span of a
    fixed 32-bank-stride heap allocator on the 8x16x8 tree, with its
    counters sharing a bank."""
    key = prng.PRNGKey(KEY, device=device)
    arrs = {0: torch.zeros((4, 1024), device=device),
            512: 512.0 * prng.uniform(key, (4, 1024))}
    rows = []
    for bf in BANKING_FACTORS:
        cfg = dataclasses.replace(topology.DEFAULT, banking_factor=bf)
        res, steady_us, first_us = measure(
            lambda: tuning.tune_barrier(key, delays=(0.0, 512.0),
                                        n_trials=2, prune="hierarchy",
                                        placements=placement.STRATEGIES,
                                        cfg=cfg), device)
        rows.append((f"banking_bf{bf}_sweep", steady_us,
                     f"{len(res.schedules)}x2x2", first_us))
        spans = res.mean_span.cpu().numpy()              # (S, D)
        by_strategy = _by_strategy(res)
        for j, delay in enumerate(res.delays.tolist()):
            for strat in placement.STRATEGIES:
                best = float(spans[by_strategy[strat], j].min())
                rows.append((f"banking_bf{bf}_delay{int(delay)}_{strat}",
                             0.0, round(best, 1), 0.0))
        s = barrier.mixed_radix_tree(HEAP_SIZES, cfg=cfg)
        pl = placement.explicit_placement(s, bank_offsets=[0] * 3,
                                          bank_strides=[32] * 3, cfg=cfg)
        for d, arr in arrs.items():
            span = barrier_sim.simulate(arr, s, cfg, placement=pl,
                                        device=device).span_cycles
            rows.append((f"banking_bf{bf}_delay{d}_heap_stride32", 0.0,
                         round(span.mean().item(), 1), 0.0))
        rows.append((f"banking_bf{bf}_heap_shared", 0.0,
                     sum(pl.shared_bank_counters()), 0.0))
    return rows


def run(device="cuda") -> list:
    return (placement_tradeoff(device) + placed_5g(device)
            + banking_sensitivity(device))


def main(argv=None) -> list:
    return figure_main("fig_placement", __doc__, run, argv)


if __name__ == "__main__":
    main()
