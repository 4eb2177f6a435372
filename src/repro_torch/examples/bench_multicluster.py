"""Hierarchical barriers on multi-cluster machines of 2048-16384 PEs, on
an NVIDIA GPU: the simulated columns of ``benchmarks/bench_multicluster.
py`` with the same defaults, computed by the port.

Each machine is 4 TeraPool clusters of ``N / 4`` PEs
(``topology.multi_cluster``; a counter whose span or bank crosses a
cluster pays ``lat_remote``).  Per machine:

* **Sweep**: the joint intra-cluster x inter-cluster schedule space
  (``tuning.multicluster_schedules``; above ``MAX_STACK`` compositions,
  the radix-2/4/8/16 and hierarchy-segment intra shapes only) plus the
  cluster-oblivious baselines (the central counter, radices 4/8/16 over
  the whole machine), x delays 0 and 512 x 4 trials in one
  ``sweep.sweep_schedules`` call; its wall time per grid point.
* **Hierarchical against flat**: mean span at delay 0 of the best
  hierarchical tree, the central counter and the best flat radix.
* **Widths**: the telescope core over the hierarchy-segment stack with
  its cumulative-quotient widths against the ``N >> i`` fallback: the
  widths' sums, and each one's wall time.

The reference's ``sharding`` section (2-D against schedule-only device
meshes) is left out: the port runs on one card.  Prints one JSON line
per machine; ``--out PATH`` writes the record (default
``build/BENCH_torch_multicluster.json``; the reference's file is never
written).

    PYTHONPATH=src python -m repro_torch.examples.bench_multicluster \\
        [--device cpu] [--ns 2048,4096,16384]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.core import barrier, barrier_sim, prng, sweep, tuning
from repro_torch.core.topology import TeraPoolConfig, multi_cluster
from repro_torch.timing import wall_us

KEY = 0
NS = (2048, 4096, 16384)
N_CLUSTERS = 4
DELAYS = (0.0, 512.0)
N_TRIALS = 4
# Above this many joint compositions the intra-cluster shapes are cut to
# the uniform radices and the hierarchy-segment tree.
MAX_STACK = 192
SHARDING = "left out: one device (the reference compares device meshes)"
OUT = Path("build") / "BENCH_torch_multicluster.json"


def machine(n_total: int):
    """4 clusters of ``n_total / 4`` PEs."""
    return multi_cluster(TeraPoolConfig(n_pes=n_total // N_CLUSTERS),
                         n_clusters=N_CLUSTERS)


def hier_schedules(cfg) -> list:
    """The joint hierarchical space, cut down past ``MAX_STACK``."""
    comps = tuning.multicluster_compositions(cfg)
    if len(comps) > MAX_STACK:
        ppc = cfg.pes_per_cluster
        intra = [tuple(barrier.kary_tree(r, n_pes=ppc, cfg=cfg).sizes)
                 for r in (2, 4, 8, 16) if ppc % r == 0]
        intra.append(tuple(tuning._hier_segments(ppc, cfg)))
        comps = tuning.multicluster_compositions(
            cfg, intra=sorted(set(intra)))
    return [barrier.mixed_radix_tree(c, cfg=cfg) for c in comps]


def flat_schedules(cfg) -> list:
    """The central counter and radices 4, 8, 16 over the whole machine."""
    flats = [barrier.mixed_radix_tree((cfg.n_pes,), cfg=cfg)]
    flats += [barrier.kary_tree(r, n_pes=cfg.n_pes, cfg=cfg)
              for r in (4, 8, 16) if cfg.n_pes % r == 0]
    return flats


def segment_tables(cfg, device):
    """The hierarchy-segment intra tree under every inter-cluster tree,
    as one stacked table: the stack the widths are measured on."""
    seg = [tuple(tuning._hier_segments(cfg.pes_per_cluster, cfg))]
    comps = tuning.multicluster_compositions(cfg, intra=seg)
    return barrier.stack_tables(
        [barrier.mixed_radix_tree(c, cfg=cfg) for c in comps], cfg,
        device=device)


def bench_machine(n_total: int, device="cuda") -> dict:
    """One machine's record, its timings fresh (``*_us``)."""
    cfg = machine(n_total)
    hier = hier_schedules(cfg)
    stack = hier + flat_schedules(cfg)
    res, steady_us, first_us = wall_us(lambda: sweep.sweep_schedules(
        prng.PRNGKey(KEY, device=device), stack, delays=DELAYS,
        n_trials=N_TRIALS, cfg=cfg, device=device), device, iters=2)
    points = len(stack) * len(DELAYS) * N_TRIALS
    # Delay 0: every PE arrives at once, the contention-bound regime in
    # which the central counter serializes N atomics on one remote bank.
    spans = res.mean_span[:, 0].tolist()
    hier_best = min(spans[:len(hier)])
    central = spans[len(hier)]
    uniform_best = min(spans[len(hier):])

    tables = segment_tables(cfg, device)
    one = prng.uniform(prng.PRNGKey(KEY, device=device), (cfg.n_pes,),
                       0.0, 512.0)
    tight = barrier.telescope_widths(tables, cfg.n_pes)
    loose = barrier.default_widths(cfg.n_pes, len(tight) - 1)
    telescope = barrier_sim.core_fn("telescope")
    per_width = {}
    for label, w in (("tight", tight), ("fallback", loose)):
        # The stacked tables' leading axis broadcasts against the one
        # arrival vector: an (S,) result per column.
        _, t_us, f_us = wall_us(
            lambda w=w: telescope(one, tables, cfg, w), device, iters=2)
        per_width[label] = {"steady_us": t_us, "first_us": f_us}
    return {
        "n_pes": n_total, "n_clusters": N_CLUSTERS,
        "n_schedules": len(stack),
        "sweep": {"points": points, "steady_us": steady_us,
                  "first_us": first_us,
                  "us_per_point": steady_us / points},
        "hier_vs_flat": {
            "hier_best_span": round(hier_best, 1),
            "central_span": round(central, 1),
            "uniform_best_span": round(uniform_best, 1),
            "speedup_vs_central": round(central / hier_best, 2),
            "speedup_vs_uniform": round(uniform_best / hier_best, 2)},
        "sharding": SHARDING,
        "widths": {"sum_tight": int(sum(tight)),
                   "sum_fallback": int(sum(loose)),
                   "speedup": (per_width["fallback"]["steady_us"]
                               / per_width["tight"]["steady_us"]),
                   **per_width},
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ns", default=",".join(map(str, NS)),
                    help="comma-separated total PE counts")
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args(argv)
    record = {}
    for n in (int(x) for x in args.ns.split(",")):
        record[f"N={n}"] = bench_machine(n, args.device)
        print(json.dumps({f"N={n}": record[f"N={n}"]}), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(record, indent=2) + "\n")


if __name__ == "__main__":
    main()
