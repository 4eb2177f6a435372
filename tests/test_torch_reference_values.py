"""Reference values of the port's main path, as data.

``src/repro_torch/reference_values.json`` holds what the JAX package
computes, on the CPU, for:

* ``fig7``: the Fig. 7 grid of ``benchmarks/fig7_5g_app.py`` (key 3,
  radix 32, modes central/tree/partial/hw);
* ``fig4a``: the first 16 trials of the Fig. 4a sweep at N = 1024
  (key 0);
* ``fig5``: the first-to-last gap and the median of every Fig. 5
  kernel's arrivals (``benchmarks/fig5_kernel_cdf.py``, key 1);
* ``fig6``: the 7-radix x 15-kernel grid of
  ``benchmarks/fig6_kernel_colormap.py`` (key 2);
* ``tuner``: ``sweep_workloads`` over all 512 compositions x 15 kernels
  x 4 trials at N = 1024 (key 0), the per-delay tuner's picks on the
  same schedules, and one placed ``tune_barrier`` (hierarchy-pruned
  compositions x every placement strategy);
* ``fig7_tuned``: the five tuner modes of the 5G app at (16, 1) and
  (64, 4) (key 3);
* ``normal_sample``: ``jax.random.normal`` draws (key 0);
* ``faults``: the degradation sweep of ``benchmarks/bench_faults.py`` at
  N = 1024 (130 schedules x 5 PE failure rates x 64 trials, watchdog
  2000 cycles, quorum 0.95, key 0): per-rate winners, p99 and mean
  spans, completion rates, abandoned means, the spans of the first four
  trials, and the record as the benchmark rounds it;
* ``fiveg_faults``: the benchmark's 5G ``degradation_curve`` (central,
  tree, hw x 5 rates at (16, 1), key 0);
* ``straggler_pareto``: ``arrival_batch("straggler_pareto")`` at
  (8, 1024) (key 7), whose tail goes through the C library's ``powf``;
* ``fig4b``: the Fig. 4b rows of ``benchmarks/fig4_random_delay.py``
  (the best radix per delay of the 16-trial Fig. 4a sweep and its mean
  residency, key 0) and claim C3's residencies on the draws of
  ``tests/test_barrier_sim.py`` (radices 16/32/64/1024, 8 trials, delays
  256 and 2048);
* ``multicluster``: exit times and spans of two hierarchical schedule
  stacks on each 4-cluster machine of 2048 and 4096 PEs (see
  :func:`mc_stacks`) under 4 trials of uniform arrivals over 512 cycles
  (key 0), with the stacks' telescope widths;
* ``prng_original``: ``split``, ``uniform``, ``normal`` and
  ``bernoulli`` draws with ``jax_threefry_partitionable`` off (key 0);
* ``fig_placement``, ``fig_tuned_tree``, ``fig_workload_tuned``: the rows
  (name and derived value) of the beyond-figure benchmarks
  ``benchmarks/fig_placement.py``, ``fig_tuned_tree.py`` and
  ``fig_workload_tuned.py``; the ``fig5``, ``fig6`` and ``fig7`` sections
  also hold the rows of ``fig5_kernel_cdf.py``, ``fig6_kernel_colormap.py``
  and ``fig7_5g_app.py`` (``bench_rows``), which the port's drivers
  (``repro_torch.examples.fig5`` ... ``fig_workload_tuned``) reproduce
  (``tests/test_torch_figure_drivers.py``);
* ``lm_serve``: the qwen3 smoke config served as ``examples/serve_lm.py``
  serves it (tests/lm_parity.py): 2 numpy-seeded prompts, prefill over
  64 tokens, 4 greedy decode steps.  Two variants: bf16 through the serve
  steps as built (bf16 KV cache), and float32 end to end (float32 KV
  cache).  Each holds the digests of ``init_params(PRNGKey(0))``'s
  leaves, the prefill's last logits, each decode step's logits and the
  greedy tokens.

``chip_smoke.py`` holds the port's GPU run against it without importing
JAX.  Regenerate it with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_reference_values.py

or some sections of it with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_reference_values.py lm_serve
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_reference_values.py fig4b multicluster prng_original
    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tests/test_torch_reference_values.py fig5 fig6 fig7 fig_placement fig_tuned_tree fig_workload_tuned

The tests below recompute the cheap sections with JAX, so the file
cannot go stale, and hold the port's CPU run to the sections small
enough for the CPU.  The long recomputes are in files of their own, so
that pytest-xdist's ``--dist loadfile`` spreads them over its workers:
every row of ``benchmarks/fig7_5g_app.py``
(``test_torch_reference_fig7_rows.py``) and of the beyond-figure
benchmarks (``test_torch_reference_figures.py``), and the 5G degradation
curve on both threefry streams (``test_torch_reference_fiveg_faults.py``,
``test_torch_reference_fiveg_original.py``); they import this file's
helpers.
"""
import hashlib
import importlib
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import barrier as jbarrier
from repro.core import fiveg as jfiveg
from repro.core import placement as jplacement
from repro.core import sweep as jsweep
from repro.core import tuning as jtuning
from repro.core import workloads as jworkloads
from repro.core import barrier_sim as jbarrier_sim
from repro.core.topology import TeraPoolConfig as JConfig
from repro.core.topology import multi_cluster as jmulti_cluster
from repro.models import init_params as jinit_params
from repro_torch.core import barrier, fiveg, prng, sweep, workloads
from repro_torch.examples import bench_faults, fig4
from repro_torch.models import init_params, layers, param_defs

from lm_parity import jax_serve, port_serve, prompts, top2_margin, variant
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

PATH = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "reference_values.json")
FIG7_KEY = 3
FIG7_RADIX = 32
FIG7_MODES = ("central", "tree", "partial", "hw")
FIG7_GRID = ((16, 1), (16, 4), (32, 1), (32, 4), (64, 1), (64, 4))
FIG7_COLUMNS = ("total_cycles", "sync_fraction", "sync_energy")
FIG4_KEY = 0
FIG4_N = 1024
FIG4_TRIALS = 16
FIG4_DELAYS = (0.0, 128.0, 512.0, 2048.0)
FIG5_KEY = 1
FIG6_KEY = 2
FIG6_RADICES = (2, 8, 16, 32, 64, 256, 1024)
TUNER_KEY = 0
TUNER_TRIALS = 4
TUNER_DELAYS = (0.0, 128.0, 512.0, 2048.0)
TUNED_MODES = ("tuned", "tuned_partial", "placed", "workload", "pareto")
TUNED_GRID = ((16, 1), (64, 4))
NORMAL_KEY = 0
NORMAL_COUNT = 4096
FAULTS = bench_faults       # key, sizes and release policy of the run
STRAGGLER_KEY = 7
STRAGGLER_SHAPE = (8, 1024)
SPAN_PREFIX = 4             # trials whose spans are stored
FIG4 = fig4                 # key, delays, SFRs and C3 draws of Fig. 4b
MC_KEY = 0
MC_NS = (2048, 4096)
MC_TRIALS = 4
MC_DELAY = 512.0
MC_PICKS = 8                # joint compositions kept per machine
PRNG_ORIGINAL_KEY = 0
PRNG_ORIGINAL_SHAPES = ((7,), (16, 33))
# The beyond-figure benchmarks whose rows the file holds, each with the
# port's driver of the same name.
FIGURES = ("fig_placement", "fig_tuned_tree", "fig_workload_tuned")
LM_ARCH = "qwen3_4b"
LM_BATCH, LM_PROMPT_LEN, LM_STEPS, LM_SEED = 2, 59, 4, 0
# The serve-path tolerances of tests/test_torch_lm_serve.py.
LM_F32_ATOL, LM_BF16_ATOL = 1e-4, 0.0625


def _floats(x) -> list:
    """float32 values as Python floats (exact)."""
    return np.asarray(x, np.float32).tolist()


def _fig7_row(n_rx: int, fpr: int) -> dict:
    """One grid point of the JAX Fig. 7 comparison, as plain floats
    (float32 values convert to Python floats exactly)."""
    res = jfiveg.compare_barriers(
        jax.random.PRNGKey(FIG7_KEY),
        jfiveg.FiveGConfig(n_rx=n_rx, ffts_per_round=fpr),
        radix=FIG7_RADIX, modes=FIG7_MODES)
    return {"n_rx": n_rx, "ffts_per_round": fpr,
            **{mode: {c: float(np.asarray(getattr(res[mode], c)))
                      for c in FIG7_COLUMNS} for mode in FIG7_MODES}}


def _bench_rows(name: str) -> list:
    """``[name, derived]`` of every row of ``benchmarks/<name>.py``'s
    ``run()`` (the repo root on the path: ``benchmarks`` is a namespace
    package)."""
    module = importlib.import_module(f"benchmarks.{name}")
    return [[row[0], row[2]] for row in module.run()]


def _figure(name: str) -> dict:
    return {"benchmark": f"benchmarks/{name}.py", "rows": _bench_rows(name)}


def _fig7() -> dict:
    return {"key": FIG7_KEY, "radix": FIG7_RADIX, "modes": list(FIG7_MODES),
            "rows": [_fig7_row(*p) for p in FIG7_GRID],
            "bench_rows": _bench_rows("fig7_5g_app")}


def _fig5() -> dict:
    """Gap and median of one draw of every Fig. 5 kernel, as
    ``benchmarks/fig5_kernel_cdf.py`` computes them."""
    key = jax.random.PRNGKey(FIG5_KEY)
    out = {}
    for kernel, dims in jworkloads.benchmark_suite().items():
        for label, fn in dims.items():
            arr = fn(key)
            out[f"{kernel}_{label}"] = {
                "gap": float(jworkloads.cdf_first_last_gap(arr)),
                "p50": float(np.percentile(np.asarray(arr - arr.min()),
                                           50))}
    return {"key": FIG5_KEY, "kernels": out,
            "bench_rows": _bench_rows("fig5_kernel_cdf")}


def _fig6() -> dict:
    """The Fig. 6 grid of ``benchmarks/fig6_kernel_colormap.py``."""
    suite = jworkloads.benchmark_suite()
    key = jax.random.PRNGKey(FIG6_KEY)
    names = [f"{k}_{l}" for k, dims in suite.items() for l in dims]
    arrivals = np.stack([np.asarray(fn(key)) for dims in suite.values()
                         for fn in dims.values()])[:, None, :]
    res = jsweep.sweep_arrivals(
        arrivals, [jbarrier.kary_tree(r) for r in FIG6_RADICES],
        kernels=names)
    totals = np.asarray(res.exit_time)[:, :, 0]          # (R, K)
    fracs = np.asarray(res.mean_residency)[:, :, 0] / totals
    best = np.argmin(totals, axis=0)
    return {"key": FIG6_KEY, "radices": list(FIG6_RADICES),
            "kernels": names, "exit_time": _floats(totals),
            "mean_residency": _floats(np.asarray(res.mean_residency)[:, :, 0]),
            "best_radix": [FIG6_RADICES[i] for i in best],
            "fraction": [float(fracs[i, j]) for j, i in enumerate(best)],
            "speedup": [float(totals[:, j].max() / totals[i, j])
                        for j, i in enumerate(best)],
            "bench_rows": _bench_rows("fig6_kernel_colormap")}


def _tuner() -> dict:
    """The workload tuner over the full composition space at N = 1024,
    the per-delay tuner on the same schedules, and one placed
    ``tune_barrier``."""
    key = jax.random.PRNGKey(TUNER_KEY)
    schedules = jtuning.all_schedules(FIG4_N)
    wres = jtuning.sweep_workloads(key, n_pes=FIG4_N, n_trials=TUNER_TRIALS,
                                   schedules=schedules)
    dres = jtuning.tune_barrier(key, FIG4_N, delays=TUNER_DELAYS,
                                n_trials=TUNER_TRIALS, schedules=schedules)
    pres = jtuning.tune_barrier(key, FIG4_N, delays=TUNER_DELAYS,
                                n_trials=TUNER_TRIALS, prune="hierarchy",
                                placements=jplacement.STRATEGIES)
    return {
        "key": TUNER_KEY, "n_pes": FIG4_N, "n_trials": TUNER_TRIALS,
        "delays": list(TUNER_DELAYS), "n_schedules": len(schedules),
        "kernels": list(wres.kernels),
        "workload": [{"kernel": p.kernel, "schedule": p.schedule.name,
                      "mean_span": p.mean_span,
                      "uniform_schedule": p.uniform_schedule.name,
                      "uniform_span": p.uniform_span}
                     for p in jtuning.best_per_kernel(wres)],
        "per_delay": [{"delay": p.delay, "schedule": p.schedule.name,
                       "mean_span": p.mean_span,
                       "uniform_schedule": p.uniform_schedule.name,
                       "uniform_span": p.uniform_span}
                      for p in jtuning.best_per_delay(dres)],
        "placed": {"n_points": len(pres.schedules),
                   "winners": list(jsweep.best_schedule_per_delay(pres)),
                   "mean_span": _floats(
                       np.asarray(pres.mean_span).min(axis=0))},
    }


def _fig7_tuned_row(n_rx: int, fpr: int) -> dict:
    app = jfiveg.FiveGConfig(n_rx=n_rx, ffts_per_round=fpr)
    row = {"n_rx": n_rx, "ffts_per_round": fpr}
    for mode in TUNED_MODES:
        res = jfiveg.simulate_app(jax.random.PRNGKey(FIG7_KEY), app,
                                  sync=mode)
        row[mode] = {c: float(np.asarray(getattr(res, c)))
                     for c in FIG7_COLUMNS}
        row[mode]["stage_schedule"] = res.stage_schedule
        row[mode]["global_schedule"] = res.global_schedule
    return row


def _faults(n: int = FAULTS.N_PES, n_trials: int = FAULTS.TRIALS) -> dict:
    """The degradation sweep of ``benchmarks/bench_faults.py`` with the
    JAX package: its schedule stack, its masked arrival stack, its robust
    and clean sweeps, its per-rate picks and its rounded record."""
    cfg = JConfig(n_pes=n)
    scheds = list(jtuning.all_schedules(n, cfg, prune="hierarchy"))
    names = {jbarrier.schedule_name(s, None) for s in scheds}
    for extra in (jbarrier.kary_tree(min(32, n), cfg=cfg),
                  jbarrier.central_counter(cfg=cfg)):
        if jbarrier.schedule_name(extra, None) not in names:
            scheds.append(extra)
    k_arr, k_mask = jax.random.split(jax.random.PRNGKey(FAULTS.KEY))
    base = jax.random.uniform(k_arr, (n_trials, n), jnp.float32, 0.0,
                              FAULTS.DELAY)
    arrivals = jnp.stack([
        jnp.where(jax.random.bernoulli(jax.random.fold_in(k_mask, i), rate,
                                       (n_trials, n)), jnp.inf, base)
        for i, rate in enumerate(FAULTS.RATES)])
    labels = tuple(f"fail_{r:g}" for r in FAULTS.RATES)
    chunk = min(16, n_trials)
    res = jsweep.sweep_arrivals(
        arrivals, scheds, cfg, kernels=labels, trial_chunk=chunk,
        faults=jbarrier.fault_spec(FAULTS.TIMEOUT, FAULTS.QUORUM))
    clean = jsweep.sweep_arrivals(arrivals[:1], scheds, cfg,
                                  kernels=labels[:1], trial_chunk=chunk)
    i_lat = int(np.argmin(np.asarray(clean.span_cycles).mean(axis=-1)[:, 0]))
    spans = np.asarray(jnp.mean(res.span_cycles, axis=-1))
    p99 = np.asarray(jnp.percentile(res.span_cycles, 99.0, axis=-1,
                                    method="lower"))
    completion = np.asarray(res.completion_rate)
    abandoned = np.asarray(jnp.mean(res.abandoned_pes.astype(jnp.float32),
                                    axis=-1))
    winners = [int(np.argmin(p99[:, j])) for j in range(len(labels))]

    def point(i, j):
        return {"schedule": res.names[i],
                "p99_cycles": round(float(p99[i, j]), 1),
                "mean_cycles": round(float(spans[i, j]), 1),
                "completion_rate": round(float(completion[i, j]), 5),
                "abandoned_pes_mean": round(float(abandoned[i, j]), 2)}

    curve = []
    for j, rate in enumerate(FAULTS.RATES):
        lat, rob = point(i_lat, j), point(winners[j], j)
        curve.append({"fail_rate": rate, "latency_tuned": lat,
                      "robust_tuned": rob,
                      "p99_improvement": round(
                          lat["p99_cycles"] / max(rob["p99_cycles"], 1e-9),
                          4)})
    beats = [c["p99_improvement"] > 1.0 for c in curve
             if c["fail_rate"] >= 0.01]
    return {
        "key": FAULTS.KEY, "n_pes": n, "n_trials": n_trials,
        "rates": list(FAULTS.RATES), "names": list(res.names),
        "latency_winner": res.names[i_lat],
        "robust_winners": [res.names[i] for i in winners],
        "p99_cycles": _floats(p99), "mean_cycles": _floats(spans),
        "completion_rate": _floats(completion),
        "abandoned_pes_mean": _floats(abandoned),
        "span_prefix": _floats(
            np.asarray(res.span_cycles)[:, :, :SPAN_PREFIX]),
        "record": {"n_pes": n, "n_schedules": len(scheds),
                   "n_trials": n_trials, "base_delay": FAULTS.DELAY,
                   "timeout_cycles": FAULTS.TIMEOUT,
                   "quorum_frac": FAULTS.QUORUM, "curve": curve,
                   "robust_beats_latency_at_1pct": bool(beats
                                                        and all(beats))},
    }


def _fiveg_faults(modes=FAULTS.FIVEG_MODES) -> dict:
    """The benchmark's 5G degradation curve with the JAX package."""
    curve = jfiveg.degradation_curve(
        jax.random.PRNGKey(FAULTS.KEY), FAULTS.RATES,
        jfiveg.FiveGConfig(**FAULTS.FIVEG_APP), modes=modes, core="scan",
        timeout_cycles=FAULTS.TIMEOUT, quorum_frac=FAULTS.QUORUM)
    columns = FIG7_COLUMNS + ("completion_rate", "timed_out_levels")
    return {"key": FAULTS.KEY, "app": FAULTS.FIVEG_APP,
            "rates": list(FAULTS.RATES),
            **{mode: [{c: float(np.asarray(getattr(r, c))) for c in columns}
                      for r in curve[mode]] for mode in modes}}


def _straggler_pareto() -> dict:
    draws = jworkloads.arrival_batch(jax.random.PRNGKey(STRAGGLER_KEY),
                                     "straggler_pareto", STRAGGLER_SHAPE)
    return {"key": STRAGGLER_KEY, "shape": list(STRAGGLER_SHAPE),
            "values": _floats(draws)}


def _fig4b() -> dict:
    """Fig. 4b from the Fig. 4a sweep, and claim C3's residencies, with
    the JAX package."""
    res = jsweep.sweep_barrier(jax.random.PRNGKey(FIG4.KEY),
                               radices=list(jbarrier.all_radices()),
                               delays=FIG4.DELAYS, n_trials=FIG4.N_TRIALS)
    spans = np.asarray(res.mean_span)
    resid = np.asarray(res.mean_residency_grid)
    radices = [int(r) for r in np.asarray(res.radices)]
    rows = []
    for j, delay in enumerate(FIG4.DELAYS):
        i = int(np.argmin(spans[:, j]))
        rows.append({"delay": delay, "radix": radices[i],
                     "mean_residency": float(resid[i, j])})
    c3 = []
    key = jax.random.PRNGKey(FIG4.KEY)
    for delay, lo, hi in FIG4.C3_BANDS:
        arr = jbarrier_sim.uniform_arrivals(key, delay, FIG4.N_PES,
                                            FIG4.C3_TRIALS)
        c3.append({"delay": delay, "band": [lo, hi], "costs": [
            float(jnp.mean(jbarrier_sim.simulate(
                arr, jbarrier.kary_tree(r)).mean_residency))
            for r in FIG4.C3_RADICES]})
    return {"key": FIG4.KEY, "n_pes": FIG4.N_PES,
            "n_trials": FIG4.N_TRIALS, "delays": list(FIG4.DELAYS),
            "radices": radices, "rows": rows,
            "c3": {"radices": list(FIG4.C3_RADICES),
                   "n_trials": FIG4.C3_TRIALS, "rows": c3}}


def mc_machine(multi_cluster, config, n: int):
    """The 4-cluster machine of ``n`` PEs, built by either package."""
    return multi_cluster(config(n_pes=n // 4), n_clusters=4)


def mc_stacks(tuning_mod, barrier_mod, cfg) -> list:
    """Two schedule stacks of a multi-cluster machine as level sizes,
    built by either package: the hierarchy-segment intra tree under
    every inter-cluster tree, with the radix-16 tree over the whole
    machine (tight telescope widths); and every ``len / MC_PICKS``-th
    joint composition with the central counter (the ``N >> i``
    widths)."""
    seg = [tuple(tuning_mod._hier_segments(cfg.pes_per_cluster, cfg))]
    comps = tuning_mod.multicluster_compositions(cfg)
    return [
        [list(c) for c in tuning_mod.multicluster_compositions(
            cfg, intra=seg)]
        + [list(barrier_mod.kary_tree(16, n_pes=cfg.n_pes, cfg=cfg).sizes)],
        [list(c) for c in comps[::max(1, len(comps) // MC_PICKS)]]
        + [[cfg.n_pes]]]


def _multicluster() -> dict:
    """Hierarchical stacks at 2048 and 4096 PEs with the JAX package."""
    out = []
    for n in MC_NS:
        cfg = mc_machine(jmulti_cluster, JConfig, n)
        arr = MC_DELAY * jax.random.uniform(jax.random.PRNGKey(MC_KEY),
                                            (MC_TRIALS, n))
        for comps in mc_stacks(jtuning, jbarrier, cfg):
            scheds = [jbarrier.mixed_radix_tree(c, cfg=cfg) for c in comps]
            res = jsweep.sweep_arrivals(arr, scheds, cfg)
            out.append({"n_pes": n, "n_clusters": 4, "sizes": comps,
                        "names": [s.name for s in scheds],
                        "widths": list(jbarrier.telescope_widths(
                            jbarrier.stack_tables(scheds, cfg), n)),
                        "exit_time": _floats(res.exit_time[:, 0]),
                        "span_cycles": _floats(res.span_cycles[:, 0])})
    return {"key": MC_KEY, "n_trials": MC_TRIALS, "delay": MC_DELAY,
            "stacks": out}


def _prng_original() -> dict:
    """Draws of the original (non-partitionable) threefry stream."""
    key = jax.random.PRNGKey(PRNG_ORIGINAL_KEY)
    with jax.threefry_partitionable(False):
        return {
            "key": PRNG_ORIGINAL_KEY,
            "split": np.asarray(jax.random.split(key, 3),
                                np.int64).tolist(),
            "draws": [{"shape": list(shape),
                       "uniform": _floats(jax.random.uniform(key, shape)),
                       "normal": _floats(jax.random.normal(key, shape)),
                       "bernoulli": np.asarray(jax.random.bernoulli(
                           key, 0.3, shape)).tolist()}
                      for shape in PRNG_ORIGINAL_SHAPES]}


def leaf_digests(leaves) -> list:
    """sha256 (first 16 hex digits) of each leaf's bytes."""
    return [hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]
            for a in leaves]


def _lm_serve() -> dict:
    """The qwen3 smoke config served by the JAX package, bf16 through the
    serve steps and float32 end to end."""
    out = {"arch": LM_ARCH, "batch": LM_BATCH,
           "prompt_len": LM_PROMPT_LEN, "steps": LM_STEPS,
           "seed": LM_SEED, "variants": {}}
    for dtype in ("bfloat16", "float32"):
        jcfg, cfg = variant(LM_ARCH, dtype)
        params = jinit_params(jcfg, jax.random.PRNGKey(0))
        toks = prompts(jcfg.vocab_size, LM_BATCH,
                       LM_PROMPT_LEN + LM_STEPS + 1, LM_SEED)
        run = jax_serve(jcfg, params, toks, LM_PROMPT_LEN, LM_STEPS,
                        cache_dtype=dtype)
        paths = [p for p, _ in layers.tree_items(param_defs(cfg))]
        out["prompts"] = toks.tolist()
        out["variants"][dtype] = {
            "cache_dtype": dtype,
            "digests": dict(zip(paths, leaf_digests(
                jax.tree.map(np.asarray, jax.tree.leaves(params))))),
            "prefill_logits": _floats(run["prefill_logits"]),
            "decode_logits": [_floats(x) for x in run["decode_logits"]],
            "tokens": [np.asarray(t).tolist() for t in run["tokens"]]}
    return out


def generate() -> dict:
    res = jsweep.sweep_barrier(jax.random.PRNGKey(FIG4_KEY),
                               delays=FIG4_DELAYS, n_pes=FIG4_N,
                               n_trials=FIG4_TRIALS)
    return {
        "fig7": _fig7(),
        "fig4a": {"key": FIG4_KEY, "n_pes": FIG4_N,
                  "n_trials": FIG4_TRIALS, "delays": list(FIG4_DELAYS),
                  "radices": [int(r) for r in np.asarray(res.radices)],
                  "span_cycles": np.asarray(res.span_cycles).tolist()},
        "fig5": _fig5(),
        "fig6": _fig6(),
        "tuner": _tuner(),
        "fig7_tuned": {"key": FIG7_KEY, "modes": list(TUNED_MODES),
                       "rows": [_fig7_tuned_row(*p) for p in TUNED_GRID]},
        "normal_sample": {
            "key": NORMAL_KEY,
            "values": _floats(jax.random.normal(
                jax.random.PRNGKey(NORMAL_KEY), (NORMAL_COUNT,)))},
        "faults": _faults(),
        "fiveg_faults": _fiveg_faults(),
        "straggler_pareto": _straggler_pareto(),
        "fig4b": _fig4b(),
        "multicluster": _multicluster(),
        "prng_original": _prng_original(),
        "lm_serve": _lm_serve(),
        **{name: _figure(name) for name in FIGURES},
    }


def _load() -> dict:
    return json.loads(PATH.read_text())


def _row(values: dict, n_rx: int, fpr: int) -> dict:
    (row,) = [r for r in values["fig7"]["rows"]
              if (r["n_rx"], r["ffts_per_round"]) == (n_rx, fpr)]
    return row


def test_fig7_row_matches_jax():
    """The file's (16, 1) row is what the JAX package computes now."""
    want = _fig7_row(16, 1)
    got = _row(_load(), 16, 1)
    for mode in FIG7_MODES:
        assert got[mode]["total_cycles"] == want[mode]["total_cycles"]
        for c in ("sync_fraction", "sync_energy"):
            np.testing.assert_allclose(got[mode][c], want[mode][c],
                                       rtol=1e-6, err_msg=f"{mode}.{c}")


def test_fig7_row_matches_port():
    """The port reproduces the file's (16, 1) row on the CPU: cycles bit
    for bit, the mean-based columns to rtol 1e-5 (summation order)."""
    row = _row(_load(), 16, 1)
    res = fiveg.compare_barriers(
        prng.PRNGKey(FIG7_KEY, device="cpu"),
        fiveg.FiveGConfig(n_rx=16, ffts_per_round=1), radix=FIG7_RADIX,
        modes=FIG7_MODES, device="cpu")
    for mode in FIG7_MODES:
        assert res[mode].total_cycles.item() == np.float32(
            row[mode]["total_cycles"])
        for c in ("sync_fraction", "sync_energy"):
            np.testing.assert_allclose(getattr(res[mode], c).item(),
                                       row[mode][c], rtol=1e-5,
                                       err_msg=f"{mode}.{c}")


def test_fig4a_prefix_matches_port():
    """The port's CPU sweep gives the file's Fig. 4a spans bit for bit,
    and so does the 16-trial prefix of a longer sweep (partitionable
    threefry: a (T, N) block is the first T rows of a taller one)."""
    ref = _load()["fig4a"]
    want = np.asarray(ref["span_cycles"], np.float32)
    key = prng.PRNGKey(ref["key"], device="cpu")
    res = sweep.sweep_barrier(key, delays=ref["delays"],
                              n_pes=ref["n_pes"], n_trials=ref["n_trials"],
                              device="cpu")
    assert [int(r) for r in res.radices] == ref["radices"]
    assert np.array_equal(res.span_cycles.numpy(), want)
    longer = sweep.sweep_barrier(key, radices=[32, 1024], delays=[512.0],
                                 n_pes=ref["n_pes"], n_trials=24,
                                 device="cpu")
    rows = [ref["radices"].index(32), ref["radices"].index(1024)]
    assert torch.equal(longer.span_cycles[:, 0, :16],
                       torch.from_numpy(want[rows, 2]))


_SECTIONS = {"lm_serve": _lm_serve, "fig4b": _fig4b,
             "multicluster": _multicluster, "prng_original": _prng_original,
             "fig5": _fig5, "fig6": _fig6, "fig7": _fig7,
             **{name: (lambda n=name: _figure(n)) for name in FIGURES}}


if __name__ == "__main__":
    if sys.argv[1:]:
        values = _load()
        values.update({name: _SECTIONS[name]() for name in sys.argv[1:]})
    else:
        # Sections generated elsewhere (``serving``:
        # tests/test_torch_serving_values.py) are kept.
        values = {**_load(), **generate()}
    PATH.write_text(json.dumps(values, indent=1) + "\n")
    print(f"wrote {PATH}")


def test_fig5_and_fig6_match_jax():
    """The file's Fig. 5 and Fig. 6 sections are what the JAX package
    computes now."""
    values = _load()
    assert values["fig5"] == _fig5()
    assert values["fig6"] == _fig6()


def test_fig5_and_fig6_match_port():
    """The port's CPU run gives the Fig. 5 gaps and the Fig. 6 exit times
    bit for bit; medians and residencies to rtol 1e-6."""
    values = _load()
    key = prng.PRNGKey(FIG5_KEY, device="cpu")
    suite = workloads.benchmark_suite()
    for kernel, dims in suite.items():
        for label, fn in dims.items():
            arr = fn(key)
            want = values["fig5"]["kernels"][f"{kernel}_{label}"]
            assert workloads.cdf_first_last_gap(arr).item() == want["gap"]
            np.testing.assert_allclose(
                torch.quantile(arr - arr.min(), 0.5).item(), want["p50"],
                rtol=1e-6)
    ref = values["fig6"]
    key = prng.PRNGKey(ref["key"], device="cpu")
    arrivals = torch.stack([fn(key) for dims in suite.values()
                            for fn in dims.values()])[:, None, :]
    res = sweep.sweep_arrivals(
        arrivals, [barrier.kary_tree(r) for r in ref["radices"]],
        kernels=ref["kernels"])
    assert torch.equal(res.exit_time[:, :, 0],
                       torch.tensor(ref["exit_time"], dtype=torch.float32))
    np.testing.assert_allclose(res.mean_residency[:, :, 0].numpy(),
                               ref["mean_residency"], rtol=1e-6)


def test_tuner_section_is_consistent():
    """The N = 1024 tuner section (checked on the card by
    chip_smoke.py) covers the Fig. 6 kernels in order, and every
    workload winner matches or beats its best uniform radix."""
    ref = _load()["tuner"]
    assert ref["kernels"] == list(workloads.FIG6_KERNELS)
    assert ref["n_schedules"] == 512
    for w in ref["workload"]:
        assert w["mean_span"] <= w["uniform_span"]
    assert all(name.endswith("@leaf_local")
               for name in ref["placed"]["winners"])


def test_normal_sample_matches_jax_and_port():
    ref = _load()["normal_sample"]
    want = np.asarray(ref["values"], np.float32)
    jax_now = np.asarray(jax.random.normal(jax.random.PRNGKey(ref["key"]),
                                           want.shape))
    port = prng.normal(prng.PRNGKey(ref["key"], device="cpu"),
                       want.shape).numpy()
    assert np.array_equal(jax_now.view(np.int32), want.view(np.int32))
    assert np.array_equal(port.view(np.int32), want.view(np.int32))


def test_straggler_pareto_matches_jax_and_port():
    """The stored Pareto straggler draws are what JAX draws now, and the
    port's CPU draws (the C library's ``powf`` in one C loop) equal them
    bit for bit."""
    ref = _load()["straggler_pareto"]
    want = np.asarray(ref["values"], np.float32)
    jax_now = np.asarray(_straggler_pareto()["values"], np.float32)
    port = workloads.arrival_batch(prng.PRNGKey(ref["key"], device="cpu"),
                                   "straggler_pareto", tuple(ref["shape"]))
    assert np.array_equal(jax_now.view(np.int32), want.view(np.int32))
    assert np.array_equal(port.numpy().view(np.int32), want.view(np.int32))


def test_fault_sweep_driver_matches_jax_at_small_n():
    """``repro_torch.examples.bench_faults.degradation_sweep`` against the
    benchmark's procedure run by JAX, at N = 64 and 8 trials: the
    rounded record, winners, p99s and spans bit for bit."""
    want = _faults(64, 8)
    record, res, i_lat = bench_faults.degradation_sweep(
        n_pes=64, n_trials=8, device="cpu")
    assert record == want["record"]
    assert list(res.names) == want["names"]
    assert res.names[i_lat] == want["latency_winner"]
    assert np.array_equal(res.span_cycles[:, :, :SPAN_PREFIX].numpy(),
                          np.asarray(want["span_prefix"], np.float32))
    from repro_torch.core import tuning
    assert np.array_equal(tuning._objective_grid(res, "p99_cycles"),
                          np.asarray(want["p99_cycles"], np.float32))
    np.testing.assert_allclose(res.mean_span.numpy(), want["mean_cycles"],
                               rtol=1e-6)


def test_fault_sections_keep_the_bench_file_claims():
    """The stored N = 1024 sweep (today's JAX) keeps BENCH_faults.json's
    claims — the latency and robust winners at every rate, and the robust
    pick beating the latency pick on p99 from 1 % of PEs failed — though
    its numbers differ: the file was drawn with
    ``jax_threefry_partitionable`` off, the stream on which
    :func:`test_fiveg_faults_original_stream_reproduce_bench_file` and
    ``chip_smoke.py`` reproduce it."""
    ref = _load()["faults"]
    bench = json.loads((PATH.parents[2] / "BENCH_faults.json").read_text())
    file_curve = bench["degradation"]["curve"]
    got_curve = ref["record"]["curve"]
    assert [(c["latency_tuned"]["schedule"], c["robust_tuned"]["schedule"])
            for c in got_curve] == [
        (c["latency_tuned"]["schedule"], c["robust_tuned"]["schedule"])
        for c in file_curve]
    assert ref["record"]["robust_beats_latency_at_1pct"] is True
    assert bench["degradation"]["robust_beats_latency_at_1pct"] is True
    for key in ("n_pes", "n_schedules", "n_trials", "base_delay",
                "timeout_cycles", "quorum_frac"):
        assert ref["record"][key] == bench["degradation"][key], key
    assert ref["robust_winners"] == [c["robust_tuned"]["schedule"]
                                     for c in got_curve]


def test_lm_serve_section_matches_jax():
    """The stored serve run is what the JAX package computes now."""
    assert _load()["lm_serve"] == json.loads(json.dumps(_lm_serve()))


def test_lm_serve_section_matches_port():
    """The port on the CPU: its init gives the stored leaf digests; its
    serve loop the stored logits (float32 at 1e-4 with its own greedy
    tokens equal; bf16, fed the stored tokens, within its bound)."""
    ref = _load()["lm_serve"]
    toks = np.asarray(ref["prompts"])
    for dtype, want in ref["variants"].items():
        _, cfg = variant(ref["arch"], dtype)
        params = init_params(cfg, prng.PRNGKey(0, device="cpu"))
        items = layers.tree_items(params)
        got = dict(zip([p for p, _ in items], leaf_digests(
            [t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
             else t.numpy() for _, t in items])))
        assert got == want["digests"]
        forced = None if dtype == "float32" else want["tokens"][:-1]
        run = port_serve(cfg, params, toks, ref["prompt_len"], ref["steps"],
                         forced=forced, cache_dtype=want["cache_dtype"])
        atol = LM_F32_ATOL if dtype == "float32" else LM_BF16_ATOL
        rtol = LM_F32_ATOL if dtype == "float32" else 0.0
        logits = [run["prefill_logits"]] + run["decode_logits"]
        stored = [want["prefill_logits"]] + want["decode_logits"]
        for g, w, gt, wt in zip(logits, stored, run["tokens"],
                                want["tokens"]):
            w = np.asarray(w, np.float32)
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
            clear = (top2_margin(w) > 2 * atol if dtype == "bfloat16"
                     else np.ones(len(wt), bool))
            assert np.array_equal(gt[clear], np.asarray(wt)[clear])


def test_fig4b_section_matches_port(tmp_path):
    """``repro_torch.examples.fig4``'s CPU run, through the record it
    writes: the stored Fig. 4b best radices, their residencies to rtol
    1e-6, and C3's residencies inside its bands
    (tests/test_torch_bench_drivers.py holds the same procedure to JAX
    at 4 trials)."""
    ref = _load()["fig4b"]
    out = tmp_path / "fig4.json"
    fig4.main(["--device", "cpu", "--out", str(out)])
    record = json.loads(out.read_text())
    assert len(record["fig4a"]) == 40
    assert len(record["fig4b"]) == len(ref["rows"])
    for row, want in zip(record["fig4b"], ref["rows"]):
        assert (row["delay"], row["radix"]) == (want["delay"], want["radix"])
        np.testing.assert_allclose(row["mean_residency"],
                                   want["mean_residency"], rtol=1e-6)
    assert len(record["c3"]) == len(ref["c3"]["rows"])
    for row, want in zip(record["c3"], ref["c3"]["rows"]):
        assert (row["delay"], row["band"]) == (want["delay"], want["band"])
        np.testing.assert_allclose(list(row["costs"].values()),
                                   want["costs"], rtol=1e-6)
        assert row["holds"]


def test_multicluster_section_matches_jax_and_port():
    """The stored hierarchical stacks at 2048 and 4096 PEs: the port's
    CPU run gives their names, widths, exit times and spans bit for bit,
    and JAX recomputes the first (tests/test_torch_multicluster.py holds
    the port to JAX at these machines)."""
    from repro_torch.core import tuning
    from repro_torch.core.topology import TeraPoolConfig, multi_cluster
    ref = _load()["multicluster"]
    jcfg = mc_machine(jmulti_cluster, JConfig, MC_NS[0])
    first = ref["stacks"][0]
    jres = jsweep.sweep_arrivals(
        ref["delay"] * jax.random.uniform(jax.random.PRNGKey(ref["key"]),
                                          (ref["n_trials"], MC_NS[0])),
        [jbarrier.mixed_radix_tree(c, cfg=jcfg) for c in first["sizes"]],
        jcfg)
    assert first["span_cycles"] == _floats(jres.span_cycles[:, 0])
    stacks = iter(ref["stacks"])
    for n in MC_NS:
        cfg = mc_machine(multi_cluster, TeraPoolConfig, n)
        arr = ref["delay"] * prng.uniform(prng.PRNGKey(ref["key"],
                                                       device="cpu"),
                                          (ref["n_trials"], n))
        for comps in mc_stacks(tuning, barrier, cfg):
            want = next(stacks)
            assert comps == want["sizes"]
            scheds = [barrier.mixed_radix_tree(c, cfg=cfg) for c in comps]
            res = sweep.sweep_arrivals(arr, scheds, cfg)
            assert [s.name for s in scheds] == want["names"]
            assert list(barrier.telescope_widths(
                barrier.stack_tables(scheds, cfg, device="cpu"), n)) == \
                want["widths"]
            for f in ("exit_time", "span_cycles"):
                assert np.array_equal(getattr(res, f)[:, 0].numpy(),
                                      np.asarray(want[f], np.float32)), f


def test_prng_original_section_matches_jax_and_port():
    ref = _load()["prng_original"]
    assert ref == json.loads(json.dumps(_prng_original()))
    key = prng.PRNGKey(ref["key"], device="cpu")
    with prng.threefry_partitionable(False):
        assert prng.split(key, 3).tolist() == ref["split"]
        for want in ref["draws"]:
            shape = tuple(want["shape"])
            for name in ("uniform", "normal"):
                got = getattr(prng, name)(key, shape).numpy()
                assert np.array_equal(
                    got.view(np.int32),
                    np.asarray(want[name], np.float32).view(np.int32)), name
            assert prng.bernoulli(key, 0.3, shape).tolist() == \
                want["bernoulli"]


def test_fault_sweep_driver_matches_jax_at_small_n_original_stream():
    """The degradation sweep on the original threefry stream against the
    benchmark's procedure run by JAX with the flag off, at N = 64."""
    with jax.threefry_partitionable(False):
        want = _faults(64, 8)
    with prng.threefry_partitionable(False):
        record, res, i_lat = bench_faults.degradation_sweep(
            n_pes=64, n_trials=8, device="cpu")
    assert record == want["record"]
    assert res.names[i_lat] == want["latency_winner"]
    assert np.array_equal(res.span_cycles[:, :, :SPAN_PREFIX].numpy(),
                          np.asarray(want["span_prefix"], np.float32))
    assert record != bench_faults.degradation_sweep(
        n_pes=64, n_trials=8, device="cpu")[0]


@pytest.fixture
def one_call(monkeypatch):
    """The reference benchmarks' ``timing.measure`` as one call: their
    rows do not depend on the timing, and their figure calls are long."""
    from benchmarks import timing as bench_timing
    monkeypatch.setattr(
        bench_timing, "measure",
        lambda fn, **_: (jax.block_until_ready(fn()), 0.0, 0.0))
