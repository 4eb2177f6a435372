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
* ``normal_sample``: ``jax.random.normal`` draws (key 0).

``chip_smoke.py`` holds the port's GPU run against it without importing
JAX.  Regenerate it with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_reference_values.py

The tests below recompute the cheap sections with JAX, so the file
cannot go stale, and hold the port's CPU run to the sections small
enough for the CPU.
"""
import json
from pathlib import Path

import jax
import numpy as np
import torch

from repro.core import barrier as jbarrier
from repro.core import fiveg as jfiveg
from repro.core import placement as jplacement
from repro.core import sweep as jsweep
from repro.core import tuning as jtuning
from repro.core import workloads as jworkloads
from repro_torch.core import barrier, fiveg, prng, sweep, workloads

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
    return {"key": FIG5_KEY, "kernels": out}


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
                        for j, i in enumerate(best)]}


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


def generate() -> dict:
    res = jsweep.sweep_barrier(jax.random.PRNGKey(FIG4_KEY),
                               delays=FIG4_DELAYS, n_pes=FIG4_N,
                               n_trials=FIG4_TRIALS)
    return {
        "fig7": {"key": FIG7_KEY, "radix": FIG7_RADIX,
                 "modes": list(FIG7_MODES),
                 "rows": [_fig7_row(*p) for p in FIG7_GRID]},
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


if __name__ == "__main__":
    PATH.write_text(json.dumps(generate(), indent=1) + "\n")
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
