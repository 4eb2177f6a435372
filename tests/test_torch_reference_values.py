"""Reference values of the port's main path, as data.

``src/repro_torch/reference_values.json`` holds what the JAX package
computes, on the CPU, for the Fig. 7 grid of ``benchmarks/fig7_5g_app.py``
(key 3, radix 32, modes central/tree/partial/hw) and for the first 16
trials of the Fig. 4a sweep at N = 1024 (key 0).  ``chip_smoke.py``
holds the port's GPU run against it without importing JAX.

Regenerate it with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_reference_values.py

The tests below recompute the (16, 1) Fig. 7 row with JAX, so the file
cannot go stale, and hold the port's CPU run to it.
"""
import json
from pathlib import Path

import jax
import numpy as np
import torch

from repro.core import fiveg as jfiveg
from repro.core import sweep as jsweep
from repro_torch.core import fiveg, prng, sweep

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
