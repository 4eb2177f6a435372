"""Port parity: the Fig. 7 5G application against the JAX package.

``total_cycles`` is an exit time and matches bit for bit; the columns
built from means over PEs (sync cycles and fraction, energies) match to
a relative 1e-5.  The tuner modes also pick the reference's schedule
names.
"""
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import fiveg as jfiveg
from repro_torch.core import fiveg, prng
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

MODES = ("central", "tree", "partial", "hw")
MEAN_COLUMNS = ("sync_cycles", "sync_fraction", "sync_energy",
                "total_energy", "energy_fraction")


@pytest.fixture(scope="module")
def fig7_pair():
    app = dict(n_rx=16, ffts_per_round=1)
    want = jfiveg.compare_barriers(jax.random.PRNGKey(0),
                                   jfiveg.FiveGConfig(**app), modes=MODES)
    got = fiveg.compare_barriers(prng.PRNGKey(0, device="cpu"),
                                 fiveg.FiveGConfig(**app), modes=MODES,
                                 device="cpu")
    return got, want


@pytest.mark.parametrize("mode", MODES)
def test_compare_barriers_matches(fig7_pair, mode):
    got, want = fig7_pair
    g, w = got[mode], want[mode]
    assert g.total_cycles.item() == np.float32(np.asarray(w.total_cycles))
    for c in ("serial_cycles", "speedup_serial"):
        assert getattr(g, c).item() == np.float32(np.asarray(getattr(w, c)))
    for c in MEAN_COLUMNS:
        np.testing.assert_allclose(getattr(g, c).item(),
                                   float(np.asarray(getattr(w, c))),
                                   rtol=1e-5, err_msg=c)
    assert (g.stage_schedule, g.global_schedule) == (w.stage_schedule,
                                                     w.global_schedule)
    for c in ("total_cycles", "sync_cycles", "sync_energy"):
        assert getattr(g, c).dtype == torch.float32
    if mode != "central":
        assert got[f"speedup_{mode}"].item() == np.float32(
            np.asarray(want[f"speedup_{mode}"]))
        np.testing.assert_allclose(got[f"energy_ratio_{mode}"].item(),
                                   float(np.asarray(
                                       want[f"energy_ratio_{mode}"])),
                                   rtol=1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_reference_loop_matches(mode):
    """The seed epoch loops of both packages, and the port's production
    path, on a short pipeline (one FFT per subset)."""
    app = dict(n_rx=4, ffts_per_round=1)
    want = jfiveg.simulate_app_reference(jax.random.PRNGKey(1),
                                         jfiveg.FiveGConfig(**app),
                                         sync=mode)
    key = prng.PRNGKey(1, device="cpu")
    ref = fiveg.simulate_app_reference(key, fiveg.FiveGConfig(**app),
                                       sync=mode, device="cpu")
    got = fiveg.simulate_app(key, fiveg.FiveGConfig(**app), sync=mode,
                             device="cpu")
    exact = np.float32(np.asarray(want.total_cycles))
    assert ref.total_cycles.item() == got.total_cycles.item() == exact
    for c in MEAN_COLUMNS:
        np.testing.assert_allclose(getattr(ref, c).item(),
                                   float(np.asarray(getattr(want, c))),
                                   rtol=1e-5, err_msg=c)


def test_batched_epoch_draws_equal_per_epoch_draws():
    key = prng.PRNGKey(5, device="cpu")
    keys = prng.split(key, 6)
    start = torch.arange(1024, dtype=torch.float32)
    batched = fiveg._epoch_noise(keys, torch.tensor(400.0), 1024)
    for e in range(6):
        one = fiveg._epoch_arrivals(keys[e], start, 4000.0, 400.0, 1024)
        assert torch.equal(one, start + 4000.0 + batched[e])


TUNED_MODES = ("tuned", "tuned_partial", "placed", "workload", "pareto")
REFERENCE_VALUES = (Path(__file__).resolve().parents[1] / "src"
                    / "repro_torch" / "reference_values.json")


@pytest.fixture(scope="module")
def tuned_row():
    """The JAX package's five tuner modes at (16, 1), key 3, as stored by
    tests/test_torch_reference_values.py."""
    ref = json.loads(REFERENCE_VALUES.read_text())["fig7_tuned"]
    (row,) = [r for r in ref["rows"]
              if (r["n_rx"], r["ffts_per_round"]) == (16, 1)]
    return ref["key"], row


@pytest.mark.parametrize("mode", TUNED_MODES)
def test_tuner_modes_match_reference(tuned_row, mode):
    """No tuner mode is left unported: each runs on the port, picks the
    reference's stage and global schedules (``@strategy`` included) from
    the same fixed-seed tuning sweeps, and gives the reference's
    ``total_cycles`` bit for bit at (16, 1); the mean-based columns to a
    relative 1e-5.  Two modes are recomputed with JAX here — the
    exhaustive 256-PE subset tuner with the hierarchy-pruned global
    tree, and the placed latency x energy knee of both epoch models —
    the others come from the stored JAX values."""
    key, row = tuned_row
    app = dict(n_rx=16, ffts_per_round=1)
    got = fiveg.simulate_app(prng.PRNGKey(key, device="cpu"),
                             fiveg.FiveGConfig(**app), sync=mode,
                             device="cpu")
    want = row[mode]
    if mode in ("tuned_partial", "pareto"):
        live = jfiveg.simulate_app(jax.random.PRNGKey(key),
                                   jfiveg.FiveGConfig(**app), sync=mode)
        assert (live.stage_schedule, live.global_schedule) == (
            want["stage_schedule"], want["global_schedule"])
        assert float(np.asarray(live.total_cycles)) == want["total_cycles"]
        for c in MEAN_COLUMNS:
            np.testing.assert_allclose(getattr(got, c).item(),
                                       float(np.asarray(getattr(live, c))),
                                       rtol=1e-5, err_msg=c)
    assert (got.stage_schedule, got.global_schedule) == (
        want["stage_schedule"], want["global_schedule"])
    assert got.total_cycles.item() == np.float32(want["total_cycles"])
    for c in ("sync_fraction", "sync_energy"):
        np.testing.assert_allclose(getattr(got, c).item(), want[c],
                                   rtol=1e-5, err_msg=c)


def test_placed_mode_equals_its_per_bank_queue_oracle():
    """The batched epoch loop of the placed mode against the seed loop
    over the placement-aware oracle, on a short pipeline."""
    app = fiveg.FiveGConfig(n_rx=4, ffts_per_round=1)
    key = prng.PRNGKey(1, device="cpu")
    got = fiveg.simulate_app(key, app, sync="placed", device="cpu")
    ref = fiveg.simulate_app_reference(key, app, sync="placed",
                                       device="cpu")
    assert got.stage_schedule == ref.stage_schedule
    assert "@" in got.stage_schedule
    assert got.total_cycles.item() == ref.total_cycles.item()
    for c in MEAN_COLUMNS:
        np.testing.assert_allclose(getattr(got, c).item(),
                                   getattr(ref, c).item(), rtol=1e-5,
                                   err_msg=c)


def test_unknown_mode_and_faults_rejected():
    key = prng.PRNGKey(0, device="cpu")
    with pytest.raises(ValueError, match="unknown sync mode"):
        fiveg.simulate_app(key, sync="magic", device="cpu")
    with pytest.raises(ValueError, match="fail_rate"):
        fiveg.simulate_app(key, faults=fiveg.FiveGFaults(fail_rate=1.0),
                           device="cpu")
    with pytest.raises(ValueError, match="central"):
        fiveg.compare_barriers(key, modes=("tree",), device="cpu")
