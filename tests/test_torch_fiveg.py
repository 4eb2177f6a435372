"""Port parity: the Fig. 7 5G application against the JAX package.

``total_cycles`` is an exit time and matches bit for bit; the columns
built from means over PEs (sync cycles and fraction, energies) match to
a relative 1e-5.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import fiveg as jfiveg
from repro_torch.core import fiveg, prng

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


@pytest.mark.parametrize("mode", ["tuned", "tuned_partial", "placed",
                                  "workload", "pareto"])
def test_tuner_modes_not_ported(mode):
    with pytest.raises(NotImplementedError, match="ROADMAP.md §1 item"):
        fiveg.simulate_app(prng.PRNGKey(0, device="cpu"), sync=mode,
                           device="cpu")


def test_unknown_mode_and_faults_rejected():
    key = prng.PRNGKey(0, device="cpu")
    with pytest.raises(ValueError, match="unknown sync mode"):
        fiveg.simulate_app(key, sync="magic", device="cpu")
    with pytest.raises(NotImplementedError, match="§1 item 4"):
        fiveg.simulate_app(key, faults=object(), device="cpu")
    with pytest.raises(ValueError, match="central"):
        fiveg.compare_barriers(key, modes=("tree",), device="cpu")
