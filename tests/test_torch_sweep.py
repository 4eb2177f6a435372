"""Port parity: the Fig. 4a sweep engine against the JAX package.

Spans are bit for bit (the arrivals and every core op are exact); the
trial means match to a relative 1e-5 (summation order).
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import sweep as jsweep
from repro_torch.core import barrier, prng, sweep

N = 256
TRIALS = 4


@pytest.fixture(scope="module")
def pair():
    want = jsweep.sweep_barrier(jax.random.PRNGKey(0), n_pes=N,
                                n_trials=TRIALS)
    got = sweep.sweep_barrier(prng.PRNGKey(0, device="cpu"), n_pes=N,
                              n_trials=TRIALS, device="cpu")
    return got, want


@pytest.mark.parametrize("field", ["span_cycles", "exit_time",
                                   "last_arrival"])
def test_sweep_bit_exact(pair, field):
    got, want = pair
    w = np.asarray(getattr(want, field))
    g = getattr(got, field).numpy()
    assert g.shape == w.shape == (len(barrier.all_radices(N)), 4, TRIALS)
    assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("field", ["mean_residency", "energy"])
def test_sweep_means_to_tolerance(pair, field):
    got, want = pair
    np.testing.assert_allclose(getattr(got, field).numpy(),
                               np.asarray(getattr(want, field)), rtol=1e-6)


def test_sweep_grid_properties(pair):
    got, want = pair
    assert got.names == want.names
    assert np.array_equal(got.radices.numpy(), np.asarray(want.radices))
    assert np.array_equal(got.delays.numpy(), np.asarray(want.delays))
    np.testing.assert_allclose(got.mean_span.numpy(),
                               np.asarray(want.mean_span), rtol=1e-5)
    np.testing.assert_allclose(got.mean_residency_grid.numpy(),
                               np.asarray(want.mean_residency_grid),
                               rtol=1e-5)
    np.testing.assert_allclose(got.mean_energy.numpy(),
                               np.asarray(want.mean_energy), rtol=1e-5)
    assert np.array_equal(got.completion_rate.numpy(),
                          np.asarray(want.completion_rate))
    # The pick per delay minimizes the port's own spans, and its span is
    # the reference's minimum to tolerance (ties may pick either).
    best = sweep.best_radix_per_delay(got)
    jbest = np.asarray(jsweep.best_radix_per_delay(want))
    radices = list(got.radices.numpy())
    for d in range(len(got.delays)):
        np.testing.assert_allclose(
            got.mean_span[radices.index(int(best[d])), d].item(),
            float(np.asarray(want.mean_span)[radices.index(int(jbest[d])),
                                             d]), rtol=1e-5)


def test_trial_chunks_and_scan_core_bit_exact(pair):
    got, _ = pair
    key = prng.PRNGKey(0, device="cpu")
    chunked = sweep.sweep_barrier(key, n_pes=N, n_trials=TRIALS,
                                  trial_chunk=3, device="cpu")
    scan = sweep.sweep_barrier(key, n_pes=N, n_trials=TRIALS, core="scan",
                               device="cpu")
    for res in (chunked, scan):
        for f in ("exit_time", "span_cycles"):
            assert torch.equal(getattr(res, f), getattr(got, f)), f


def test_radix_tables_match_stack():
    radices = (2, 16, 256)
    tab = sweep.radix_tables(radices, n_pes=N, device="cpu")
    want = barrier.stack_tables(
        [barrier.kary_tree(r, n_pes=N) for r in radices], device="cpu")
    for f in barrier.LevelTable._fields:
        assert torch.equal(getattr(tab, f), getattr(want, f)), f


def test_unported_options_rejected():
    key = prng.PRNGKey(0, device="cpu")
    scheds = [barrier.kary_tree(4, n_pes=64)]
    with pytest.raises(NotImplementedError, match="§1 item 4"):
        sweep.sweep_schedules(key, scheds, faults=object(), device="cpu")
    with pytest.raises(ValueError, match="placements"):
        sweep.sweep_schedules(key, scheds, placements=[None, None],
                              device="cpu")
    with pytest.raises(ValueError, match="trial_chunk"):
        sweep.sweep_schedules(key, scheds, trial_chunk=0, device="cpu")
