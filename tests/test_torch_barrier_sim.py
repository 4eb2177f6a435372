"""Port parity: the simulator cores against the JAX package.

``exit_time``, ``last_arrival`` and ``span_cycles`` are chains of
float32 adds, sorts and maxes and must match bit for bit — for both
port cores, at both telescope width tables, and for the seed loop
``simulate_reference``.  ``mean_residency`` and ``energy`` are float32
means over the PEs, summed in another order by torch than by XLA (and
the reference's energy formula is FMA-contracted), so they match to a
relative 1e-6.
"""
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.core import barrier as jbarrier
from repro.core import barrier_sim as jsim
from repro.core import sweep as jsweep
from repro_torch.core import barrier, barrier_sim, prng
from repro_torch.core.topology import DEFAULT
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

NS = (64, 256, 1024)
DELAYS = np.asarray([0.0, 128.0, 2048.0], np.float32)
EXACT = ("exit_time", "last_arrival", "span_cycles")
MEANS = ("mean_residency", "energy")


def _schedules(mod, n):
    """Central, every k-ary tree and the event unit over ``n`` PEs, plus
    the partial trees over one 256-PE FFT subset at ``n == 256``."""
    out = [mod.central_counter(n)]
    out += [mod.kary_tree(k, n_pes=n) for k in mod.all_radices(n)]
    out += [mod.hw_event_unit(n)]
    if n == 256:
        out += [mod.partial_barrier(256, k) for k in mod.all_radices(256)]
    return out


def _arrivals(n, seed=0, trials=4):
    """(3 delays, trials, n) float32 arrivals from numpy."""
    unit = np.random.default_rng(seed).random((trials, n), np.float32)
    return DELAYS[:, None, None] * unit[None]


def _assert_result(got, want, exact=EXACT, means=MEANS):
    for f in exact:
        w = np.asarray(getattr(want, f))
        g = getattr(got, f).numpy()
        assert g.dtype == w.dtype and np.array_equal(g, w), f
    for f in means:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-6, err_msg=f)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("core", ["telescope", "scan"])
def test_cores_bit_exact(n, core):
    """Both port cores against the JAX production core, one grid per
    schedule stack (schedule x delay x trial)."""
    arr = _arrivals(n)
    jscheds, tscheds = _schedules(jbarrier, n), _schedules(barrier, n)
    want = jsweep.sweep_arrivals(arr, jscheds)           # (S, 3, T)
    for i, sched in enumerate(tscheds):
        got = barrier_sim.simulate(torch.from_numpy(arr), sched, core=core,
                                   device="cpu")
        _assert_result(got, SimpleNamespace(**{
            f: np.asarray(getattr(want, f))[i] for f in EXACT + MEANS}))


@pytest.mark.parametrize("n", NS)
def test_default_widths_bit_exact(n):
    """The telescoping core at the conservative N >> i widths (what the
    5G app uses) and at the stack's exact widths gives the same bits."""
    arr = torch.from_numpy(_arrivals(n, seed=1))
    table = barrier.stack_tables(_schedules(barrier, n), device="cpu")
    lifted = barrier.LevelTable(*(f.reshape(f.shape[:1] + (1, 1)
                                            + f.shape[1:]) for f in table))
    tight = barrier_sim._telescope_core(
        arr, lifted, DEFAULT, barrier.telescope_widths(table, n))
    loose = barrier_sim._telescope_core(arr, lifted, DEFAULT, None)
    for f in EXACT:
        assert torch.equal(getattr(tight, f), getattr(loose, f)), f


@pytest.mark.parametrize("n", NS)
def test_reference_loop_bit_exact(n):
    arr = _arrivals(n, seed=2)
    for js, ts in zip(_schedules(jbarrier, n), _schedules(barrier, n)):
        want = jsim.simulate_reference(arr, js)
        got = barrier_sim.simulate_reference(torch.from_numpy(arr), ts,
                                             device="cpu")
        _assert_result(got, want)
        core = barrier_sim.simulate(torch.from_numpy(arr), ts, device="cpu")
        for f in EXACT:
            assert torch.equal(getattr(core, f), getattr(got, f)), f


def test_result_dtypes_and_batch_shape():
    arr = torch.from_numpy(_arrivals(64))
    res = barrier_sim.simulate(arr, barrier.kary_tree(4, n_pes=64),
                               device="cpu")
    for f in barrier_sim.BarrierResult._fields:
        assert getattr(res, f).shape == (3, 4), f
    assert {f: getattr(res, f).dtype for f in res._fields} == {
        **{f: torch.float32 for f in EXACT + MEANS},
        "completed": torch.bool, "abandoned_pes": torch.int32,
        "timed_out_levels": torch.int32}
    assert bool(res.completed.all())


@pytest.mark.parametrize("delay", [0.0, 256.0, 2048.0])
def test_uniform_arrivals_and_span_metrics(delay):
    key, jkey = prng.PRNGKey(0, device="cpu"), jax.random.PRNGKey(0)
    arr = barrier_sim.uniform_arrivals(key, delay, 1024, 8, device="cpu")
    assert np.array_equal(arr.numpy(), np.asarray(
        jsim.uniform_arrivals(jkey, delay, 1024, 8)))
    got = barrier_sim.mean_span_cycles(key, barrier.kary_tree(32), delay,
                                       n_trials=8, device="cpu")
    want = jsim.mean_span_cycles(jkey, jbarrier.kary_tree(32), delay,
                                 n_trials=8)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    got = barrier_sim.overhead_fraction(key, barrier.kary_tree(32), 5000.0,
                                        delay, n_trials=8, device="cpu")
    want = jsim.overhead_fraction(jkey, jbarrier.kary_tree(32), 5000.0,
                                  delay, n_trials=8)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_segmented_cummax_matches_loop():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((5, 37)).astype(np.float32)
    starts = rng.random((5, 37)) < 0.2
    starts[:, 0] = True
    got = barrier_sim._segmented_cummax(torch.from_numpy(x),
                                        torch.from_numpy(starts)).numpy()
    want = x.copy()
    for r in range(5):
        for j in range(1, 37):
            if not starts[r, j]:
                want[r, j] = max(want[r, j - 1], x[r, j])
    assert np.array_equal(got, want)


def test_faults_and_unknown_core_rejected():
    """Bad fault specs and masks are refused (the robust path itself is
    held to the reference in tests/test_torch_faults.py), and so are an
    unknown core and a mismatched PE count."""
    arr = torch.zeros(64)
    sched = barrier.kary_tree(4, n_pes=64)
    with pytest.raises(ValueError, match="timeout_cycles"):
        barrier_sim.simulate(arr, sched, device="cpu",
                             faults=barrier.fault_spec(timeout_cycles=-1.0))
    with pytest.raises(RuntimeError):
        barrier_sim.simulate(arr, sched, device="cpu",
                             fault_mask=torch.zeros(65, dtype=bool))
    with pytest.raises(ValueError, match="unknown simulator core"):
        barrier_sim.simulate(arr, sched, core="fast", device="cpu")
    with pytest.raises(ValueError, match="schedule expects"):
        barrier_sim.simulate(torch.zeros(65), sched, device="cpu")
