"""Port parity: counter placement against the JAX package.

Every placement (bank and latency per counter) and every placed
``LevelTable`` field must equal the reference's in value and dtype, for
every strategy at N in {64, 256, 1024}.  Placed simulation is held bit
for bit (exit, last arrival, span) to the reference cores and to the
port's own per-bank-queue oracle at N in {64, 256}; means to a relative
1e-6.
"""
import numpy as np
import pytest
import torch

from repro.core import barrier as jbarrier
from repro.core import barrier_sim as jsim
from repro.core import placement as jplacement
from repro_torch.core import barrier, barrier_sim, placement
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

NS = (64, 256, 1024)
EXACT = ("exit_time", "last_arrival", "span_cycles")
MEANS = ("mean_residency", "energy")


def _sizes(n):
    """Central, every uniform radix, and two hierarchy-shaped mixed
    compositions over ``n`` PEs."""
    out = [(n,)] + [jbarrier.kary_tree(k, n_pes=n).sizes
                    for k in jbarrier.all_radices(n)]
    out += {64: [(8, 8), (4, 2, 8)], 256: [(8, 32), (8, 16, 2)],
            1024: [(8, 16, 8), (4, 2, 32, 4)]}[n]
    return out


def _pair(sizes, partial=False):
    return (jbarrier.mixed_radix_tree(sizes, partial=partial),
            barrier.mixed_radix_tree(sizes, partial=partial))


def _assert_tables_equal(jtab, ttab):
    for f in jbarrier.LevelTable._fields:
        want = np.asarray(getattr(jtab, f))
        got = getattr(ttab, f).numpy()
        assert got.dtype == want.dtype, (f, got.dtype, want.dtype)
        assert np.array_equal(got, want), f


def test_strategy_set():
    assert placement.STRATEGIES == jplacement.STRATEGIES


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("strategy", jplacement.STRATEGIES)
def test_placements_and_placed_tables_bit_exact(n, strategy):
    for sizes in _sizes(n):
        js, ts = _pair(sizes)
        jp = jplacement.place_counters(js, strategy)
        tp = placement.place_counters(ts, strategy)
        assert (tp.strategy, tp.banks, tp.latencies) == (
            jp.strategy, jp.banks, jp.latencies)
        assert tp.shared_bank_counters() == jp.shared_bank_counters()
        _assert_tables_equal(jbarrier.level_table(js, placement=jp),
                             barrier.level_table(ts, placement=tp,
                                                 device="cpu"))
        assert (barrier.schedule_name(ts, tp)
                == jbarrier.schedule_name(js, jp))


@pytest.mark.parametrize("n", NS)
def test_placed_stack_bit_exact(n):
    pairs = [_pair(s) for s in _sizes(n)]
    jscheds, jplacs, tscheds, tplacs = [], [], [], []
    for strategy in jplacement.STRATEGIES:
        for js, ts in pairs:
            jscheds.append(js)
            tscheds.append(ts)
            jplacs.append(jplacement.place_counters(js, strategy))
            tplacs.append(placement.place_counters(ts, strategy))
    jscheds.append(jbarrier.hw_event_unit(n))
    tscheds.append(barrier.hw_event_unit(n))
    jplacs.append(None)
    tplacs.append(None)
    jtab = jbarrier.stack_tables(jscheds, placements=jplacs)
    ttab = barrier.stack_tables(tscheds, placements=tplacs, device="cpu")
    _assert_tables_equal(jtab, ttab)
    assert barrier.telescope_widths(ttab, n) == jbarrier.telescope_widths(
        jtab, n)


def test_explicit_placement_and_partial_trees():
    js, ts = _pair((16, 16), partial=True)
    for offs, strides in (((0, 0), None), ((3, 7), (0, 4)),
                          ((5, 1), (1, 0))):
        jp = jplacement.explicit_placement(js, offs, strides)
        tp = placement.explicit_placement(ts, offs, strides)
        assert (tp.banks, tp.latencies) == (jp.banks, jp.latencies)
        _assert_tables_equal(jbarrier.level_table(js, placement=jp),
                             barrier.level_table(ts, placement=tp,
                                                 device="cpu"))
    with pytest.raises(ValueError):
        placement.explicit_placement(ts, (0,))
    with pytest.raises(ValueError):
        placement.place_counters(ts, "nowhere")
    with pytest.raises(ValueError):
        barrier.level_table(barrier.hw_event_unit(64),
                            placement=placement.place_counters(ts),
                            device="cpu")


def _arrivals(n, seed):
    """(2 scatters, 3 trials, n) float32 arrivals from numpy, with ties."""
    rng = np.random.default_rng(seed)
    unit = rng.random((3, n), np.float32)
    unit[0, : n // 4] = unit[0, 0]        # equal ready times
    return np.stack([np.floor(64.0 * unit), 2048.0 * unit]).astype(
        np.float32)


def _assert_result(got, want):
    for f in EXACT:
        assert np.array_equal(getattr(got, f).numpy(),
                              np.asarray(getattr(want, f))), f
    for f in MEANS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-6, err_msg=f)


@pytest.mark.parametrize("n", (64, 256))
@pytest.mark.parametrize("strategy", jplacement.STRATEGIES)
def test_placed_simulate_bit_exact(n, strategy):
    """Placed episodes through both port cores, the port's oracle and
    the reference's cores and oracle (N = 1024 placed grids are held to
    the reference on the card by chip_smoke.py's tuner phase)."""
    arr = _arrivals(n, seed=n)
    for sizes in _sizes(n)[::2]:
        js, ts = _pair(sizes)
        jp = jplacement.place_counters(js, strategy)
        tp = placement.place_counters(ts, strategy)
        want = jsim.simulate(arr, js, placement=jp)
        for core in ("telescope", "scan"):
            _assert_result(barrier_sim.simulate(
                torch.from_numpy(arr), ts, placement=tp, core=core,
                device="cpu"), want)
        oracle = placement.simulate_placed_reference(
            torch.from_numpy(arr), ts, tp, device="cpu")
        _assert_result(oracle, want)
        _assert_result(oracle, jplacement.simulate_placed_reference(
            arr, js, jp))
