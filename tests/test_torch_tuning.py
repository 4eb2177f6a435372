"""Port parity: the arrival sweeps and the barrier tuner against the JAX
package, at N = 64 (the reference tests' small cluster).

Winner names, Pareto fronts and knees must be the reference's exactly;
spans bit for bit; mean columns to a relative 1e-6 (torch sums in
another order than XLA).  Claim C6 — the workload tuner matches or
beats the per-delay tuner on every Fig. 6 kernel — is asserted on the
port's own results.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import barrier as jbarrier
from repro.core import placement as jplacement
from repro.core import sweep as jsweep
from repro.core import tuning as jtuning
from repro.core import workloads as jworkloads
from repro_torch.core import barrier, placement, prng, sweep, tuning, workloads
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

DELAYS = (0.0, 128.0, 512.0, 2048.0)
EXACT = ("exit_time", "last_arrival", "span_cycles")
MEANS = ("mean_residency", "energy")


def _keys(seed):
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed, device="cpu")


def _names(res):
    return tuple(res.names)


def _assert_grid(got, want):
    for f in EXACT:
        assert np.array_equal(getattr(got, f).numpy(),
                              np.asarray(getattr(want, f))), f
    for f in MEANS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-6,
                                   err_msg=f)


def _point(p):
    """A TunedPoint / WorkloadPoint as comparable names and spans."""
    return (p.schedule.name, getattr(p.placement, "strategy", None),
            p.uniform_schedule.name, np.float32(p.mean_span),
            np.float32(p.uniform_span))


@pytest.mark.parametrize("n,prune", [(64, "none"), (1024, "hierarchy")])
def test_composition_spaces(n, prune):
    assert tuning.enumerate_compositions(n) == jtuning.enumerate_compositions(n)
    assert tuning.hierarchy_compositions(n) == \
        jtuning.hierarchy_compositions(n)
    assert [s.name for s in tuning.all_schedules(n, prune=prune)] == \
        [s.name for s in jtuning.all_schedules(n, prune=prune)]
    assert len(tuning.enumerate_compositions(1024)) == 512
    assert len(tuning.hierarchy_compositions(1024)) == 128


@pytest.mark.parametrize("placements", [None, placement.STRATEGIES])
def test_tune_barrier_grid_and_selectors(placements):
    jk, tk = _keys(0)
    jres = jtuning.tune_barrier(jk, 64, delays=DELAYS, n_trials=4,
                                placements=placements)
    tres = tuning.tune_barrier(tk, 64, delays=DELAYS, n_trials=4,
                               placements=placements)
    assert _names(tres) == _names(jres)
    _assert_grid(tres, jres)
    assert [_point(p) for p in tuning.best_per_delay(tres)] == \
        [_point(p) for p in jtuning.best_per_delay(jres)]
    assert sweep.best_schedule_per_delay(tres) == \
        jsweep.best_schedule_per_delay(jres)
    for objectives in (("cycles",), ("cycles", "energy"),
                       ("p99_cycles", "worst_cycles")):
        assert [s.name for s in tuning.pareto_schedules(tres, objectives)] \
            == [s.name for s in jtuning.pareto_schedules(jres, objectives)]
    for col in range(len(DELAYS)):
        tf, jf = tuning.pareto_front(tres, col), jtuning.pareto_front(jres,
                                                                      col)
        assert [p.name for p in tf] == [p.name for p in jf]
        np.testing.assert_allclose([p.mean_energy for p in tf],
                                   [p.mean_energy for p in jf], rtol=1e-6)
        assert tuning.knee_point(tf).name == jtuning.knee_point(jf).name
    assert [s.name for s in tuning.pareto_schedules(tres, ("completion",))] \
        == [s.name for s in jtuning.pareto_schedules(jres, ("completion",))]


def test_best_schedule_selectors_by_objective():
    jk, tk = _keys(4)
    for objective in ("cycles", "energy", "edp"):
        assert tuning.best_schedule(tk, 64, delay=256.0, n_trials=4,
                                    objective=objective).name == \
            jtuning.best_schedule(jk, 64, delay=256.0, n_trials=4,
                                  objective=objective).name
    ts, tp = tuning.best_placed_schedule(tk, 64, delay=64.0, n_trials=4)
    js, jp = jtuning.best_placed_schedule(jk, 64, delay=64.0, n_trials=4)
    assert barrier.schedule_name(ts, tp) == jbarrier.schedule_name(js, jp)
    assert tp.shared_bank_counters() == (0,) * ts.n_levels


def test_sweep_arrivals_and_split_kernels():
    rng = np.random.default_rng(1)
    kernels = ("a", "b", "c")
    jarr = np.floor(rng.random((3, 3, 64), np.float32) * [[[1.0]], [[64.0]],
                                                          [[900.0]]])
    jarr = jarr.astype(np.float32)         # integral arrivals: many ties
    scheds = [(2,) * 6, (8, 8), (64,), (4, 2, 8)]
    jres = jsweep.sweep_arrivals(
        jarr, [jbarrier.mixed_radix_tree(s) for s in scheds],
        kernels=kernels)
    tres = sweep.sweep_arrivals(
        torch.from_numpy(jarr), [barrier.mixed_radix_tree(s)
                                 for s in scheds], kernels=kernels,
        trial_chunk=2)
    assert tres.span_cycles.shape == (4, 3, 3) and tres.kernels == kernels
    _assert_grid(tres, jres)
    for tcol, jcol in zip(sweep.split_kernels(tres),
                          jsweep.split_kernels(jres)):
        assert tcol.kernels == jcol.kernels
        _assert_grid(tcol, jcol)
    one = sweep.simulate_radices(torch.from_numpy(jarr[0, 0]), [2, 8, 64])
    jone = jsweep.simulate_radices(jarr[0, 0], [2, 8, 64])
    _assert_grid(one, jone)
    with pytest.raises(ValueError):
        sweep.sweep_arrivals(torch.from_numpy(jarr[0, 0]),
                             [barrier.kary_tree(2, n_pes=64)])
    with pytest.raises(ValueError):
        sweep.sweep_arrivals(torch.from_numpy(jarr),
                             [barrier.kary_tree(2, n_pes=256)])


def test_sweep_workloads_winners_and_c6():
    """Every Fig. 6 kernel at N = 64 across all 32 compositions x every
    placement strategy: the reference's winners, and C6 on the port's
    own grid — each kernel's workload winner matches or beats every
    per-delay winner on that kernel's arrivals."""
    jk, tk = _keys(0)
    jres = jtuning.sweep_workloads(jk, n_pes=64, n_trials=4,
                                   placements=placement.STRATEGIES)
    tres = tuning.sweep_workloads(tk, n_pes=64, n_trials=4,
                                  placements=placement.STRATEGIES)
    assert tres.kernels == workloads.FIG6_KERNELS
    assert _names(tres) == _names(jres)
    _assert_grid(tres, jres)
    points = tuning.best_per_kernel(tres)
    assert [_point(p) for p in points] == \
        [_point(p) for p in jtuning.best_per_kernel(jres)]
    for obj in ("cycles", "energy", "edp", "pareto"):
        assert [c.name for c in tuning.best_for_arrival_stack(tres, obj)] \
            == [c.name for c in jtuning.best_for_arrival_stack(jres, obj)]

    schedules = tuning.all_schedules(64)
    dres = tuning.tune_barrier(tk, 64, delays=DELAYS, n_trials=4,
                               schedules=schedules)
    winners = {p.schedule for p in tuning.best_per_delay(dres)}
    wres = tuning.sweep_workloads(tk, n_pes=64, n_trials=4,
                                  schedules=schedules)
    spans = wres.mean_span.numpy()
    for j, p in enumerate(tuning.best_per_kernel(wres)):
        assert p.mean_span <= p.uniform_span, p.kernel
        for w in winners:
            assert p.mean_span <= spans[wres.schedules.index(w), j], (
                p.kernel, w.name)


def test_tune_for_arrivals_and_workload_store():
    jk, tk = _keys(2)
    jarr = jworkloads.arrival_batch(jk, "dct_2x4096", (4, 64))
    tarr = workloads.arrival_batch(tk, "dct_2x4096", (4, 64))
    for objective in ("cycles", "pareto"):
        ts, tp, tspan = tuning.tune_for_arrivals(
            tarr, placements=placement.STRATEGIES, objective=objective)
        js, jp, jspan = jtuning.tune_for_arrivals(
            jarr, placements=jplacement.STRATEGIES, objective=objective)
        assert barrier.schedule_name(ts, tp) == jbarrier.schedule_name(js, jp)
        assert np.float32(tspan) == np.float32(jspan)
    tuning.tuned_for_workload.cache_clear()
    s1 = tuning.tuned_for_workload("conv2d_128x128", 64, device="cpu")
    s2 = tuning.tuned_for_workload("conv2d_128x128", 64, device="cpu")
    assert s1 == s2 and tuning.tuned_for_workload.cache_info().hits == 1
    js1, jp1 = jtuning.tuned_for_workload("conv2d_128x128", 64)
    assert barrier.schedule_name(*s1) == jbarrier.schedule_name(js1, jp1)
    clean = tuning.sweep_workloads(tk, ("conv2d_128x128",), 64, n_trials=2)
    noop = tuning.sweep_workloads(tk, ("conv2d_128x128",), 64, n_trials=2,
                                  fault_model=workloads.NO_PE_FAULTS)
    assert torch.equal(clean.span_cycles, noop.span_cycles)
