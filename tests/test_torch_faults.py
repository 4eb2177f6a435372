"""Port parity: the degradation-tolerant barrier path against the JAX
package (the cases of tests/test_faults.py, held to the reference).

Spans, exit times, ``abandoned_pes``, ``timed_out_levels`` and 5G
``total_cycles`` must match bit for bit; ``mean_residency`` and
``energy`` are float32 means that torch sums in another order than XLA,
held to a relative 1e-6.  Inputs are made with numpy (or drawn through
the ported PRNG from the same seeds) and handed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import barrier as jbarrier
from repro.core import barrier_sim as jsim
from repro.core import fiveg as jfiveg
from repro.core import placement as jplacement
from repro.core import sweep as jsweep
from repro.core import tuning as jtuning
from repro.core import workloads as jworkloads
from repro.core.topology import TeraPoolConfig as JConfig
from repro_torch.core import (barrier, barrier_sim, energy, fiveg,
                              placement, prng, sweep, tuning, workloads)
from repro_torch.core.topology import TeraPoolConfig
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CFG, JCFG = TeraPoolConfig(n_pes=64), JConfig(n_pes=64)
COMPS = [(8, 8), (4, 4, 4), (2, 8, 4), (64,), (2, 2, 2, 2, 2, 2)]
SPECS = [dict(),
         dict(timeout_cycles=250.0),
         dict(quorum_frac=0.75),
         dict(timeout_cycles=300.0, quorum_frac=0.9),
         dict(timeout_cycles=[200.0, 400.0, 800.0])]
EXACT = ("exit_time", "last_arrival", "span_cycles", "completed",
         "abandoned_pes", "timed_out_levels")
MEANS = ("mean_residency", "energy")


def _arr(seed, batch, n, scale=400.0):
    rng = np.random.default_rng(seed)
    return (rng.random((batch, n)) * scale).astype(np.float32)


def _mask(seed, batch, n, p=0.1):
    return np.random.default_rng(seed).random((batch, n)) < p


def _assert_result(got, want, ctx=""):
    for f in EXACT:
        g, w = getattr(got, f).cpu().numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and np.array_equal(g, w), f"{ctx}: {f}"
    for f in MEANS:
        np.testing.assert_allclose(getattr(got, f).cpu().numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-6,
                                   err_msg=f"{ctx}: {f}")


def _pair(comp, n=64):
    cfg, jcfg = (CFG, JCFG) if n == 64 else (TeraPoolConfig(n_pes=n),
                                             JConfig(n_pes=n))
    return (barrier.mixed_radix_tree(comp, n_pes=n, cfg=cfg),
            jbarrier.mixed_radix_tree(comp, n_pes=n, cfg=jcfg), cfg, jcfg)


def _placements(sched, jsched, strategies=placement.STRATEGIES):
    out = [(None, None)]
    for s in strategies:
        out.append((placement.place_counters(sched, s, CFG),
                    jplacement.place_counters(jsched, s, JCFG)))
    return out


# ---------------------------------------------------------------------------
# Zero-fault degeneration: the robust cores ARE the plain cores.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("core", ["scan", "telescope"])
def test_zero_faults_degenerate_bitforbit(core):
    arr = torch.from_numpy(_arr(0, 5, 64))
    for comp in COMPS:
        sched, jsched, _, _ = _pair(comp)
        for plc, _ in _placements(sched, jsched):
            plain = barrier_sim.simulate(arr, sched, CFG, placement=plc,
                                         core=core, device="cpu")
            rob = barrier_sim.simulate(arr, sched, CFG, placement=plc,
                                       core=core, faults=barrier.NO_FAULTS,
                                       device="cpu")
            for f in barrier_sim.BarrierResult._fields:
                assert torch.equal(getattr(plain, f), getattr(rob, f)), \
                    (comp, plc and plc.strategy, f)
            assert bool(rob.completed.all())


def test_hw_event_unit_degenerates_too():
    sched = barrier.hw_event_unit(64, cfg=CFG)
    arr = torch.from_numpy(_arr(1, 3, 64))
    for core in ("scan", "telescope"):
        plain = barrier_sim.simulate(arr, sched, CFG, core=core, device="cpu")
        rob = barrier_sim.simulate(arr, sched, CFG, core=core,
                                   faults=barrier.NO_FAULTS, device="cpu")
        for f in barrier_sim.BarrierResult._fields:
            assert torch.equal(getattr(plain, f), getattr(rob, f)), f


# ---------------------------------------------------------------------------
# Faulted episodes against the reference and the numpy oracles.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("core", ["scan", "telescope"])
def test_oracle_bitforbit_n64_compositions_placements(core):
    arr, mask = _arr(2, 4, 64), _mask(3, 4, 64)
    for comp in [(8, 8), (4, 4, 4), (2, 8, 4)]:
        sched, jsched, _, _ = _pair(comp)
        for plc, jplc in _placements(sched, jsched,
                                     ("central", "tile_interleaved")):
            for si, kw in enumerate(SPECS):
                ctx = f"{comp}@{plc and plc.strategy}/spec{si}"
                want = jsim.simulate(arr, jsched, JCFG, placement=jplc,
                                     faults=jbarrier.fault_spec(**kw),
                                     fault_mask=mask)
                got = barrier_sim.simulate(
                    torch.from_numpy(arr), sched, CFG, placement=plc,
                    core=core, faults=barrier.fault_spec(**kw),
                    fault_mask=torch.from_numpy(mask), device="cpu")
                _assert_result(got, want, ctx)
                if core == "scan":
                    oracle = barrier_sim.simulate_robust_reference(
                        arr, sched, CFG, placement=plc,
                        faults=barrier.fault_spec(**kw), fault_mask=mask,
                        device="cpu")
                    _assert_result(oracle, want, "oracle " + ctx)


@pytest.mark.parametrize("n,comp", [(256, (4, 8, 8)), (1024, (8, 8, 16))])
def test_oracle_bitforbit_large_n(n, comp):
    sched, jsched, cfg, jcfg = _pair(comp, n)
    arr, mask = _arr(n, 2, n, scale=600.0), _mask(n + 1, 2, n, p=0.02)
    for kw in (dict(timeout_cycles=500.0, quorum_frac=0.95),
               dict(quorum_frac=0.5)):
        want = jsim.simulate_robust_reference(
            arr, jsched, jcfg, faults=jbarrier.fault_spec(**kw),
            fault_mask=mask)
        oracle = barrier_sim.simulate_robust_reference(
            arr, sched, cfg, faults=barrier.fault_spec(**kw),
            fault_mask=mask, device="cpu")
        _assert_result(oracle, want, f"oracle N={n}")
        for core in ("scan", "telescope"):
            got = barrier_sim.simulate(arr, sched, cfg, core=core,
                                       faults=barrier.fault_spec(**kw),
                                       fault_mask=mask, device="cpu")
            _assert_result(got, want, f"N={n}/{core}")


def test_oracle_bitforbit_central_and_hw():
    arr, mask = _arr(4, 3, 64), _mask(5, 3, 64)
    kw = dict(timeout_cycles=400.0, quorum_frac=0.9)
    for make in ("central_counter", "hw_event_unit"):
        sched = getattr(barrier, make)(64, cfg=CFG)
        jsched = getattr(jbarrier, make)(64, cfg=JCFG)
        want = jsim.simulate_robust_reference(
            arr, jsched, JCFG, faults=jbarrier.fault_spec(**kw),
            fault_mask=mask)
        for core in ("scan", "telescope"):
            got = barrier_sim.simulate(arr, sched, CFG, core=core,
                                       faults=barrier.fault_spec(**kw),
                                       fault_mask=mask, device="cpu")
            _assert_result(got, want, f"{make}/{core}")


def test_batched_tables_and_mask_broadcast():
    """A schedule stack x delay batch under one spec, with one mask
    broadcast over it, equals the per-schedule calls."""
    scheds = [barrier.mixed_radix_tree(c, n_pes=64, cfg=CFG)
              for c in [(8, 8), (4, 4, 4), (64,)]]
    arr = torch.from_numpy(_arr(6, 3, 64))
    mask = torch.from_numpy(_mask(7, 1, 64, p=0.05)[0])
    spec = barrier.fault_spec(timeout_cycles=300.0, quorum_frac=0.9)
    table = barrier.stack_tables(scheds, CFG, device="cpu")
    lifted = barrier.LevelTable(*(f[:, None] for f in table))
    got = barrier_sim.simulate_table(arr, lifted, CFG, faults=spec,
                                     fault_mask=mask)
    for i, sched in enumerate(scheds):
        one = barrier_sim.simulate(arr, sched, CFG, faults=spec,
                                   fault_mask=mask, device="cpu")
        for f in EXACT:
            assert torch.equal(getattr(got, f)[i], getattr(one, f)), f


def test_group_rank_and_timeout_rows():
    gs = torch.tensor([[2, 0, 2, 1, 0, 2], [0, 0, 0, 1, 1, 0]])
    assert barrier_sim._group_rank(gs).tolist() == [[0, 0, 1, 0, 1, 2],
                                                    [0, 1, 2, 0, 1, 3]]
    rows = barrier_sim._timeout_rows(barrier.fault_spec([5.0, 7.0]), 4)
    assert rows.tolist() == [5.0, 7.0, float("inf"), float("inf")]
    assert barrier_sim._timeout_rows(barrier.fault_spec(3.0), 3).tolist() \
        == [3.0] * 3


# ---------------------------------------------------------------------------
# Semantics: watchdog bounds, quorum counts, fail-stop abandonment.
# ---------------------------------------------------------------------------

def _both(arr, comp, core, spec_kw=None, mask=None, central=False):
    if central:
        sched = barrier.central_counter(64, cfg=CFG)
        jsched = jbarrier.central_counter(64, cfg=JCFG)
    else:
        sched, jsched, _, _ = _pair(comp)
    jspec = None if spec_kw is None else jbarrier.fault_spec(**spec_kw)
    tspec = None if spec_kw is None else barrier.fault_spec(**spec_kw)
    want = jsim.simulate(arr, jsched, JCFG, faults=jspec, fault_mask=mask)
    got = barrier_sim.simulate(arr, sched, CFG, core=core, faults=tspec,
                               fault_mask=mask, device="cpu")
    _assert_result(got, want, f"{comp}/{core}/{spec_kw}")
    return got


@pytest.mark.parametrize("core", ["scan", "telescope"])
def test_timeout_bounds_straggler_hold(core):
    arr = np.zeros(64, np.float32)
    arr[17] = 1e6
    slow = _both(arr, (8, 8), core, {})
    fast = _both(arr, (8, 8), core, dict(timeout_cycles=100.0))
    assert slow.exit_time.item() > 1e6
    assert fast.exit_time.item() < 1000.0
    assert fast.abandoned_pes.item() == 1
    assert fast.timed_out_levels.item() >= 1 and bool(fast.completed)


@pytest.mark.parametrize("core", ["scan", "telescope"])
def test_quorum_releases_k_of_n(core):
    arr = np.concatenate([np.zeros(32), np.full(32, 1e5)]).astype(np.float32)
    res = _both(arr, None, core, dict(quorum_frac=0.5), central=True)
    assert res.exit_time.item() < 1e4
    assert res.abandoned_pes.item() == 32
    assert res.timed_out_levels.item() == 0
    full = _both(arr, None, core, {}, central=True)
    assert full.exit_time.item() > 1e5


@pytest.mark.parametrize("core", ["scan", "telescope"])
def test_fail_stop_mask_abandons_and_releases(core):
    arr = np.zeros(64, np.float32)
    mask = np.zeros(64, bool)
    mask[[3, 40, 41]] = True
    res = _both(arr, (8, 8), core, dict(timeout_cycles=50.0), mask)
    assert bool(res.completed) and np.isfinite(res.exit_time.item())
    assert res.abandoned_pes.item() == 3
    hung = _both(arr, (8, 8), core, None, mask)
    assert not np.isfinite(hung.exit_time.item())
    assert not bool(hung.completed)


def test_robust_energy_prices_timeouts_and_abandonment():
    sched, jsched, _, _ = _pair((8, 8))
    arr = np.zeros(64, np.float32)
    arr[17] = 1e6
    res = barrier_sim.simulate(arr, sched, CFG, core="scan",
                               faults=barrier.fault_spec(
                                   timeout_cycles=100.0), device="cpu")
    consts = [torch.tensor(float(c)) for c in
              energy.schedule_energy_constants(sched, None, CFG)]
    base = energy.episode_energy(*consts, 64, res.mean_residency)
    want = (base.item() + 8.0 * res.timed_out_levels.item()
            + 25.0 * res.abandoned_pes.item())
    assert res.energy.item() == pytest.approx(want, rel=1e-6)
    jres = jsim.simulate(arr, jsched, JCFG,
                         faults=jbarrier.fault_spec(timeout_cycles=100.0))
    np.testing.assert_allclose(res.energy.item(), float(jres.energy),
                               rtol=1e-6)


def test_energy_reference_matches_cores_and_jax():
    from repro.core import energy as jenergy
    arr = _arr(8, 3, 64)
    for comp in [(8, 8), (4, 4, 4)]:
        sched, jsched, _, _ = _pair(comp)
        for plc, jplc in _placements(sched, jsched, ("central",)):
            got = energy.energy_reference(arr, sched, CFG, plc, device="cpu")
            want = jenergy.energy_reference(arr, jsched, JCFG, jplc)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6)
            core = barrier_sim.simulate(arr, sched, CFG, placement=plc,
                                        device="cpu").energy
            np.testing.assert_allclose(got.numpy(), core.numpy(), rtol=1e-6)


@pytest.mark.parametrize("kw,match", [
    (dict(timeout_cycles=-1.0), "timeout_cycles"),
    (dict(timeout_cycles=[[1.0]]), "timeout_cycles"),
    (dict(quorum_frac=0.0), "quorum_frac"),
    (dict(quorum_frac=1.5), "quorum_frac")])
def test_fault_spec_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        jbarrier.fault_spec(**kw)
    with pytest.raises(ValueError, match=match):
        barrier.fault_spec(**kw)


def test_fault_spec_values_match_reference():
    for kw in SPECS:
        got, want = barrier.fault_spec(**kw), jbarrier.fault_spec(**kw)
        for f in barrier.FaultSpec._fields:
            g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
            assert g.dtype == w.dtype and np.array_equal(g, w), f


# ---------------------------------------------------------------------------
# Robust sweeps, tail objectives and robust tuning.
# ---------------------------------------------------------------------------

def _keys(seed):
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed, device="cpu")


def test_robust_sweep_grids_bit_exact():
    comps = [(8, 8), (4, 4, 4), (2, 2, 16)]
    tscheds = [barrier.mixed_radix_tree(c, n_pes=64, cfg=CFG) for c in comps]
    jscheds = [jbarrier.mixed_radix_tree(c, n_pes=64, cfg=JCFG)
               for c in comps]
    jk, tk = _keys(11)
    kw = dict(timeout_cycles=200.0, quorum_frac=0.9)
    want = jsweep.sweep_schedules(jk, jscheds, (0.0, 128.0, 512.0),
                                  n_trials=4, cfg=JCFG,
                                  faults=jbarrier.fault_spec(**kw))
    got = sweep.sweep_schedules(tk, tscheds, (0.0, 128.0, 512.0),
                                n_trials=4, cfg=CFG, trial_chunk=3,
                                faults=barrier.fault_spec(**kw), device="cpu")
    _assert_result(got, want, "sweep_schedules")
    np.testing.assert_array_equal(got.completion_rate.numpy(),
                                  np.asarray(want.completion_rate))
    arr = np.where(_mask(12, 4, 64, p=0.05), np.float32(np.inf),
                   _arr(13, 4, 64))[None]
    kw = dict(quorum_frac=0.8)
    want = jsweep.sweep_arrivals(arr, jscheds, JCFG,
                                 faults=jbarrier.fault_spec(**kw))
    got = sweep.sweep_arrivals(torch.from_numpy(arr), tscheds, CFG,
                               faults=barrier.fault_spec(**kw))
    _assert_result(got, want, "sweep_arrivals")
    np.testing.assert_array_equal(got.completion_rate.numpy(),
                                  np.asarray(want.completion_rate))


def test_tail_objectives_select_and_order():
    jk, tk = _keys(11)
    tres = tuning.tune_barrier(tk, 64, delays=(256.0,), n_trials=16,
                               cfg=CFG, prune="hierarchy")
    jres = jtuning.tune_barrier(jk, 64, delays=(256.0,), n_trials=16,
                                cfg=JCFG, prune="hierarchy")
    mean = tres.span_cycles.mean(dim=-1).numpy()
    for obj in ("p99_cycles", "worst_cycles", "completion"):
        grid = tuning._objective_grid(tres, obj)
        assert grid.shape == mean.shape
        np.testing.assert_array_equal(
            grid, np.asarray(jtuning._objective_grid(jres, obj)), obj)
    assert float(np.max(tuning._objective_grid(tres, "completion"))) == 0.0
    p99 = tuning._objective_grid(tres, "p99_cycles")
    worst = tuning._objective_grid(tres, "worst_cycles")
    assert np.all(mean <= p99 + 1e-3) and np.all(p99 <= worst + 1e-3)
    with pytest.raises(ValueError, match="unknown objective"):
        tuning._objective_grid(tres, "p50")
    assert [s.name for s in tuning.pareto_schedules(
        tres, ("p99_cycles", "completion"))] == [
        s.name for s in jtuning.pareto_schedules(
            jres, ("p99_cycles", "completion"))]


def test_percentile_lower_with_hung_trials():
    """The p99 pick is the same order statistic as the reference's
    ``percentile(..., method="lower")`` when some spans are +inf."""
    jk, tk = _keys(3)
    spans = np.array(jax.random.uniform(jk, (5, 2, 200)), np.float32)
    spans[0, 0, :3] = np.inf
    spans[1, 1, :] = np.inf
    res = type("R", (), {"span_cycles": torch.from_numpy(spans)})()
    got = tuning._objective_grid(res, "p99_cycles")
    want = jnp.percentile(jnp.asarray(spans), 99.0, axis=-1, method="lower")
    np.testing.assert_array_equal(got, np.asarray(want))


def test_robust_tuning_beats_latency_winner_on_p99_under_faults():
    jk, tk = _keys(11)
    common = dict(n_trials=16, prune="hierarchy")
    model = dict(p_fail=0.02, p_straggler=0.1, straggler_scale=2000.0)
    kw = dict(timeout_cycles=1500.0, quorum_frac=0.95)
    clean = tuning.sweep_workloads(tk, ("dotp_1Mi",), 64, cfg=CFG, **common)
    faulted = tuning.sweep_workloads(
        tk, ("dotp_1Mi",), 64, cfg=CFG, faults=barrier.fault_spec(**kw),
        fault_model=workloads.PEFaultModel(**model), **common)
    jfaulted = jtuning.sweep_workloads(
        jk, ("dotp_1Mi",), 64, cfg=JCFG, faults=jbarrier.fault_spec(**kw),
        fault_model=jworkloads.PEFaultModel(**model), **common)
    _assert_result(faulted, jfaulted, "faulted sweep_workloads")
    assert clean.schedules == faulted.schedules
    lat_i = int(np.argmin(tuning._objective_grid(clean, "cycles")[:, 0]))
    p99 = tuning._objective_grid(faulted, "p99_cycles")[:, 0]
    rob_i = int(np.argmin(p99))
    assert p99[rob_i] <= p99[lat_i]
    assert faulted.abandoned_pes.max().item() > 0
    assert faulted.completion_rate.min().item() < 1.0
    same = tuning.sweep_workloads(tk, ("dotp_1Mi",), 64, cfg=CFG,
                                  fault_model=workloads.NO_PE_FAULTS,
                                  **common)
    assert torch.equal(same.span_cycles, clean.span_cycles)
    # The tail-tuned pick through tune_for_arrivals is the grid's argmin.
    arrivals = workloads.apply_faults(
        prng.fold_in(tk, 1), workloads.arrival_batch(tk, "dotp_1Mi", (16, 64),
                                                     cfg=CFG),
        workloads.PEFaultModel(**model))
    sched, _, _ = tuning.tune_for_arrivals(
        arrivals, CFG, prune="hierarchy", objective="p99_cycles",
        faults=barrier.fault_spec(**kw))
    res = sweep.sweep_arrivals(arrivals, tuning.all_schedules(
        64, CFG, prune="hierarchy"), CFG, faults=barrier.fault_spec(**kw))
    assert sched == res.schedules[int(np.argmin(
        tuning._objective_grid(res, "p99_cycles")[:, 0]))]


# ---------------------------------------------------------------------------
# 5G under PE loss.
# ---------------------------------------------------------------------------

FIVEG_COLUMNS = ("sync_fraction", "sync_energy", "energy_fraction")


@pytest.mark.parametrize("sync", ["central", "tree", "partial", "hw"])
def test_fiveg_faults_mode_bit_exact(sync):
    japp = jfiveg.FiveGConfig(n_rx=16, ffts_per_round=1)
    tapp = fiveg.FiveGConfig(n_rx=16, ffts_per_round=1)
    jk, tk = _keys(5)
    for kw in (dict(fail_rate=0.02, timeout_cycles=2000.0, seed=3),
               dict(fail_rate=0.05, timeout_cycles=1000.0,
                    quorum_frac=0.9, seed=4)):
        want = jfiveg.simulate_app(jk, japp, sync=sync, radix=32,
                                   faults=jfiveg.FiveGFaults(**kw))
        got = fiveg.simulate_app(tk, tapp, sync=sync, radix=32,
                                 faults=fiveg.FiveGFaults(**kw),
                                 device="cpu")
        for c in ("total_cycles", "completion_rate", "timed_out_levels"):
            assert np.float32(getattr(got, c).item()) == np.float32(
                getattr(want, c)), (kw, c)
        for c in FIVEG_COLUMNS:
            np.testing.assert_allclose(getattr(got, c).item(),
                                       float(getattr(want, c)), rtol=1e-5,
                                       err_msg=c)


def test_fiveg_faults_degenerate_and_validate():
    app = fiveg.FiveGConfig(n_rx=16, ffts_per_round=1)
    key = prng.PRNGKey(5, device="cpu")
    plain = fiveg.simulate_app(key, app, sync="tree", core="scan",
                               device="cpu")
    rob0 = fiveg.simulate_app(
        key, app, sync="tree", core="scan",
        faults=fiveg.FiveGFaults(fail_rate=0.0, timeout_cycles=float("inf")),
        device="cpu")
    assert plain.total_cycles.item() == rob0.total_cycles.item()
    assert rob0.completion_rate.item() == 1.0
    with pytest.raises(ValueError, match="fail_rate"):
        fiveg.FiveGFaults(fail_rate=1.5)


def test_degradation_curve_matches_reference():
    japp = jfiveg.FiveGConfig(n_rx=16, ffts_per_round=1)
    tapp = fiveg.FiveGConfig(n_rx=16, ffts_per_round=1)
    jk, tk = _keys(0)
    rates = (0.0, 0.01, 0.05)
    want = jfiveg.degradation_curve(jk, rates, japp, core="scan")
    got = fiveg.degradation_curve(tk, rates, tapp, core="telescope",
                                  device="cpu")
    assert got["fail_rates"] == want["fail_rates"]
    for mode in ("central", "tree", "hw"):
        for g, w in zip(got[mode], want[mode]):
            for c in ("total_cycles", "completion_rate", "timed_out_levels"):
                assert np.float32(getattr(g, c).item()) == np.float32(
                    getattr(w, c)), (mode, c)
