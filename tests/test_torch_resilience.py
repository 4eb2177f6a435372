"""The port's resilient sweeps and schedule cache against the reference's
(``tests/test_resilience.py`` case for case, on the CPU): a kill at any
chunk boundary and a resume give the uninterrupted sweep bit for bit,
and the JAX package's sweep too; fault injection fires once; the
supervisor retries with capped backoff; the straggler watchdog restarts
slow chunks; a chunk store written by either package resumes in the
other; the persistent schedule cache serves hits across processes and
rejects corrupt, truncated, expired and vanished entries.  The
reference's 8-device elastic re-shard
(``test_elastic_reshard_multidevice``) needs the port's device meshes
and waits for them; here a device loss shrinks the device list and the
sweep stays exact."""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import sweep as jsweep
from repro.core import tuning as jtuning
from repro.runtime import FaultPlan as JFaultPlan
from repro.runtime import Preemption as JPreemption
from repro.runtime import ResilienceConfig as JResilienceConfig
from repro.runtime import SimulatedFault as JSimulatedFault
from repro.runtime import resilient_sweep_schedules as jresilient_schedules
from repro.runtime import schedule_cache as jschedule_cache
from repro_torch.core import fiveg, prng, sweep, tuning
from repro_torch.core.topology import TeraPoolConfig
from repro_torch.runtime import (DeviceLoss, FaultPlan, Preemption,
                                 ResilienceConfig, SimulatedFault,
                                 SimulatedOOM, resilient_sweep_arrivals,
                                 resilient_sweep_schedules,
                                 resilient_sweep_workloads,
                                 resilient_tune_barrier, schedule_cache)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

KEY = prng.PRNGKey(0, device="cpu")
JKEY = jax.random.PRNGKey(0)
REPO = Path(__file__).resolve().parent.parent
DELAYS = (0.0, 512.0)
N_TRIALS = 8


def _rcfg(tmp_path, **kw):
    kw.setdefault("trial_chunk", 2)
    kw.setdefault("backoff_base", 0.0)
    kw.setdefault("backoff_cap", 0.0)
    return ResilienceConfig(ckpt_dir=str(tmp_path / "chunks"), **kw)


def _nosleep(_):
    pass


# Columns that are sums over PEs: torch and XLA add in other orders, so
# against the JAX package they hold to rtol 1e-6 (ROADMAP, "reduction
# order, by design"); every other column is bit for bit.
SUMS = ("mean_residency", "energy")


def _assert_same(got, want, across=False):
    """Every field equal: tensors bit for bit (a JAX result's arrays as
    numpy), the rest by value.  ``across``: ``want`` comes from the JAX
    package (or holds its chunks), so :data:`SUMS` hold to rtol 1e-6."""
    for name, a, b in zip(got._fields, got, want):
        if isinstance(a, torch.Tensor):
            b = b.cpu().numpy() if isinstance(b, torch.Tensor) else \
                np.asarray(b)
            if across and name in SUMS:
                np.testing.assert_allclose(a.cpu().numpy(), b, rtol=1e-6,
                                           err_msg=name)
            else:
                np.testing.assert_array_equal(a.cpu().numpy(), b,
                                              err_msg=name)
        elif name == "schedules":
            assert [s.name for s in a] == [s.name for s in b], name
        elif name == "placements":
            assert [p and (p.strategy, p.banks) for p in a] == \
                [p and (p.strategy, p.banks) for p in b], name
        else:
            assert a == b, name


def _arrivals(shape, seed=0):
    return (300.0 * np.random.default_rng(seed).random(shape)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# FaultPlan: deterministic, fire-once.
# ---------------------------------------------------------------------------

def test_fault_plan_fires_once():
    plan = FaultPlan(faults={1: SimulatedOOM()}, straggle={2: 5.0})
    plan.at_chunk(0)
    with pytest.raises(SimulatedOOM):
        plan.at_chunk(1)
    plan.at_chunk(1)
    assert plan.straggle_seconds(2) == 5.0
    assert plan.straggle_seconds(2) == 0.0
    assert plan.exhausted
    assert len(plan.fired) == 2


def test_fault_taxonomy():
    assert Preemption().fatal
    assert not SimulatedOOM().fatal
    assert not DeviceLoss(2).fatal
    assert DeviceLoss(2).n_lost == 2
    with pytest.raises(ValueError):
        DeviceLoss(0)


# ---------------------------------------------------------------------------
# Kill at EVERY chunk boundary, resume: bit-for-bit identical.
# ---------------------------------------------------------------------------

def test_sweep_schedules_kill_resume_every_boundary(tmp_path):
    scheds = tuning.all_schedules(64)
    base = sweep.sweep_schedules(KEY, scheds, DELAYS, N_TRIALS,
                                 device="cpu")
    jax_rep = jresilient_schedules(
        JKEY, jtuning.all_schedules(64), DELAYS, N_TRIALS,
        resilience=JResilienceConfig(ckpt_dir=str(tmp_path / "jax"),
                                     trial_chunk=2),
        sleep=_nosleep)
    n_chunks = N_TRIALS // 2
    for kill_at in range(n_chunks):
        rc = _rcfg(tmp_path / f"kill{kill_at}")
        plan = FaultPlan(faults={kill_at: Preemption()})
        with pytest.raises(SimulatedFault):
            resilient_sweep_schedules(KEY, scheds, DELAYS, N_TRIALS,
                                      resilience=rc, fault_plan=plan,
                                      sleep=_nosleep, device="cpu")
        rep = resilient_sweep_schedules(KEY, scheds, DELAYS, N_TRIALS,
                                        resilience=rc, fault_plan=plan,
                                        sleep=_nosleep, device="cpu")
        _assert_same(rep.result, base)
        _assert_same(rep.result, jax_rep.result, across=True)
        assert rep.chunks_resumed == kill_at
        assert rep.chunks_computed == n_chunks - kill_at
        assert rep.chunks_total == n_chunks


def test_sweep_arrivals_kill_resume(tmp_path):
    scheds = tuning.all_schedules(64)
    arr = _arrivals((2, 6, 64))
    base = sweep.sweep_arrivals(arr, scheds, kernels=("a", "b"))
    jbase = jsweep.sweep_arrivals(arr, jtuning.all_schedules(64),
                                  kernels=("a", "b"))
    rc = _rcfg(tmp_path)
    plan = FaultPlan(faults={2: Preemption()})
    with pytest.raises(SimulatedFault):
        resilient_sweep_arrivals(arr, scheds, kernels=("a", "b"),
                                 resilience=rc, fault_plan=plan,
                                 sleep=_nosleep, device="cpu")
    rep = resilient_sweep_arrivals(arr, scheds, kernels=("a", "b"),
                                   resilience=rc, fault_plan=plan,
                                   sleep=_nosleep, device="cpu")
    _assert_same(rep.result, base)
    _assert_same(rep.result, jbase, across=True)
    assert rep.chunks_resumed == 2 and rep.chunks_computed == 1


def test_chunk_store_resumes_across_the_two_packages(tmp_path):
    """A store the JAX package left after a preemption resumes in the
    port (the run digest and the chunk layout are the reference's), and
    the assembled sweep is the port's plain one: bit for bit but in the
    sums, which the two resumed chunks carry from XLA."""
    jscheds = jtuning.all_schedules(64)[:8]
    jrc = JResilienceConfig(ckpt_dir=str(tmp_path / "chunks"),
                            trial_chunk=2)
    with pytest.raises(JSimulatedFault):
        jresilient_schedules(JKEY, jscheds, DELAYS, N_TRIALS,
                             resilience=jrc,
                             fault_plan=JFaultPlan(
                                 faults={2: JPreemption()}),
                             sleep=_nosleep)
    scheds = tuning.all_schedules(64)[:8]
    rep = resilient_sweep_schedules(KEY, scheds, DELAYS, N_TRIALS,
                                    resilience=_rcfg(tmp_path),
                                    sleep=_nosleep, device="cpu")
    assert rep.chunks_resumed == 2 and rep.chunks_computed == 2
    _assert_same(rep.result, sweep.sweep_schedules(
        KEY, scheds, DELAYS, N_TRIALS, device="cpu"), across=True)


# ---------------------------------------------------------------------------
# In-process supervision: backoff, restart accounting, straggler abort.
# ---------------------------------------------------------------------------

def test_nonfatal_fault_restarts_with_backoff(tmp_path):
    scheds = tuning.all_schedules(64)[:8]
    base = sweep.sweep_schedules(KEY, scheds, DELAYS, N_TRIALS,
                                 device="cpu")
    sleeps = []
    rc = _rcfg(tmp_path, backoff_base=0.5, backoff_cap=2.0)
    plan = FaultPlan(faults={1: SimulatedOOM(), 3: SimulatedOOM()})
    rep = resilient_sweep_schedules(KEY, scheds, DELAYS, N_TRIALS,
                                    resilience=rc, fault_plan=plan,
                                    sleep=sleeps.append, device="cpu")
    _assert_same(rep.result, base)
    assert rep.restarts == 2
    assert len(rep.faults) == 2
    assert len(sleeps) == 2 and sleeps[1] >= sleeps[0] > 0
    assert rep.chunks_computed == N_TRIALS // 2


def test_straggler_watchdog_restarts_chunk(tmp_path):
    scheds = tuning.all_schedules(64)[:8]
    base = sweep.sweep_schedules(KEY, scheds, DELAYS, N_TRIALS,
                                 device="cpu")
    rc = _rcfg(tmp_path, straggler_factor=5.0, straggler_floor=0.0)
    plan = FaultPlan(straggle={3: 3600.0})
    rep = resilient_sweep_schedules(KEY, scheds, DELAYS, N_TRIALS,
                                    resilience=rc, fault_plan=plan,
                                    sleep=_nosleep, device="cpu")
    _assert_same(rep.result, base)
    assert rep.restarts == 1
    assert "chunk took" in rep.faults[0]
    assert plan.exhausted


def test_gives_up_after_max_restarts(tmp_path):
    scheds = tuning.all_schedules(64)[:4]
    rc = _rcfg(tmp_path, max_restarts=1)
    plan = FaultPlan(faults={0: SimulatedOOM(), 1: SimulatedOOM(),
                             2: SimulatedOOM()})
    with pytest.raises(RuntimeError, match="giving up after 1"):
        resilient_sweep_schedules(KEY, scheds, DELAYS, N_TRIALS,
                                  resilience=rc, fault_plan=plan,
                                  sleep=_nosleep, device="cpu")


def test_stale_store_from_different_run_is_wiped(tmp_path):
    scheds = tuning.all_schedules(64)[:4]
    rc = _rcfg(tmp_path)
    resilient_sweep_schedules(KEY, scheds, DELAYS, N_TRIALS, resilience=rc,
                              sleep=_nosleep, device="cpu")
    other = prng.PRNGKey(9, device="cpu")
    base = sweep.sweep_schedules(other, scheds, DELAYS, N_TRIALS,
                                 device="cpu")
    rep2 = resilient_sweep_schedules(other, scheds, DELAYS, N_TRIALS,
                                     resilience=rc, sleep=_nosleep,
                                     device="cpu")
    _assert_same(rep2.result, base)
    assert rep2.chunks_resumed == 0, "stale chunks must not be reused"


def test_corrupt_chunk_checkpoint_is_recomputed(tmp_path):
    scheds = tuning.all_schedules(64)[:4]
    rc = _rcfg(tmp_path)
    base = sweep.sweep_schedules(KEY, scheds, DELAYS, N_TRIALS,
                                 device="cpu")
    resilient_sweep_schedules(KEY, scheds, DELAYS, N_TRIALS, resilience=rc,
                              sleep=_nosleep, device="cpu")
    victim = tmp_path / "chunks" / "step_00000001" / "host_0000.npz"
    victim.write_bytes(victim.read_bytes()[:64])
    rep = resilient_sweep_schedules(KEY, scheds, DELAYS, N_TRIALS,
                                    resilience=rc, sleep=_nosleep,
                                    device="cpu")
    _assert_same(rep.result, base)
    assert rep.chunks_computed == 1 and rep.chunks_resumed == 3


# ---------------------------------------------------------------------------
# Tuner-grid wrappers reproduce their plain counterparts exactly.
# ---------------------------------------------------------------------------

def test_resilient_tune_barrier_matches_plain(tmp_path):
    placs = ("leaf_local", "central")
    base = tuning.tune_barrier(KEY, 64, delays=DELAYS, n_trials=4,
                               placements=placs)
    jbase = jtuning.tune_barrier(JKEY, 64, delays=DELAYS, n_trials=4,
                                 placements=placs)
    plan = FaultPlan(faults={1: SimulatedOOM()})
    rep = resilient_tune_barrier(KEY, 64, delays=DELAYS, n_trials=4,
                                 placements=placs, resilience=_rcfg(tmp_path),
                                 fault_plan=plan, sleep=_nosleep)
    _assert_same(rep.result, base)
    _assert_same(rep.result, jbase, across=True)
    assert rep.result.names == base.names == jbase.names


def test_resilient_sweep_workloads_matches_plain(tmp_path):
    kernels = ("dotp_1Mi", "conv2d_256x256")
    base = tuning.sweep_workloads(KEY, kernels, 64, n_trials=4)
    jbase = jtuning.sweep_workloads(JKEY, kernels, 64, n_trials=4)
    rc = _rcfg(tmp_path)
    plan = FaultPlan(faults={0: Preemption()})
    with pytest.raises(SimulatedFault):
        resilient_sweep_workloads(KEY, kernels, 64, n_trials=4,
                                  resilience=rc, fault_plan=plan,
                                  sleep=_nosleep)
    rep = resilient_sweep_workloads(KEY, kernels, 64, n_trials=4,
                                    resilience=rc, fault_plan=plan,
                                    sleep=_nosleep)
    _assert_same(rep.result, base)
    _assert_same(rep.result, jbase, across=True)
    assert rep.result.kernels == kernels


# ---------------------------------------------------------------------------
# Device loss on the port's device list.
# ---------------------------------------------------------------------------

def test_device_loss_single_device_insufficient(tmp_path):
    scheds = tuning.all_schedules(64)[:4]
    plan = FaultPlan(faults={1: DeviceLoss(1)})
    with pytest.raises(RuntimeError, match="survive"):
        resilient_sweep_schedules(KEY, scheds, DELAYS, N_TRIALS,
                                  resilience=_rcfg(tmp_path, min_devices=2),
                                  fault_plan=plan, sleep=_nosleep,
                                  device="cpu")


def test_device_loss_of_the_only_device_raises(tmp_path):
    """With one device and the default floor, losing it never falls back
    to another device."""
    scheds = tuning.all_schedules(64)[:4]
    with pytest.raises(RuntimeError, match="only 0 device"):
        resilient_sweep_schedules(
            KEY, scheds, DELAYS, N_TRIALS, resilience=_rcfg(tmp_path),
            fault_plan=FaultPlan(faults={1: DeviceLoss(1)}),
            sleep=_nosleep, device="cpu")


def test_device_loss_shrinks_the_device_list(tmp_path):
    """Eight listed devices, 128 schedule points: a DeviceLoss(3)
    leaves five, four of which divide the stack; the sweep goes on and
    stays exact (the port runs every chunk on the first device)."""
    from repro_torch.core import placement
    scheds, placs = tuning._cross_placements(
        tuning.all_schedules(64), placement.STRATEGIES, sweep.DEFAULT)
    base = sweep.sweep_schedules(KEY, scheds, DELAYS, N_TRIALS,
                                 placements=placs, device="cpu")
    devices = [torch.device("cpu")] * 8
    rep = resilient_sweep_schedules(
        KEY, scheds, DELAYS, N_TRIALS, placements=placs,
        resilience=_rcfg(tmp_path),
        fault_plan=FaultPlan(faults={1: DeviceLoss(3)}), devices=devices,
        sleep=_nosleep, device="cpu")
    _assert_same(rep.result, base)
    assert rep.device_history == [8, 4] and rep.restarts == 1
    arr = _arrivals((2, 8, 64), seed=1)
    abase = sweep.sweep_arrivals(arr, scheds, placements=placs)
    arep = resilient_sweep_arrivals(
        arr, scheds, placements=placs, resilience=_rcfg(tmp_path / "arr"),
        fault_plan=FaultPlan(faults={2: DeviceLoss(4)}), devices=devices,
        sleep=_nosleep, device="cpu")
    _assert_same(arep.result, abase)
    assert arep.device_history == [8, 4]


# ---------------------------------------------------------------------------
# Persistent schedule cache: process-level hits, corruption rejection.
# ---------------------------------------------------------------------------

@pytest.fixture
def cache_env(tmp_path, monkeypatch):
    monkeypatch.setenv(schedule_cache.CACHE_ENV, str(tmp_path / "cache"))
    monkeypatch.delenv(schedule_cache.TTL_ENV, raising=False)
    monkeypatch.delenv(schedule_cache.MAX_ENV, raising=False)
    schedule_cache.reset_stats()
    tuning.tuned_for_workload.cache_clear()
    yield tmp_path / "cache"
    tuning.tuned_for_workload.cache_clear()
    schedule_cache.reset_stats()


def _tuned(kernel, n, **kw):
    return tuning.tuned_for_workload(kernel, n, device="cpu", **kw)


def test_schedule_cache_disabled_without_env(monkeypatch):
    monkeypatch.delenv(schedule_cache.CACHE_ENV, raising=False)
    assert schedule_cache.cache_dir() is None
    assert schedule_cache.load(("k",)) is None
    schedule_cache.store(("k",), {"x": 1})


def test_schedule_cache_roundtrip_and_hit(cache_env, monkeypatch):
    sched, plc = _tuned("dotp_1Mi", 64)
    assert schedule_cache.STATS["stores"] == 1
    tuning.tuned_for_workload.cache_clear()
    monkeypatch.setattr(
        tuning, "tune_for_workload",
        lambda *a, **k: pytest.fail("cache hit must not re-sweep"))
    assert _tuned("dotp_1Mi", 64) == (sched, plc)
    assert schedule_cache.STATS["hits"] == 1


def test_schedule_cache_winner_equals_reference(cache_env):
    """What the port stores is the reference's winner, and the payloads
    are the same JSON."""
    got = _tuned("dotp_1Mi", 64, placements=("leaf_local", "central"))
    want = jtuning.tuned_for_workload.__wrapped__(
        "dotp_1Mi", 64, placements=("leaf_local", "central"))
    assert schedule_cache.encode_pair(*got) == \
        jschedule_cache.encode_pair(*want)


def test_schedule_cache_detects_corruption(cache_env):
    placs = ("leaf_local", "central")
    sched, plc = _tuned("dotp_1Mi", 64, placements=placs)
    tuning.tuned_for_workload.cache_clear()
    entry = next(cache_env.glob("*.json"))
    data = json.loads(entry.read_text())
    data["payload"]["schedule"]["sizes"][0] = 999
    entry.write_text(json.dumps(data))
    assert _tuned("dotp_1Mi", 64, placements=placs) == (sched, plc)
    assert schedule_cache.STATS["corrupt"] == 1
    tuning.tuned_for_workload.cache_clear()
    assert _tuned("dotp_1Mi", 64, placements=placs) == (sched, plc)
    assert schedule_cache.STATS["hits"] == 1


def test_schedule_cache_truncated_entry(cache_env):
    sched, plc = _tuned("conv2d_256x256", 64)
    tuning.tuned_for_workload.cache_clear()
    entry = next(cache_env.glob("*.json"))
    entry.write_text(entry.read_text()[:37])
    assert _tuned("conv2d_256x256", 64) == (sched, plc)
    assert schedule_cache.STATS["corrupt"] == 1


def test_schedule_cache_key_separation(cache_env):
    s64, _ = _tuned("dotp_1Mi", 64)
    s256, _ = _tuned("dotp_1Mi", 256)
    assert len(list(cache_env.glob("*.json"))) == 2
    assert s64.n_pes == 64 and s256.n_pes == 256


def test_fiveg_modes_read_through_cache(cache_env, monkeypatch):
    cfg = TeraPoolConfig(n_pes=64)
    sched = fiveg._tuned_schedule(64, 100.0, False, cfg, "cpu")
    pair = fiveg._placed_schedule(64, 100.0, cfg, "cpu")
    fiveg._tuned_schedule.cache_clear()
    fiveg._placed_schedule.cache_clear()
    monkeypatch.setattr(tuning, "best_schedule",
                        lambda *a, **k: pytest.fail("must hit disk"))
    monkeypatch.setattr(tuning, "best_placed_schedule",
                        lambda *a, **k: pytest.fail("must hit disk"))
    try:
        assert fiveg._tuned_schedule(64, 100.0, False, cfg, "cpu") == sched
        assert fiveg._placed_schedule(64, 100.0, cfg, "cpu") == pair
    finally:
        fiveg._tuned_schedule.cache_clear()
        fiveg._placed_schedule.cache_clear()


def test_code_version_is_stable_and_the_ports_own():
    assert schedule_cache.code_version() == schedule_cache.code_version()
    assert len(schedule_cache.code_version()) == 16
    assert schedule_cache.code_version() != jschedule_cache.code_version()


# ---------------------------------------------------------------------------
# Multi-host chunk stores: interleaved ownership over one shared store.
# ---------------------------------------------------------------------------

def test_multihost_config_validates():
    with pytest.raises(ValueError, match="host_count"):
        ResilienceConfig(ckpt_dir="x", host_count=0)
    with pytest.raises(ValueError, match="host_id"):
        ResilienceConfig(ckpt_dir="x", host_id=2, host_count=2)
    with pytest.raises(ValueError, match="host_id"):
        ResilienceConfig(ckpt_dir="x", host_id=-1)


def test_multihost_interleaved_chunks_arrivals(tmp_path):
    scheds = tuning.all_schedules(64)
    arr = _arrivals((2, 8, 64), seed=2)
    base = sweep.sweep_arrivals(arr, scheds, kernels=("a", "b"))
    store = tmp_path / "shared"

    def run(h):
        rc = ResilienceConfig(ckpt_dir=str(store), trial_chunk=2,
                              host_id=h, host_count=2)
        return resilient_sweep_arrivals(arr, scheds, kernels=("a", "b"),
                                        resilience=rc, sleep=_nosleep,
                                        device="cpu")

    with pytest.raises(RuntimeError, match=r"chunk\(s\) \[1, 3\]"):
        run(0)
    assert (store / "step_00000000").exists()
    assert (store / "step_00000002").exists()
    assert not (store / "step_00000001").exists()
    rep1 = run(1)
    _assert_same(rep1.result, base)
    assert rep1.chunks_resumed == 2 and rep1.chunks_computed == 2
    rep0 = run(0)
    _assert_same(rep0.result, base)
    assert rep0.chunks_resumed == 4 and rep0.chunks_computed == 0


def test_multihost_three_way_schedules(tmp_path):
    scheds = tuning.all_schedules(64)[:8]
    base = sweep.sweep_schedules(KEY, scheds, DELAYS, N_TRIALS,
                                 device="cpu")
    store = tmp_path / "shared3"

    def run_host(h):
        rc = ResilienceConfig(ckpt_dir=str(store), trial_chunk=2,
                              host_id=h, host_count=3)
        return resilient_sweep_schedules(KEY, scheds, DELAYS, N_TRIALS,
                                         resilience=rc, sleep=_nosleep,
                                         device="cpu")

    with pytest.raises(RuntimeError, match=r"host 1/3"):
        run_host(1)
    with pytest.raises(RuntimeError, match=r"chunk\(s\) \[0, 3\]"):
        run_host(2)
    rep0 = run_host(0)
    _assert_same(rep0.result, base)
    assert rep0.chunks_computed == 2 and rep0.chunks_resumed == 2


def test_multihost_default_is_single_host(tmp_path):
    rc = _rcfg(tmp_path)
    assert rc.host_id == 0 and rc.host_count == 1
    rep = resilient_sweep_schedules(KEY, tuning.all_schedules(64)[:4],
                                    DELAYS, N_TRIALS, resilience=rc,
                                    sleep=_nosleep, device="cpu")
    assert rep.chunks_computed == N_TRIALS // 2


# ---------------------------------------------------------------------------
# Schedule cache TTL + LRU size-capped eviction.
# ---------------------------------------------------------------------------

def _backdate(path, seconds):
    old = time.time() - seconds
    os.utime(path, (old, old))


def test_schedule_cache_ttl_expires_entries(cache_env, monkeypatch):
    monkeypatch.setenv(schedule_cache.TTL_ENV, "100")
    sched, plc = _tuned("dotp_1Mi", 64)
    tuning.tuned_for_workload.cache_clear()
    _backdate(next(cache_env.glob("*.json")), 1000)
    schedule_cache.reset_stats()
    assert _tuned("dotp_1Mi", 64) == (sched, plc)
    assert schedule_cache.STATS["evictions"] >= 1
    assert schedule_cache.STATS["misses"] == 1
    assert schedule_cache.STATS["stores"] == 1
    tuning.tuned_for_workload.cache_clear()
    assert _tuned("dotp_1Mi", 64) == (sched, plc)
    assert schedule_cache.STATS["hits"] == 1


def test_schedule_cache_lru_size_cap(cache_env, monkeypatch):
    monkeypatch.setenv(schedule_cache.MAX_ENV, "2")
    schedule_cache.store(("k1",), {"v": 1})
    _backdate(schedule_cache._entry_path(cache_env, ("k1",)), 300)
    schedule_cache.store(("k2",), {"v": 2})
    _backdate(schedule_cache._entry_path(cache_env, ("k2",)), 200)
    assert schedule_cache.STATS["evictions"] == 0
    schedule_cache.store(("k3",), {"v": 3})
    assert schedule_cache.STATS["evictions"] == 1
    assert schedule_cache.load(("k1",)) is None
    assert schedule_cache.load(("k2",)) == {"v": 2}
    assert schedule_cache.load(("k3",)) == {"v": 3}
    assert len(list(cache_env.glob("*.json"))) == 2


def test_schedule_cache_hit_touches_lru_clock(cache_env, monkeypatch):
    monkeypatch.setenv(schedule_cache.MAX_ENV, "2")
    schedule_cache.store(("k1",), {"v": 1})
    _backdate(schedule_cache._entry_path(cache_env, ("k1",)), 300)
    schedule_cache.store(("k2",), {"v": 2})
    _backdate(schedule_cache._entry_path(cache_env, ("k2",)), 200)
    assert schedule_cache.load(("k1",)) == {"v": 1}
    schedule_cache.store(("k3",), {"v": 3})
    assert schedule_cache.load(("k2",)) is None
    assert schedule_cache.load(("k1",)) == {"v": 1}
    assert schedule_cache.load(("k3",)) == {"v": 3}


def test_schedule_cache_evict_direct_and_unbounded(cache_env, monkeypatch):
    schedule_cache.store(("a",), {"v": 1})
    schedule_cache.store(("b",), {"v": 2})
    assert schedule_cache.evict() == 0
    assert schedule_cache.STATS["evictions"] == 0
    monkeypatch.setenv(schedule_cache.MAX_ENV, "not-a-number")
    assert schedule_cache.evict() == 0
    assert len(list(cache_env.glob("*.json"))) == 2


# ---------------------------------------------------------------------------
# SweepReport fault ledger: per-class counts + total backoff charged.
# ---------------------------------------------------------------------------

def test_report_ledger_counts_faults_by_class(tmp_path):
    scheds = tuning.all_schedules(64)[:8]
    sleeps = []
    rc = _rcfg(tmp_path, trial_chunk=1, backoff_base=0.25,
               backoff_cap=1.0, straggler_factor=5.0, straggler_floor=0.0)
    plan = FaultPlan(faults={1: SimulatedOOM()}, straggle={5: 3600.0})
    rep = resilient_sweep_schedules(KEY, scheds, DELAYS, N_TRIALS,
                                    resilience=rc, fault_plan=plan,
                                    sleep=sleeps.append, device="cpu")
    assert rep.fault_counts == {"SimulatedOOM": 1, "StragglerAbort": 1}
    assert sum(rep.fault_counts.values()) == len(rep.faults) == 2
    assert rep.backoff_seconds == pytest.approx(sum(sleeps))
    assert rep.backoff_seconds > 0


def test_report_ledger_empty_on_clean_run(tmp_path):
    rep = resilient_sweep_schedules(KEY, tuning.all_schedules(64)[:4],
                                    DELAYS, 4, resilience=_rcfg(tmp_path),
                                    sleep=_nosleep, device="cpu")
    assert rep.fault_counts == {} and rep.backoff_seconds == 0.0


# ---------------------------------------------------------------------------
# Preemption end-to-end: the process dies mid-sweep; a fresh process
# resumes from the chunk store and lands bit for bit on the plain run.
# ---------------------------------------------------------------------------

_PREEMPT_SCRIPT = """
import os
import numpy as np
from repro_torch.core import sweep, tuning
from repro_torch.runtime import (FaultPlan, Preemption, ResilienceConfig,
                                 SimulatedFault, resilient_sweep_arrivals)

tmp = os.environ["RESILIENCE_TMP"]
phase = os.environ["RESILIENCE_PHASE"]
scheds = tuning.all_schedules(64)
arr = (300.0 * np.random.default_rng(0).random((2, 6, 64))).astype(
    np.float32)
rc = ResilienceConfig(ckpt_dir=tmp + "/chunks", trial_chunk=2,
                      backoff_base=0.0, backoff_cap=0.0)
if phase == "A":
    plan = FaultPlan(faults={1: Preemption()})
    try:
        resilient_sweep_arrivals(arr, scheds, kernels=("a", "b"),
                                 resilience=rc, fault_plan=plan,
                                 sleep=lambda s: None, device="cpu")
    except SimulatedFault:
        print("preempted after chunk 0")
        raise SystemExit(17)
    raise SystemExit("preemption never fired")
rep = resilient_sweep_arrivals(arr, scheds, kernels=("a", "b"),
                               resilience=rc, sleep=lambda s: None,
                               device="cpu")
base = sweep.sweep_arrivals(arr, scheds, kernels=("a", "b"))
for f in ("span_cycles", "exit_time", "energy"):
    np.testing.assert_array_equal(getattr(rep.result, f).numpy(),
                                  getattr(base, f).numpy())
assert rep.chunks_resumed == 1 and rep.chunks_computed == 2, rep
print("cross-process resume ok")
"""


def test_preemption_cross_process_resume(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               RESILIENCE_TMP=str(tmp_path), RESILIENCE_PHASE="A")
    a = subprocess.run([sys.executable, "-c", _PREEMPT_SCRIPT], env=env,
                       capture_output=True, text=True, timeout=300)
    assert a.returncode == 17, a.stdout[-3000:] + a.stderr[-3000:]
    assert "preempted after chunk 0" in a.stdout
    assert (tmp_path / "chunks").is_dir()
    env["RESILIENCE_PHASE"] = "B"
    b = subprocess.run([sys.executable, "-c", _PREEMPT_SCRIPT], env=env,
                       capture_output=True, text=True, timeout=300)
    assert b.returncode == 0, b.stdout[-3000:] + b.stderr[-3000:]
    assert "cross-process resume ok" in b.stdout


# ---------------------------------------------------------------------------
# Concurrent cache writers: stress + deterministic vanishing-file races.
# ---------------------------------------------------------------------------

_STRESS_SCRIPT = """
import os
from repro_torch.runtime import schedule_cache

wid = int(os.environ["STRESS_WORKER"])
for i in range(40):
    k = ("stress", (wid + i) % 6)
    schedule_cache.store(k, {"worker": wid, "iter": i})
    schedule_cache.load(k)
    schedule_cache.load(("stress", (wid + i + 1) % 6))
assert schedule_cache.STATS["corrupt"] == 0, schedule_cache.STATS
print("worker", wid, "ok")
"""


def test_schedule_cache_multiprocess_stress(cache_env, monkeypatch):
    """Four writer processes hammer six overlapping keys while the cap
    forces evictions on every store and the parent runs the evictor:
    nobody ever reads a torn entry."""
    monkeypatch.setenv(schedule_cache.MAX_ENV, "3")
    procs = []
    for wid in range(4):
        env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
                   STRESS_WORKER=str(wid))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _STRESS_SCRIPT], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    deadline = time.time() + 300
    while any(p.poll() is None for p in procs) and time.time() < deadline:
        schedule_cache.evict()
        time.sleep(0.01)
    for wid, p in enumerate(procs):
        out, err = p.communicate(timeout=60)
        assert p.returncode == 0, f"worker {wid}:\n{out[-2000:]}{err[-2000:]}"
        assert f"worker {wid} ok" in out
    assert schedule_cache.STATS["corrupt"] == 0


def test_schedule_cache_load_tolerates_vanishing_entry(cache_env,
                                                       monkeypatch):
    schedule_cache.store(("race-load",), {"v": 1})
    real = Path.read_text
    armed = {"on": True}

    def vanish(self, *a, **kw):
        if armed["on"] and self.parent == cache_env:
            armed["on"] = False
            raise FileNotFoundError(str(self))
        return real(self, *a, **kw)

    monkeypatch.setattr(Path, "read_text", vanish)
    assert schedule_cache.load(("race-load",)) is None
    assert schedule_cache.STATS["races"] == 1
    assert schedule_cache.STATS["corrupt"] == 0
    assert schedule_cache.load(("race-load",)) == {"v": 1}


def test_schedule_cache_load_tolerates_vanishing_stat(cache_env,
                                                      monkeypatch):
    monkeypatch.setenv(schedule_cache.TTL_ENV, "3600")
    schedule_cache.store(("race-stat",), {"v": 2})
    real = schedule_cache._expired
    armed = {"on": True}

    def vanish(path, now):
        if armed["on"]:
            armed["on"] = False
            raise FileNotFoundError(str(path))
        return real(path, now)

    monkeypatch.setattr(schedule_cache, "_expired", vanish)
    assert schedule_cache.load(("race-stat",)) is None
    assert schedule_cache.STATS["races"] >= 1
    assert schedule_cache.STATS["corrupt"] == 0
    assert schedule_cache.load(("race-stat",)) == {"v": 2}


def test_schedule_cache_store_tolerates_vanishing_root(cache_env,
                                                       monkeypatch):
    real = os.replace
    armed = {"left": 2}

    def vanish(src, dst):
        if armed["left"] > 0:
            armed["left"] -= 1
            raise FileNotFoundError(dst)
        return real(src, dst)

    monkeypatch.setattr(schedule_cache.os, "replace", vanish)
    schedule_cache.store(("race-store",), {"v": 3})
    assert schedule_cache.STATS["races"] == 2
    assert schedule_cache.STATS["stores"] == 0
    assert not list(cache_env.glob("*.tmp"))
    schedule_cache.store(("race-store",), {"v": 3})
    assert schedule_cache.load(("race-store",)) == {"v": 3}


def test_schedule_cache_evict_tolerates_vanishing_entry(cache_env,
                                                        monkeypatch):
    monkeypatch.setenv(schedule_cache.TTL_ENV, "3600")
    schedule_cache.store(("race-evict", 1), {"v": 1})
    schedule_cache.store(("race-evict", 2), {"v": 2})
    calls = {"n": 0}
    real = schedule_cache._expired

    def vanish_first(path, now):
        calls["n"] += 1
        if calls["n"] == 1:
            raise FileNotFoundError(str(path))
        return real(path, now)

    monkeypatch.setattr(schedule_cache, "_expired", vanish_first)
    assert schedule_cache.evict() == 0
    assert calls["n"] == 2
    assert schedule_cache.STATS["races"] == 1
