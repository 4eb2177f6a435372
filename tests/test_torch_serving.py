"""The port's tuning-serving daemon against the reference's
(``tests/test_serving.py`` case for case, 64 PEs on the CPU): batched
dispatch is bit for bit the unbatched sweep, dedup is idempotent,
admission control rejects with retry-after, deadlines degrade down the
labelled three-tier ladder, the circuit breaker trips and recovers
through probes, DeviceLoss / straggler faults mid-batch lose no request,
shutdown drains or checkpoints the queue, and the 5G client mode
resolves its schedules through the server exactly as the inline tuner
would.  Then parity with the JAX package on the same inputs: the
closed-form fallback, request keys, kernel-request arrival draws,
exact-tier winners, a parked ``queue.json`` restored across packages,
and the 5G client mode against the JAX package's inline tuning."""
import threading

import jax
import numpy as np
import pytest
import torch

from repro.core import fiveg as jfiveg
from repro.core import topology as jtopology
from repro.runtime import serving as jserving
from repro_torch.core import barrier, fiveg, prng, sweep, tuning, workloads
from repro_torch.core.fiveg import FiveGConfig
from repro_torch.core.placement import STRATEGIES
from repro_torch.core.topology import TeraPoolConfig
from repro_torch.runtime import (DeviceLoss, FaultPlan, ResilienceConfig,
                                 SimulatedOOM, schedule_cache)
from repro_torch.runtime import serving as tserving
from repro_torch.runtime.serving import (BATCHED, CACHE_HIT, DEGRADED,
                                         ServerClosed, ServerConfig,
                                         ServerOverloaded, TIER_CACHE,
                                         TIER_EXACT, TIER_FALLBACK,
                                         TuneRequest, TuningServer,
                                         _analytic_span, fallback_uniform)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CFG = TeraPoolConfig(n_pes=64)
JCFG = jtopology.TeraPoolConfig(n_pes=64)
CPU = torch.device("cpu")
OBJECTIVES = ("cycles", "energy", "edp", "pareto")


def _cfg(**kw):
    kw.setdefault("batch_window", 0.01)
    return ServerConfig(**kw)


def _server(config, **kw):
    return TuningServer(config, device="cpu", **kw)


def _trace(i, trials=4, scale=300.0):
    """A (trials, 64) float32 arrival trace made from seed ``i``."""
    rng = np.random.default_rng(i)
    return (scale * rng.random((trials, 64), dtype=np.float32)).astype(
        np.float32)


def _nosleep(_):
    pass


@pytest.fixture
def cache_env(tmp_path, monkeypatch):
    monkeypatch.setenv(schedule_cache.CACHE_ENV, str(tmp_path / "cache"))
    schedule_cache.reset_stats()
    yield tmp_path / "cache"
    schedule_cache.reset_stats()


def _np(t):
    return t.cpu().numpy()


# ---------------------------------------------------------------------------
# Request validation and the closed-form fallback tier.
# ---------------------------------------------------------------------------

def test_request_validation():
    srv = _server(_cfg(), start=False)
    with pytest.raises(ValueError, match="exactly one"):
        srv.submit(TuneRequest())
    with pytest.raises(ValueError, match="exactly one"):
        srv.submit(TuneRequest(kernel="dotp_1Mi", arrivals=_trace(0)))
    with pytest.raises(ValueError, match="unknown kernel"):
        srv.submit(TuneRequest(kernel="nonesuch", cfg=CFG))
    with pytest.raises(ValueError, match="unknown objective"):
        srv.submit(TuneRequest(kernel="dotp_1Mi", cfg=CFG,
                               objective="watts"))
    with pytest.raises(ValueError, match="arrivals must be"):
        srv.submit(TuneRequest(arrivals=np.zeros((2, 2, 2), np.float32)))
    with pytest.raises(ValueError, match="n_pes=32"):
        srv.submit(TuneRequest(arrivals=_trace(0), n_pes=32))
    srv.close()


def test_fallback_uniform_objectives():
    points = {obj: fallback_uniform(64, CFG, obj) for obj in OBJECTIVES}
    for sched, sp, en in points.values():
        assert sched.n_pes == 64 and sp > 0 and en > 0
    # the cycles pick minimizes the analytic span over every radix
    spans = [_analytic_span(barrier.kary_tree(k, 64, CFG), CFG)
             for k in barrier.all_radices(64, CFG)]
    assert points["cycles"][1] == min(spans)
    with pytest.raises(ValueError, match="unknown objective"):
        fallback_uniform(64, CFG, "watts")
    # prime N: the central counter is the only uniform tree
    sched, _, _ = fallback_uniform(7, TeraPoolConfig(n_pes=7), "cycles")
    assert sched.sizes == (7,)


def test_knee_point():
    mk = lambda sp, en: tuning.ParetoPoint(None, None, "p", sp, en)
    front = [mk(10.0, 100.0), mk(12.0, 40.0), mk(30.0, 30.0)]
    # (12, 40) is closest to the normalized utopia corner
    assert tuning.knee_point(front).mean_span == 12.0
    assert tuning.knee_point([mk(5.0, 5.0)]).mean_span == 5.0
    with pytest.raises(ValueError):
        tuning.knee_point([])


def test_split_kernels_bit_for_bit():
    scheds = tuning.all_schedules(64, CFG)
    stack = np.stack([_trace(0), _trace(1)])
    batched = sweep.sweep_arrivals(stack, scheds, CFG, kernels=("a", "b"))
    parts = sweep.split_kernels(batched)
    assert [p.kernels for p in parts] == [("a",), ("b",)]
    for j, part in enumerate(parts):
        solo = sweep.sweep_arrivals(stack[j], scheds, CFG,
                                    kernels=(batched.kernels[j],))
        for field in ("exit_time", "span_cycles", "energy",
                      "mean_residency"):
            np.testing.assert_array_equal(
                _np(getattr(part, field)), _np(getattr(solo, field)),
                err_msg=field)


# ---------------------------------------------------------------------------
# The happy path: exact batched answers, memoized second hits.
# ---------------------------------------------------------------------------

def test_exact_then_cache_hit():
    with _server(_cfg()) as srv:
        req = TuneRequest(kernel="dotp_1Mi", n_pes=64, cfg=CFG)
        r1 = srv.tune(req, timeout=300)
        assert (r1.provenance, r1.tier) == (BATCHED, TIER_EXACT)
        assert r1.schedule is not None and r1.mean_span > 0
        assert r1.result is not None and r1.batch_size == 1
        r2 = srv.tune(TuneRequest(kernel="dotp_1Mi", n_pes=64, cfg=CFG),
                      timeout=60)
        assert (r2.provenance, r2.tier) == (CACHE_HIT, TIER_CACHE)
        assert r2.name == r1.name
        assert srv.stats.batches == 1 and srv.stats.cache_hits == 1


def test_batched_equals_unbatched_bit_for_bit():
    """Three compatible trace requests fuse into ONE dispatch whose
    per-request slices — and winners — are bit for bit what unbatched
    sweep_arrivals / tune_for_arrivals produce."""
    traces = [_trace(i) for i in range(3)]
    srv = _server(_cfg(batch_window=0.05), start=False)
    tickets = [srv.submit(TuneRequest(arrivals=t)) for t in traces]
    srv.start()
    resps = [t.result(timeout=300) for t in tickets]
    srv.close()
    scheds = tuning.all_schedules(64, CFG, prune="none")
    for trace, resp in zip(traces, resps):
        assert (resp.provenance, resp.tier) == (BATCHED, TIER_EXACT)
        assert resp.batch_size == 3
        base = sweep.sweep_arrivals(trace, scheds, CFG)
        for field in ("exit_time", "span_cycles", "energy"):
            np.testing.assert_array_equal(
                _np(getattr(resp.result, field)), _np(getattr(base, field)),
                err_msg=field)
        want_sched, want_plc, want_span = tuning.tune_for_arrivals(
            torch.from_numpy(trace), CFG, prune="none")
        assert resp.schedule == want_sched and resp.placement == want_plc
        assert resp.mean_span == want_span
    assert srv.stats.batches == 1 and srv.stats.batch_requests == 3
    assert srv.stats.batch_efficiency == 3.0


def test_mixed_objectives_share_one_dispatch():
    trace = _trace(9)
    srv = _server(_cfg(batch_window=0.05), start=False)
    tickets = {obj: srv.submit(TuneRequest(arrivals=trace, objective=obj))
               for obj in ("cycles", "energy", "pareto")}
    srv.start()
    resps = {obj: t.result(timeout=300) for obj, t in tickets.items()}
    srv.close()
    assert srv.stats.batches == 1
    scheds = tuning.all_schedules(64, CFG, prune="none")
    res = sweep.sweep_arrivals(trace, scheds, CFG)
    sp = _np(res.mean_span)[:, 0]
    en = _np(res.mean_energy)[:, 0]
    assert resps["cycles"].name == res.names[int(np.argmin(sp))]
    assert resps["energy"].name == res.names[int(np.argmin(en))]
    knee = tuning.knee_point(tuning.pareto_front(res))
    assert resps["pareto"].name == knee.name
    # the knee never spends more energy than the pure-cycles winner
    assert resps["pareto"].mean_energy <= resps["cycles"].mean_energy


def test_dedup_is_idempotent():
    srv = _server(_cfg(), start=False)
    req = lambda: TuneRequest(kernel="conv2d_256x256", n_pes=64, cfg=CFG)
    t1, t2 = srv.submit(req()), srv.submit(req())
    assert t1 is not t2
    srv.start()
    r1, r2 = t1.result(timeout=300), t2.result(timeout=300)
    srv.close()
    assert r1 is r2                       # one pending, one shared answer
    assert r1.provenance == BATCHED
    assert srv.stats.deduped == 1 and srv.stats.batches == 1


# ---------------------------------------------------------------------------
# Admission control, deadlines, the degradation ladder.
# ---------------------------------------------------------------------------

def test_queue_overflow_rejects_with_retry_after():
    srv = _server(_cfg(queue_depth=2), start=False)
    t1 = srv.submit(TuneRequest(arrivals=_trace(0)))
    srv.submit(TuneRequest(arrivals=_trace(1)))
    with pytest.raises(ServerOverloaded) as exc:
        srv.submit(TuneRequest(arrivals=_trace(2)))
    assert exc.value.retry_after > 0
    assert srv.stats.rejected == 1 and srv.stats.accepted == 2
    # the accepted requests are NOT lost: they drain exactly
    srv.start()
    assert t1.result(timeout=300).provenance == BATCHED
    srv.close()


def test_expired_deadline_degrades_to_fallback():
    with _server(_cfg()) as srv:
        resp = srv.tune(TuneRequest(arrivals=_trace(3), deadline=0.0),
                        timeout=60)
    assert (resp.provenance, resp.tier) == (DEGRADED, TIER_FALLBACK)
    assert "deadline" in resp.detail
    want, sp, en = fallback_uniform(64, CFG, "cycles")
    assert resp.schedule == want
    assert (resp.mean_span, resp.mean_energy) == (sp, en)
    assert srv.stats.degraded == 1 and srv.stats.batches == 0


def test_degrade_ladder_prefers_cache_over_fallback(cache_env):
    # warm the persistent cache with an exact answer...
    with _server(_cfg()) as srv:
        exact = srv.tune(TuneRequest(kernel="dotp_1Mi", n_pes=64, cfg=CFG),
                         timeout=300)
    # ...then a FRESH server (cold memo) degrades the same request into
    # the cache tier, not the closed-form tier.
    srv2 = _server(_cfg(), start=False)
    pending = srv2._normalize(
        TuneRequest(kernel="dotp_1Mi", n_pes=64, cfg=CFG))
    srv2._degrade(pending, "test-forced degrade")
    resp = pending.tickets[0].result(timeout=10)
    srv2.close()
    assert (resp.provenance, resp.tier) == (DEGRADED, TIER_CACHE)
    assert resp.name == exact.name
    assert "test-forced degrade" in resp.detail


# ---------------------------------------------------------------------------
# Faults: retry with backoff, circuit breaker, resilient dispatch.
# ---------------------------------------------------------------------------

def test_batch_retry_after_transient_fault():
    plan = FaultPlan(faults={0: SimulatedOOM()})
    cfg = _cfg(max_batch_retries=2, backoff_base=0.0, backoff_cap=0.0)
    with _server(cfg, fault_plan=plan, sleep=_nosleep) as srv:
        resp = srv.tune(TuneRequest(arrivals=_trace(4)), timeout=300)
    assert resp.provenance == BATCHED      # the retry succeeded
    assert plan.exhausted
    assert srv.stats.faults.get("SimulatedOOM") == 1
    assert srv.stats.batch_failures == 1


def test_circuit_breaker_trips_then_probes_closed():
    plan = FaultPlan(faults={0: SimulatedOOM(), 1: SimulatedOOM()})
    cfg = _cfg(max_batch_retries=0, breaker_threshold=1,
               breaker_probe_after=0.0, backoff_base=0.0, backoff_cap=0.0)
    with _server(cfg, fault_plan=plan, sleep=_nosleep) as srv:
        r1 = srv.tune(TuneRequest(arrivals=_trace(5)), timeout=300)
        assert r1.provenance == DEGRADED and r1.tier == TIER_FALLBACK
        assert srv.breaker_state != "closed"   # tripped (probe-ready)
        # probe batch: fails again -> still degraded, breaker re-opens
        r2 = srv.tune(TuneRequest(arrivals=_trace(6)), timeout=300)
        assert r2.provenance == DEGRADED
        # next probe succeeds -> breaker closes, exact service resumes
        r3 = srv.tune(TuneRequest(arrivals=_trace(7)), timeout=300)
        assert r3.provenance == BATCHED
        assert srv.breaker_state == "closed"
    assert srv.stats.faults.get("SimulatedOOM") == 2


def test_deviceloss_and_straggler_midbatch_no_request_lost(tmp_path):
    """DeviceLoss mid-batch (the resilient layer shrinks the device list
    to the survivor and resumes from the chunk store) plus an injected
    straggler abort — every request still answered EXACTLY, bit for bit
    with the plain unbatched sweep.  The port refuses to sweep on zero
    surviving devices, so the server lists two (the reference's single
    default device survives an empty device tuple)."""
    rcfg = ResilienceConfig(ckpt_dir=str(tmp_path / "chunks"),
                            trial_chunk=1, backoff_base=0.0,
                            backoff_cap=0.0, straggler_factor=2.0,
                            straggler_floor=0.0)
    # 8 trials / trial_chunk=1 -> 8 chunks: DeviceLoss at chunk 1, a
    # 1e6 s straggler at chunk 5 (the watchdog needs >= 3 baseline
    # chunk durations before it can call anything a straggler).
    plan = FaultPlan(faults={1: DeviceLoss(1)}, straggle={5: 1e6})
    cfg = _cfg(batch_window=0.05, max_batch_retries=3, backoff_base=0.0,
               backoff_cap=0.0, resilience=rcfg,
               ckpt_dir=str(tmp_path / "srv"))
    traces = [_trace(10, trials=8), _trace(11, trials=8)]
    srv = _server(cfg, fault_plan=plan, sleep=_nosleep, start=False,
                  devices=[CPU, CPU])
    tickets = [srv.submit(TuneRequest(arrivals=t)) for t in traces]
    srv.start()
    resps = [t.result(timeout=600) for t in tickets]
    srv.close()
    scheds = tuning.all_schedules(64, CFG, prune="none")
    for trace, resp in zip(traces, resps):
        assert (resp.provenance, resp.tier) == (BATCHED, TIER_EXACT)
        base = sweep.sweep_arrivals(trace, scheds, CFG)
        np.testing.assert_array_equal(_np(resp.result.span_cycles),
                                      _np(base.span_cycles))
    assert srv.stats.faults.get("DeviceLoss", 0) >= 1
    assert srv.stats.faults.get("StragglerAbort", 0) >= 1
    assert plan.exhausted


# ---------------------------------------------------------------------------
# Shutdown: drain and checkpoint/restore.
# ---------------------------------------------------------------------------

def test_close_drains_pending_requests():
    srv = _server(_cfg(), start=False)
    tickets = [srv.submit(TuneRequest(arrivals=_trace(i)))
               for i in range(12, 15)]
    srv.close(drain=True)                  # answers everything first
    for t in tickets:
        assert t.done()
        assert t.result().provenance == BATCHED
    with pytest.raises(ServerClosed):
        srv.submit(TuneRequest(arrivals=_trace(15)))


def test_shutdown_checkpoints_queue_and_restart_restores(tmp_path):
    root = str(tmp_path / "srv")
    srv = _server(_cfg(ckpt_dir=root), start=False)
    t1 = srv.submit(TuneRequest(kernel="dotp_1Mi", n_pes=64, cfg=CFG))
    t2 = srv.submit(TuneRequest(arrivals=_trace(16), objective="energy"))
    srv.close(drain=False)
    # parked tickets were answered through the ladder, not dropped
    for t in (t1, t2):
        resp = t.result(timeout=10)
        assert resp.provenance == DEGRADED and resp.tier == TIER_FALLBACK
        assert "checkpointed" in resp.detail
    assert (tmp_path / "srv" / "queue.json").exists()
    # a restarted server re-enqueues and answers them exactly
    srv2 = _server(_cfg(ckpt_dir=root), start=False)
    assert srv2.stats.restored == 2
    assert not (tmp_path / "srv" / "queue.json").exists()
    srv2.start()
    srv2.flush(timeout=600)
    # the replay warmed the server cache: the same request is now a hit
    r = srv2.tune(TuneRequest(kernel="dotp_1Mi", n_pes=64, cfg=CFG),
                  timeout=60)
    srv2.close()
    assert (r.provenance, r.tier) == (CACHE_HIT, TIER_CACHE)
    assert srv2.stats.batches >= 1


# ---------------------------------------------------------------------------
# The 5G client mode and sync="pareto".
# ---------------------------------------------------------------------------

def test_fiveg_client_mode_matches_inline_tuning():
    app = FiveGConfig()
    fiveg._epoch_tuned_schedules.cache_clear()
    want = fiveg._epoch_tuned_schedules(app, CFG, "cycles", "cpu")
    with _server(_cfg(batch_window=0.05)) as srv:
        with fiveg.tuning_server(srv):
            got = fiveg._served_schedules(app, CFG, "cycles")
        # stage + global coalesced into ONE batched dispatch
        assert srv.stats.batches == 1 and srv.stats.batch_requests == 2
    assert [s.sizes for s in (got[0], got[2])] == \
        [s.sizes for s in (want[0], want[2])]
    assert (got[1], got[3]) == (want[1], want[3])


def test_fiveg_client_mode_simulates_identically():
    app = FiveGConfig()
    key = prng.PRNGKey(3, device="cpu")
    base = fiveg.simulate_app(key, app, sync="workload", cfg=CFG,
                              device="cpu")
    with _server(_cfg(batch_window=0.05)) as srv:
        with fiveg.tuning_server(srv):
            served = fiveg.simulate_app(key, app, sync="workload", cfg=CFG,
                                        device="cpu")
    assert served.stage_schedule == base.stage_schedule
    assert served.global_schedule == base.global_schedule
    np.testing.assert_array_equal(_np(served.total_cycles),
                                  _np(base.total_cycles))
    np.testing.assert_array_equal(_np(served.sync_energy),
                                  _np(base.sync_energy))


def test_sync_pareto_picks_the_knee():
    app = FiveGConfig()
    fiveg._epoch_tuned_schedules.cache_clear()
    res = fiveg.simulate_app(prng.PRNGKey(4, device="cpu"), app,
                             sync="pareto", cfg=CFG, device="cpu")
    assert float(res.total_cycles) > 0
    # the stage pick IS the knee of the 2-D front on the stage model
    stage_arr, _ = fiveg._epoch_arrival_models(app, CFG, "cpu")
    scheds, placs = tuning._cross_placements(
        tuning.all_schedules(64, CFG, prune="none"), STRATEGIES, CFG)
    grid = sweep.sweep_arrivals(stage_arr, scheds, CFG, placements=placs)
    knee = tuning.knee_point(tuning.pareto_front(grid))
    assert res.stage_schedule == knee.name
    # the knee is never more energy-hungry than the best-by-cycles end
    front = tuning.pareto_front(grid)
    assert knee.mean_energy <= front[0].mean_energy


def test_circuit_breaker_half_open_probe_under_concurrent_submits():
    """The half-open race: while the breaker is probe-ready, several
    clients submit CONCURRENTLY.  max_batch=1 serializes them through
    the single worker, so exactly ONE request becomes the (failing)
    probe batch and is degraded; the next becomes the successful probe,
    and every later request is served exactly.  No wedged thread, the
    breaker closed at the end."""
    plan = FaultPlan(faults={0: SimulatedOOM(), 1: SimulatedOOM()})
    cfg = _cfg(max_batch_retries=0, breaker_threshold=1,
               breaker_probe_after=0.0, backoff_base=0.0,
               backoff_cap=0.0, max_batch=1)
    with _server(cfg, fault_plan=plan, sleep=_nosleep) as srv:
        r0 = srv.tune(TuneRequest(arrivals=_trace(20)), timeout=300)
        assert r0.provenance == DEGRADED and r0.tier == TIER_FALLBACK
        assert srv.breaker_state != "closed"

        resps = [None] * 4

        def client(j):
            resps[j] = srv.tune(TuneRequest(arrivals=_trace(21 + j)),
                                timeout=300)
        threads = [threading.Thread(target=client, args=(j,))
                   for j in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive(), "wedged client thread"

        provs = sorted(r.provenance for r in resps)
        assert provs == [BATCHED, BATCHED, BATCHED, DEGRADED], provs
        assert all(r.ok for r in resps if r.provenance == BATCHED)
        assert srv.breaker_state == "closed"
        assert srv._breaker_failures == 0
    assert srv.stats.faults.get("SimulatedOOM") == 2


# ---------------------------------------------------------------------------
# Port-only: the device and the device list.
# ---------------------------------------------------------------------------

def test_plain_dispatch_over_several_devices_is_not_ported():
    with pytest.raises(NotImplementedError, match="queue 1 item 2"):
        _server(_cfg(), start=False, devices=[CPU, CPU])
    srv = _server(_cfg(), start=False, devices=[CPU])
    srv.close()


def test_trace_on_a_device_tensor_equals_the_numpy_trace():
    """A tensor trace and its numpy copy are one request: the same key,
    so the second is deduplicated."""
    srv = _server(_cfg(), start=False)
    trace = _trace(30)
    t1 = srv.submit(TuneRequest(arrivals=trace))
    t2 = srv.submit(TuneRequest(arrivals=torch.from_numpy(trace.copy())))
    srv.close()
    assert srv.stats.deduped == 1 and t1.result() is t2.result()


# ---------------------------------------------------------------------------
# Parity with the JAX package on the same inputs.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", (16, 64, 256, 1024))
def test_fallback_uniform_matches_jax(n):
    cfg, jcfg = TeraPoolConfig(n_pes=n), jtopology.TeraPoolConfig(n_pes=n)
    for obj in OBJECTIVES:
        sched, sp, en = fallback_uniform(n, cfg, obj)
        jsched, jsp, jen = jserving.fallback_uniform(n, jcfg, obj)
        assert (sched.sizes, sp, en) == (jsched.sizes, jsp, jen), obj


@pytest.mark.parametrize("make", [
    lambda m, c: m.TuneRequest(kernel="dotp_1Mi", n_pes=64, cfg=c),
    lambda m, c: m.TuneRequest(arrivals=_trace(40), objective="pareto",
                               placements=("central", "interleaved")),
    lambda m, c: m.TuneRequest(arrivals=_trace(41, trials=2), cfg=c,
                               prune="none", core="scan", objective="edp"),
], ids=["kernel", "trace_placed", "trace_scan"])
def test_request_key_matches_jax(make):
    """``request_key`` of a normalized request: the same tuple (trace
    digests included) in both packages."""
    def key(module, cfg, **kw):
        srv = module.TuningServer(module.ServerConfig(), start=False, **kw)
        pending = srv._normalize(make(module, cfg))
        srv.close()
        return pending.key
    assert key(tserving, CFG, device="cpu") == key(jserving, JCFG)


@pytest.mark.parametrize("kernel", workloads.ARRIVAL_KERNELS)
def test_kernel_request_arrivals_match_jax(kernel):
    srv = _server(_cfg(), start=False)
    got = srv._normalize(TuneRequest(kernel=kernel, n_pes=64, cfg=CFG))
    jsrv = jserving.TuningServer(jserving.ServerConfig(), start=False)
    want = jsrv._normalize(jserving.TuneRequest(kernel=kernel, n_pes=64,
                                                cfg=JCFG))
    np.testing.assert_array_equal(_np(got.arrivals), want.arrivals)
    assert got.label == want.label and got.group == want.group


def test_serving_key_matches_jax():
    for kernel in ("dotp_1Mi", "straggler_pareto"):
        want = jax.random.fold_in(jax.random.PRNGKey(907),
                                  jserving._kernel_fold(kernel))
        np.testing.assert_array_equal(
            _np(tserving._kernel_key(kernel, "cpu")).astype(np.uint32),
            np.asarray(want))


def _serve_batch(module, reqs, **kw):
    srv = module.TuningServer(module.ServerConfig(batch_window=0.01),
                              start=False, **kw)
    tickets = [srv.submit(r) for r in reqs]
    srv.start()
    out = [t.result(timeout=600) for t in tickets]
    srv.close()
    return out, srv.stats


def test_exact_tier_winners_match_jax():
    """One coalesced batch of kernel and trace requests under every
    objective in each package: the winners' names and mean spans bit for
    bit, mean energies to rtol 1e-6 (torch and XLA sum in other orders,
    ROADMAP queue 3)."""
    def reqs(m, c):
        out = [m.TuneRequest(kernel=k, n_pes=64, cfg=c, n_trials=4,
                             objective=o)
               for k in ("dotp_1Mi", "fiveg_fft_stage", "straggler_pareto")
               for o in OBJECTIVES]
        return out + [m.TuneRequest(arrivals=_trace(50), cfg=c,
                                    objective=o) for o in OBJECTIVES]
    got, stats = _serve_batch(tserving, reqs(tserving, CFG), device="cpu")
    want, jstats = _serve_batch(jserving, reqs(jserving, JCFG))
    assert stats.batches == jstats.batches == 1
    for g, w in zip(got, want):
        assert (g.provenance, g.tier, g.batch_size) == (
            w.provenance, w.tier, w.batch_size) == (BATCHED, TIER_EXACT, 16)
        assert (g.name, g.mean_span) == (w.name, w.mean_span)
        np.testing.assert_allclose(g.mean_energy, w.mean_energy, rtol=1e-6)


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_parked_queue_restores_across_packages(tmp_path, direction):
    """A queue parked by one package's server is re-enqueued and answered
    exactly by the other's, with the same keys."""
    src, dst = ((jserving, tserving) if direction == "jax_to_torch"
                else (tserving, jserving))
    kw = {jserving: {}, tserving: {"device": "cpu"}}
    cfgs = {jserving: JCFG, tserving: CFG}
    root = str(tmp_path / "srv")
    srv = src.TuningServer(src.ServerConfig(ckpt_dir=root), start=False,
                           **kw[src])
    parked = [srv.submit(src.TuneRequest(kernel="dotp_1Mi", n_pes=64,
                                         cfg=cfgs[src])),
              srv.submit(src.TuneRequest(arrivals=_trace(60),
                                         objective="energy", priority=2))]
    keys = [p.key for p in srv._queue]
    srv.close(drain=False)
    assert all(t.result(10).tier == TIER_FALLBACK for t in parked)
    srv2 = dst.TuningServer(dst.ServerConfig(ckpt_dir=root,
                                             batch_window=0.01),
                            start=False, **kw[dst])
    assert srv2.stats.restored == 2
    assert [p.key for p in srv2._queue] == keys
    srv2.start()
    srv2.flush(timeout=600)
    srv2.close()
    assert srv2.stats.exact == 2 and srv2.stats.degraded == 0


@pytest.mark.parametrize("sync", ["workload", "pareto"])
def test_fiveg_client_mode_matches_jax_inline(sync):
    """``simulate_app`` through the port's server equals the JAX
    package's inline tuned run: the picks by name, the cycles bit for
    bit, the summed barrier energy to rtol 1e-5 per pipeline."""
    app = FiveGConfig()
    with _server(_cfg(batch_window=0.05)) as srv:
        with fiveg.tuning_server(srv):
            got = fiveg.simulate_app(prng.PRNGKey(5, device="cpu"), app,
                                     sync=sync, cfg=CFG, device="cpu")
        assert srv.stats.batches == 1
    want = jfiveg.simulate_app(jax.random.PRNGKey(5), jfiveg.FiveGConfig(),
                               sync=sync, cfg=JCFG)
    assert (got.stage_schedule, got.global_schedule) == (
        want.stage_schedule, want.global_schedule)
    np.testing.assert_array_equal(_np(got.total_cycles),
                                  np.asarray(want.total_cycles))
    np.testing.assert_allclose(_np(got.sync_energy),
                               np.asarray(want.sync_energy), rtol=1e-5)
