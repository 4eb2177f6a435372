"""The port's runtime primitives against the reference's
(``tests/test_runtime.py`` case for case, on the CPU): the elastic
arithmetic, the fault-tolerant runner's watchdog and restart from
checkpoint, the supervisor's backoff and history, the checkpoint store's
robustness and the fault plan's validation.  Checkpoints written by
either package restore in the other."""
import os
import time
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jcheckpoint
from repro.runtime import elastic as jelastic
from repro.runtime import fault as jfault
from repro_torch import checkpoint
from repro_torch.runtime import elastic
from repro_torch.runtime.fault import (FaultConfig, FaultTolerantRunner,
                                       StragglerAbort, backoff_delay,
                                       supervise)


# ---------------------------------------------------------------------------
# elastic.viable_mesh_shape / viable_schedule_devices edge cases.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", [
    (7, 2, 1), (6, 4, 1), (4, 4, 1), (8, 2, 4), (3, 4, 1), (7, 2, 4),
    (16, 8, 1), (1, 1, 1)])
def test_viable_mesh_shape_matches_reference(args):
    n, mp, md = args
    assert elastic.viable_mesh_shape(n, model_parallel=mp, min_data=md) == \
        jelastic.viable_mesh_shape(n, model_parallel=mp, min_data=md)


def test_viable_mesh_shape_non_power_of_two_survivors():
    assert elastic.viable_mesh_shape(7, model_parallel=2) == (2, 2)
    assert elastic.viable_mesh_shape(6, model_parallel=4) == (1, 4)


def test_viable_mesh_shape_exactly_minimum():
    assert elastic.viable_mesh_shape(4, model_parallel=4) == (1, 4)
    assert elastic.viable_mesh_shape(8, model_parallel=2,
                                     min_data=4) == (4, 2)


def test_viable_mesh_shape_insufficient():
    assert elastic.viable_mesh_shape(3, model_parallel=4) is None
    assert elastic.viable_mesh_shape(7, model_parallel=2,
                                     min_data=4) is None


def test_viable_schedule_devices_divisibility():
    devs = [torch.device("cuda", i) for i in range(8)]
    assert elastic.viable_schedule_devices(devs, 128) == tuple(devs)
    assert elastic.viable_schedule_devices(devs[:6], 128) == tuple(devs[:4])
    assert elastic.viable_schedule_devices(devs[:6], 127) == (devs[0],)


def test_viable_schedule_devices_minimum_and_insufficient():
    devs = list(range(4))
    assert elastic.viable_schedule_devices(devs, 128,
                                           min_devices=4) == (0, 1, 2, 3)
    assert elastic.viable_schedule_devices(devs[:3], 128,
                                           min_devices=4) is None
    assert elastic.viable_schedule_devices(devs, 126,
                                           min_devices=4) is None
    with pytest.raises(ValueError, match="non-empty schedule axis"):
        elastic.viable_schedule_devices(devs, 0)


@pytest.mark.parametrize("n_dev", range(1, 9))
@pytest.mark.parametrize("n_sched", [1, 6, 127, 128])
def test_viable_schedule_devices_matches_reference(n_dev, n_sched):
    devs = list(range(n_dev))
    for floor in (1, 2, 4):
        assert elastic.viable_schedule_devices(
            devs, n_sched, min_devices=floor) == \
            jelastic.viable_schedule_devices(devs, n_sched,
                                             min_devices=floor)


@pytest.mark.parametrize("n_dev", range(1, 9))
def test_viable_grid_devices_matches_reference(n_dev):
    devs = list(range(n_dev))
    for n_sched, n_kern in ((128, 2), (3, 4), (7, 6), (1, 15)):
        for floor in (1, 3):
            assert elastic.viable_grid_devices(
                devs, n_sched, n_kern, min_devices=floor) == \
                jelastic.viable_grid_devices(devs, n_sched, n_kern,
                                             min_devices=floor)
    with pytest.raises(ValueError, match="kernel axis"):
        elastic.viable_grid_devices(devs, 4, 0)


def test_viable_grid_devices_no_survivor():
    """No survivor is never viable in the port (the reference returns an
    empty device tuple there and carries on)."""
    assert elastic.viable_grid_devices([], 4, 2) is None


def test_rescale_batch_keeps_per_device_constant():
    assert elastic.rescale_batch(64, old_data=8, new_data=6) == 48
    assert elastic.rescale_batch(64, 8, 6) == jelastic.rescale_batch(64, 8, 6)


def test_make_elastic_mesh_waits_for_the_multidevice_slice():
    with pytest.raises(NotImplementedError, match="item 5"):
        elastic.make_elastic_mesh(model_parallel=1)


# ---------------------------------------------------------------------------
# backoff_delay: exponential, jitter-capped, deterministic.
# ---------------------------------------------------------------------------

def test_backoff_delay_grows_and_caps():
    delays = [backoff_delay(k, base=0.1, cap=5.0, jitter=0.0)
              for k in range(10)]
    assert delays[0] == pytest.approx(0.1)
    assert all(b >= a for a, b in zip(delays, delays[1:]))
    assert delays[-1] == 5.0


def test_backoff_delay_jitter_bounded_and_deterministic():
    for k in range(6):
        raw = min(5.0, 0.1 * 2 ** k)
        d = backoff_delay(k, base=0.1, cap=5.0, jitter=0.25)
        assert raw <= d <= min(5.0, raw * 1.25)
        assert d == backoff_delay(k, base=0.1, cap=5.0, jitter=0.25)


def test_backoff_delay_equals_reference():
    for k in range(12):
        for jitter in (0.0, 0.25, 2.0):
            assert backoff_delay(k, base=0.05, cap=3.0, jitter=jitter) == \
                jfault.backoff_delay(k, base=0.05, cap=3.0, jitter=jitter)


# ---------------------------------------------------------------------------
# FaultTolerantRunner: watchdog + restart-resumes-from-checkpoint.
# ---------------------------------------------------------------------------

def _counter_runner(tmp_path, *, failures=None, ckpt_every=2,
                    executed=None):
    """A runner whose state counts executed steps; a step in
    ``failures`` (a mutable set) raises once to simulate a fault."""
    cfg = FaultConfig(ckpt_dir=str(tmp_path / "ckpt"),
                      ckpt_every=ckpt_every,
                      backoff_base=0.0, backoff_cap=0.0)

    def step_fn(state, batch):
        if failures is not None and batch in failures:
            failures.remove(batch)
            raise RuntimeError(f"node fault at step {batch}")
        if executed is not None:
            executed.append(batch)
        return state + 1, {"step": batch}

    return FaultTolerantRunner(cfg, step_fn=step_fn, batch_fn=lambda s: s,
                               state_template=0)


def test_runner_restart_resumes_from_checkpoint(tmp_path):
    executed = []
    failures = {3}
    make = lambda: _counter_runner(tmp_path, failures=failures,
                                   executed=executed)
    state = supervise(make, 6, make().cfg, sleep=lambda s: None)
    assert executed == [0, 1, 2, 2, 3, 4, 5]
    assert state == 2 + 4


def test_runner_tensor_state_resumes_bit_for_bit(tmp_path):
    """A tensor state (the port's leaf) through a fault: the supervised
    run ends where an uninterrupted one does."""
    def make(failures):
        cfg = FaultConfig(ckpt_dir=str(tmp_path / f"ckpt{len(failures)}"),
                          ckpt_every=2, backoff_base=0.0, backoff_cap=0.0)

        def step_fn(state, batch):
            if batch in failures:
                failures.remove(batch)
                raise RuntimeError("fault")
            return {"w": state["w"] * 1.5 + batch}, {}

        return lambda: FaultTolerantRunner(
            cfg, step_fn=step_fn, batch_fn=lambda s: float(s),
            state_template={"w": torch.ones(3, dtype=torch.float32)})

    clean = supervise(make(set()), 7, FaultConfig(), sleep=lambda s: None)
    faulty = supervise(make({4}), 7, FaultConfig(), sleep=lambda s: None)
    assert torch.equal(clean["w"], faulty["w"])


def test_supervise_carries_history_and_backs_off(tmp_path):
    sleeps = []
    failures = {3}
    holder = []

    def make_and_keep():
        r = _counter_runner(tmp_path, failures=failures)
        holder.append(r)
        return r

    cfg = FaultConfig(ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=2,
                      backoff_base=0.5, backoff_cap=2.0,
                      backoff_jitter=0.25)
    supervise(make_and_keep, 6, cfg, sleep=sleeps.append)
    assert sleeps == [backoff_delay(0, base=0.5, cap=2.0, jitter=0.25)]
    assert [s.step for s in holder[-1].history] == [0, 1, 2, 2, 3, 4, 5]


def test_supervise_gives_up_after_max_restarts(tmp_path):
    cfg = FaultConfig(ckpt_dir=str(tmp_path / "ckpt"), max_restarts=2,
                      backoff_base=0.0, backoff_cap=0.0)

    def make():
        return FaultTolerantRunner(
            cfg, step_fn=lambda s, b: (_ for _ in ()).throw(
                RuntimeError("always down")),
            batch_fn=lambda s: s, state_template=0)

    with pytest.raises(RuntimeError, match="giving up after 2"):
        supervise(make, 4, cfg, sleep=lambda s: None)


def test_straggler_watchdog_triggers():
    cfg = FaultConfig(straggler_factor=3.0, max_stragglers=2)
    runner = FaultTolerantRunner(cfg, step_fn=lambda s, b: (s, {}),
                                 batch_fn=lambda s: s, state_template=0)
    for _ in range(8):
        runner._watch(0.01)
    runner._watch(1.0)
    with pytest.raises(StragglerAbort, match="2 consecutive"):
        runner._watch(1.0)


def test_straggler_watchdog_resets_on_fast_step():
    cfg = FaultConfig(straggler_factor=3.0, max_stragglers=2)
    runner = FaultTolerantRunner(cfg, step_fn=lambda s, b: (s, {}),
                                 batch_fn=lambda s: s, state_template=0)
    for _ in range(8):
        runner._watch(0.01)
    runner._watch(1.0)
    runner._watch(0.01)
    runner._watch(1.0)
    assert runner._slow == 1


# ---------------------------------------------------------------------------
# checkpoint store robustness: corrupt manifests + stale .tmp pruning.
# ---------------------------------------------------------------------------

def test_latest_step_skips_truncated_manifest(tmp_path):
    checkpoint.save(tmp_path, 3, {"w": 1.5})
    checkpoint.save(tmp_path, 7, {"w": 2.5})
    (tmp_path / "step_00000007" / "manifest.json").write_text(
        '{"step": 7, "keys": ["w"')
    assert checkpoint.latest_step(tmp_path) == 3
    (tmp_path / "step_00000007" / "manifest.json").write_bytes(
        b"\xff\xfe not json")
    assert checkpoint.latest_step(tmp_path) == 3
    (tmp_path / "step_00000007" / "manifest.json").write_text("[1, 2]")
    assert checkpoint.latest_step(tmp_path) == 3


def test_prune_drops_stale_tmp_dirs(tmp_path):
    checkpoint.save(tmp_path, 1, {"w": 1.0})
    stale = tmp_path / "step_00000009.tmp"
    fresh = tmp_path / "step_00000010.tmp"
    stale.mkdir()
    fresh.mkdir()
    old = time.time() - 7200
    os.utime(stale, (old, old))
    checkpoint.prune(tmp_path, keep=3)
    assert not stale.exists()
    assert fresh.exists()
    assert (tmp_path / "step_00000001").exists()


def test_prune_keeps_newest_complete(tmp_path):
    for s in (1, 2, 3, 4):
        checkpoint.save(tmp_path, s, {"w": float(s)})
    checkpoint.prune(tmp_path, keep=2)
    left = sorted(d.name for d in tmp_path.iterdir())
    assert left == ["step_00000003", "step_00000004"]


class _Pair(NamedTuple):
    a: object
    b: object


def _tree(seed: int):
    """A nested state of the kinds both packages hold: dicts, a
    NamedTuple, a list, float32 / int32 / bool arrays and a scalar."""
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.standard_normal((3, 5)).astype(np.float32),
                       "b": rng.standard_normal(5).astype(np.float32)},
            "opt": _Pair(a=rng.integers(-9, 9, (4,)).astype(np.int32),
                         b=[rng.random(2) > 0.5,
                            np.float32(rng.standard_normal())]),
            "step": np.int32(seed)}


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, _Pair):
        return _Pair(*map(_as_torch, tree))
    if isinstance(tree, list):
        return [_as_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _as_jax(tree):
    if isinstance(tree, dict):
        return {k: _as_jax(v) for k, v in tree.items()}
    if isinstance(tree, _Pair):
        return _Pair(*map(_as_jax, tree))
    if isinstance(tree, list):
        return [_as_jax(v) for v in tree]
    return jnp.asarray(tree)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]


def test_checkpoint_roundtrip_keeps_structure_dtype_and_bits(tmp_path):
    tree = _as_torch(_tree(1))
    tree["params"]["h"] = torch.tensor([1.5, -2.25], dtype=torch.bfloat16)
    checkpoint.save(tmp_path, 5, tree, extra={"note": "x"})
    template = _as_torch(_tree(2))
    template["params"]["h"] = torch.zeros(2, dtype=torch.bfloat16)
    got, manifest = checkpoint.restore(tmp_path, template)
    assert manifest["step"] == 5 and manifest["extra"] == {"note": "x"}
    assert isinstance(got["opt"], _Pair) and isinstance(got["opt"].b, list)
    assert got["params"]["h"].dtype == torch.bfloat16
    assert torch.equal(got["params"]["h"], tree["params"]["h"])
    del got["params"]["h"], tree["params"]["h"]
    for g, w in zip(_leaves(got), _leaves(tree)):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_checkpoint_restores_across_the_two_packages(tmp_path):
    """The port restores what the JAX package saved and the JAX package
    what the port saved: same keys, same bits."""
    want = _tree(3)
    jcheckpoint.save(tmp_path / "jax", 2, _as_jax(want))
    got, _ = checkpoint.restore(tmp_path / "jax", _as_torch(_tree(4)))
    for g, w in zip(_leaves(got), _leaves(want)):
        assert np.array_equal(g, w)
    checkpoint.save(tmp_path / "torch", 6, _as_torch(want))
    assert jcheckpoint.latest_step(tmp_path / "torch") == 6
    got, _ = jcheckpoint.restore(tmp_path / "torch", _as_jax(_tree(4)))
    for g, w in zip(_leaves(got), _leaves(want)):
        assert np.array_equal(g, w)


def test_checkpoint_restore_missing_key_raises(tmp_path):
    checkpoint.save(tmp_path, 0, {"w": torch.zeros(2)})
    with pytest.raises(ValueError, match="missing keys"):
        checkpoint.restore(tmp_path, {"w": torch.zeros(2),
                                      "v": torch.zeros(2)})
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(tmp_path / "none", {"w": torch.zeros(2)})


# ---------------------------------------------------------------------------
# FaultPlan construction-time validation.
# ---------------------------------------------------------------------------

def test_fault_plan_valid_plans_construct():
    from repro_torch.runtime.inject import (DeviceLoss, FaultPlan,
                                            Preemption, SimulatedOOM)
    plan = FaultPlan(faults={0: SimulatedOOM(), 3: DeviceLoss(2),
                             7: Preemption()},
                     straggle={1: 0.25, 2: 0.0})
    assert not plan.exhausted
    with pytest.raises(SimulatedOOM):
        plan.at_chunk(0)
    plan.at_chunk(0)
    assert plan.straggle_seconds(1) == 0.25
    assert plan.straggle_seconds(1) == 0.0


def test_fault_plan_rejects_bad_chunk_indices():
    from repro_torch.runtime.inject import FaultPlan, SimulatedOOM
    with pytest.raises(ValueError, match=">= 0"):
        FaultPlan(faults={-1: SimulatedOOM()})
    with pytest.raises(ValueError, match="int"):
        FaultPlan(faults={"2": SimulatedOOM()})
    with pytest.raises(ValueError, match="int"):
        FaultPlan(faults={True: SimulatedOOM()})
    with pytest.raises(ValueError, match=">= 0"):
        FaultPlan(straggle={-3: 1.0})


def test_fault_plan_rejects_unknown_fault_kinds():
    from repro.runtime.inject import SimulatedOOM as JaxOOM
    from repro_torch.runtime.inject import FaultPlan
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultPlan(faults={0: RuntimeError("not a simulated fault")})
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultPlan(faults={0: "oom"})
    # the reference's fault classes are not the port's
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultPlan(faults={0: JaxOOM()})


def test_fault_plan_rejects_duplicate_fire_points():
    from repro_torch.runtime.inject import (DeviceLoss, FaultPlan,
                                            SimulatedOOM)
    shared = SimulatedOOM()
    with pytest.raises(ValueError, match="duplicate fire point"):
        FaultPlan(faults={0: shared, 2: shared})
    FaultPlan(faults={0: SimulatedOOM(), 2: SimulatedOOM()})
    FaultPlan(faults={0: DeviceLoss(1), 1: DeviceLoss(1)})


def test_fault_plan_rejects_bad_straggle_seconds():
    from repro_torch.runtime.inject import FaultPlan
    for bad in (float("inf"), float("nan"), -0.5):
        with pytest.raises(ValueError, match="finite"):
            FaultPlan(straggle={0: bad})
