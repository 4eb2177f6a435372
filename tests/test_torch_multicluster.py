"""Port parity: multi-cluster machines and non-power-of-two clusters.

Mirrors ``tests/test_multicluster.py`` case for case (its mesh and
sharding cases wait for the port's multi-device slice): the remote
latency tier of ``MultiClusterConfig``, the non-power-of-two schedule
algebra, the multi-cluster composition spaces, the cumulative-quotient
telescope widths, the tail-padding diagnostics and telescope == scan bit
for bit at hierarchical and non-power-of-two compositions x placements.
Every case also holds the port to the JAX package: level tables (every
field, value and dtype), telescope widths, exit times and spans bit for
bit at 768, 1024, 1536, 2048 and 4096 PEs, and tables and widths at
16384.
"""
import dataclasses
import math
import random

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import barrier as jbarrier
from repro.core import barrier_sim as jsim
from repro.core import placement as jplacement
from repro.core import sweep as jsweep
from repro.core import topology as jtopology
from repro.core import tuning as jtuning
from repro_torch.core import (barrier, barrier_sim, placement, prng, sweep,
                              topology, tuning)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

EXACT = ("exit_time", "last_arrival", "span_cycles", "completed")
C768 = topology.TeraPoolConfig(n_pes=768, tiles_per_group=12, n_groups=8)
JC768 = jtopology.TeraPoolConfig(n_pes=768, tiles_per_group=12, n_groups=8)


def _machine(top, name: str):
    """The machine ``name`` built by either package's topology module:
    the reference test's machines and the benchmark's 4-cluster ones."""
    c768 = top.TeraPoolConfig(n_pes=768, tiles_per_group=12, n_groups=8)
    return {
        "768": lambda: c768,
        "1024": lambda: top.TeraPoolConfig(n_pes=1024),
        "1536": lambda: top.multi_cluster(c768, n_clusters=2,
                                          lat_remote=31),
        "2048x2": lambda: top.multi_cluster(top.TeraPoolConfig(n_pes=1024),
                                            n_clusters=2),
        "2048x4": lambda: top.multi_cluster(top.TeraPoolConfig(n_pes=512),
                                            n_clusters=4),
        "4096": lambda: top.multi_cluster(top.TeraPoolConfig(n_pes=1024),
                                          n_clusters=4),
        "16384": lambda: top.multi_cluster(top.TeraPoolConfig(n_pes=4096),
                                           n_clusters=4),
        "256": lambda: top.multi_cluster(top.TeraPoolConfig(n_pes=64),
                                         n_clusters=4),
    }[name]()


def _stack_for(tuning_mod, top, cfg):
    """The reference test's stack: the joint multi-cluster space, every
    k-th entry past 24, or the hierarchy-pruned space of one cluster."""
    if isinstance(cfg, top.MultiClusterConfig):
        scheds = tuning_mod.multicluster_schedules(cfg)
        if len(scheds) > 24:
            scheds = scheds[::max(1, len(scheds) // 24)]
        return scheds
    return tuning_mod.all_schedules(cfg.n_pes, cfg, prune="hierarchy")


def _random_factorization(rng: random.Random, n: int) -> tuple:
    sizes = []
    while n > 1:
        f = rng.choice([d for d in range(2, n + 1) if n % d == 0])
        sizes.append(f)
        n //= f
    return tuple(sizes)


def _assert_tables_equal(jtab, ttab):
    for f in jbarrier.LevelTable._fields:
        want = np.asarray(getattr(jtab, f))
        got = getattr(ttab, f).numpy()
        assert got.dtype == want.dtype, (f, got.dtype, want.dtype)
        assert np.array_equal(got, want), f


def _assert_exact(got, want, ctx):
    for f in EXACT:
        assert np.array_equal(getattr(got, f).numpy(),
                              np.asarray(getattr(want, f))), (ctx, f)


def _assert_bitwise(got, want, ctx):
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), (ctx, f)


def _uniform(seed: int, n: int, scale: float) -> np.ndarray:
    return np.array(scale * jax.random.uniform(jax.random.PRNGKey(seed),
                                               (n,)))


# ---------------------------------------------------------------------------
# MultiClusterConfig: the remote latency tier.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["1536", "2048x4", "4096", "16384"])
def test_multi_cluster_factory_and_shape(name):
    cfg, jcfg = _machine(topology, name), _machine(jtopology, name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.pes_per_cluster, cfg.banks_per_cluster, cfg.n_banks) == (
        jcfg.pes_per_cluster, jcfg.banks_per_cluster, jcfg.n_banks)
    if name == "4096":
        assert (cfg.n_pes, cfg.pes_per_cluster, cfg.banks_per_cluster,
                cfg.n_banks) == (4096, 1024, 4096, 16384)
        assert cfg.pes_per_tile == 8 and cfg.lat_tile == 1


def test_multi_cluster_nonpow2_cluster():
    cfg = topology.multi_cluster(C768, n_clusters=2, lat_remote=31)
    assert (cfg.n_pes, cfg.pes_per_cluster, cfg.lat_remote) == (1536, 768,
                                                                31)


@pytest.mark.parametrize("kwargs,match", [
    (dict(n_pes=1024, n_clusters=0), "cluster"),
    (dict(n_pes=1000, n_clusters=3), "split")])
def test_multi_cluster_config_validates(kwargs, match):
    with pytest.raises(ValueError, match=match):
        topology.MultiClusterConfig(**kwargs)
    with pytest.raises(ValueError, match=match):
        jtopology.MultiClusterConfig(**kwargs)


_MC = _machine(topology, "4096")


@pytest.mark.parametrize("method,args,want", [
    ("span_bank_latency", (0, 8, 0), _MC.lat_tile),
    ("span_bank_latency", (0, 128, 0), _MC.lat_group),
    ("span_bank_latency", (0, 1024, 0), _MC.lat_cluster),
    ("span_bank_latency", (0, 2048, 0), _MC.lat_remote),
    ("pe_bank_latency", (1024, 0), _MC.lat_remote),
    ("pe_bank_latency", (0, _MC.banks_per_cluster), _MC.lat_remote),
    ("span_bank_latency", (1024, 8, _MC.banks_per_cluster), _MC.lat_tile),
    ("access_latency", (_MC.n_pes,), _MC.lat_remote),
    ("access_latency", (1024,), _MC.lat_cluster)])
def test_remote_latency_classes(method, args, want):
    jcfg = _machine(jtopology, "4096")
    assert getattr(_MC, method)(*args) == want
    assert getattr(jcfg, method)(*args) == want


# ---------------------------------------------------------------------------
# Non-power-of-two schedule algebra and the multi-cluster spaces.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("radix,sizes", [(8, (12, 8, 8)),
                                         (4, (3, 4, 4, 4, 4))])
def test_kary_tree_nonpow2(radix, sizes):
    s = barrier.kary_tree(radix, n_pes=768, cfg=C768)
    assert s.sizes == sizes and math.prod(s.sizes) == 768
    js = jbarrier.kary_tree(radix, n_pes=768, cfg=JC768)
    assert [(l.group_size, l.span, l.latency) for l in s.levels] == [
        (l.group_size, l.span, l.latency) for l in js.levels]
    with pytest.raises(ValueError, match="does not divide"):
        barrier.kary_tree(7, n_pes=768, cfg=C768)


@pytest.mark.parametrize("radix,n,sizes", [(8, 1024, (2, 8, 8, 8)),
                                           (4, 64, (4, 4, 4)),
                                           (1024, 1024, (1024,))])
def test_kary_tree_pow2_unchanged(radix, n, sizes):
    assert barrier.kary_tree(radix, n_pes=n).sizes == sizes
    assert jbarrier.kary_tree(radix, n_pes=n).sizes == sizes


def test_all_radices_nonpow2():
    assert barrier.all_radices(768, C768) == \
        [k for k in range(2, 769) if 768 % k == 0] == \
        jbarrier.all_radices(768, JC768)
    assert barrier.all_radices(64) == [2, 4, 8, 16, 32, 64]


@pytest.mark.parametrize("n", [12, 768, 1536])
def test_enumerate_compositions_nonpow2(n):
    comps = tuning.enumerate_compositions(n)
    assert comps == jtuning.enumerate_compositions(n)
    assert all(math.prod(c) == n for c in comps)
    assert len(set(comps)) == len(comps)
    if n == 12:
        assert {(2, 2, 3), (12,), (3, 4)} <= set(comps)
    with pytest.raises(ValueError, match=">= 2"):
        tuning.enumerate_compositions(1)


@pytest.mark.parametrize("name,n,segments", [
    ("768", 768, [8, 12, 8]), ("4096", 4096, [8, 16, 8, 4]),
    ("4096", 1024, [8, 16, 8]), ("1536", 1536, [8, 12, 8, 2]),
    ("16384", 16384, [8, 16, 32, 4])])
def test_hierarchy_compositions_nonpow2_and_multicluster(name, n, segments):
    cfg, jcfg = _machine(topology, name), _machine(jtopology, name)
    assert tuning._hier_segments(n, cfg) == segments
    assert jtuning._hier_segments(n, jcfg) == segments
    if n <= 4096:
        comps = tuning.hierarchy_compositions(n, cfg)
        assert comps == jtuning.hierarchy_compositions(n, jcfg)
        assert all(math.prod(c) == n for c in comps)


@pytest.mark.parametrize("name", ["256", "1536", "2048x4", "4096", "16384"])
def test_multicluster_schedule_space(name):
    """The joint space, in the reference's order: compositions as tuples,
    schedules by name, every one over the whole machine."""
    cfg, jcfg = _machine(topology, name), _machine(jtopology, name)
    comps = tuning.multicluster_compositions(cfg)
    assert comps == jtuning.multicluster_compositions(jcfg)
    assert all(math.prod(c) == cfg.n_pes for c in comps)
    intra = tuning.hierarchy_compositions(cfg.pes_per_cluster, cfg)
    inter = tuning.enumerate_compositions(cfg.n_clusters, cfg)
    assert len(comps) == len(intra) * len(inter)
    scheds = tuning.multicluster_schedules(cfg, partial=name == "256")
    jscheds = jtuning.multicluster_schedules(jcfg, partial=name == "256")
    assert [s.name for s in scheds] == [s.name for s in jscheds]
    assert [barrier.describe(s) for s in scheds[:8]] == [
        jbarrier.describe(s) for s in jscheds[:8]]
    assert all(s.n_pes == cfg.n_pes for s in scheds)
    seg = [(8, 8)]
    assert tuning.multicluster_compositions(cfg, intra=seg, inter=[(2,)]) \
        == jtuning.multicluster_compositions(jcfg, intra=seg, inter=[(2,)]) \
        == [(8, 8, 2)]


def test_mixed_radix_tree_nonpow2_levels():
    s = barrier.mixed_radix_tree((12, 8, 8), n_pes=768, cfg=C768)
    assert [l.group_size for l in s.levels] == [12, 8, 8]
    assert [l.span for l in s.levels] == [12, 96, 768]


# ---------------------------------------------------------------------------
# Generalized telescope widths.
# ---------------------------------------------------------------------------

def test_telescope_widths_cumulative_quotient():
    cfg = _machine(topology, "4096")
    t = barrier.level_table(barrier.mixed_radix_tree((8, 16, 8, 4),
                                                     cfg=cfg),
                            cfg=cfg, device="cpu")
    w = barrier.telescope_widths(t, 4096)
    assert w[:4] == (4096, 4096 // 8, 4096 // 128, 4096 // 1024)
    assert all(x == 1 for x in w[4:])
    assert all(a >= b for a, b in zip(w, w[1:]))
    assert sum(w) < sum(barrier.default_widths(4096, len(w) - 1))
    jcfg = _machine(jtopology, "4096")
    jt = jbarrier.level_table(jbarrier.mixed_radix_tree((8, 16, 8, 4),
                                                        cfg=jcfg), cfg=jcfg)
    _assert_tables_equal(jt, t)
    assert w == jbarrier.telescope_widths(jt, 4096)


def test_telescope_widths_stacked_max():
    t = barrier.stack_tables([barrier.mixed_radix_tree((2,) * 10),
                              barrier.mixed_radix_tree((1024,))],
                             device="cpu")
    w = barrier.telescope_widths(t, 1024)
    assert w == barrier.default_widths(1024, len(w) - 1)


@pytest.mark.parametrize("n", [768, 1536, 3072])
def test_default_widths_nonpow2_bound(n):
    cfg = C768 if n == 768 else topology.multi_cluster(
        C768, n_clusters=n // 768)
    sched = barrier.mixed_radix_tree(
        _random_factorization(random.Random(n), n), n_pes=n, cfg=cfg)
    t = barrier.level_table(sched, cfg=cfg, device="cpu")
    tight = barrier.telescope_widths(t, n)
    loose = barrier.default_widths(n, len(tight) - 1)
    assert all(a <= b for a, b in zip(tight, loose))
    assert barrier.max_depth(n) == jbarrier.max_depth(n)
    assert loose == jbarrier.default_widths(n, len(tight) - 1)


def test_telescope_rejects_short_widths():
    t = barrier.level_table(barrier.kary_tree(8, n_pes=64), device="cpu")
    with pytest.raises(ValueError, match="widths"):
        barrier_sim._telescope_core(torch.zeros(64), t, topology.DEFAULT,
                                    widths=(64, 8))


# ---------------------------------------------------------------------------
# validate_tail_padding names the offending row and level.
# ---------------------------------------------------------------------------

def test_validate_tail_padding_reports_row_and_level():
    t = barrier.level_table(barrier.kary_tree(2, n_pes=64), device="cpu")
    bad = t._replace(group_sizes=torch.tensor([2, 1, 2, 2, 2, 4],
                                              dtype=torch.int32))
    with pytest.raises(ValueError, match=r"row 0 .*level 1"):
        barrier.validate_tail_padding(bad)


def test_validate_tail_padding_reports_padding_level():
    t = barrier.level_table(barrier.kary_tree(8, n_pes=64), device="cpu")
    instr = t.instr_cycles.clone()
    instr[-1] = 3.0
    depth = t.group_sizes.shape[-1]
    with pytest.raises(ValueError,
                       match=rf"row 0, padding level {depth - 1}"):
        barrier.validate_tail_padding(t._replace(instr_cycles=instr))


@pytest.mark.parametrize("comp", [(12, 8, 8), (768,), (2, 2, 2, 2, 48)])
def test_validate_tail_padding_accepts_nonpow2_tables(comp):
    s = barrier.mixed_radix_tree(comp, n_pes=768, cfg=C768)
    t = barrier.level_table(s, cfg=C768, device="cpu")
    assert barrier.validate_tail_padding(t) is t
    js = jbarrier.mixed_radix_tree(comp, n_pes=768, cfg=JC768)
    _assert_tables_equal(jbarrier.level_table(js, cfg=JC768), t)
    stack = barrier.stack_tables(
        [barrier.mixed_radix_tree(c, n_pes=768, cfg=C768)
         for c in ((12, 8, 8), (768,), (2, 384))], C768, device="cpu")
    assert barrier.validate_tail_padding(stack) is stack


# ---------------------------------------------------------------------------
# Telescope == scan, and both == the JAX package, at hierarchical and
# non-power-of-two compositions x placements.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["768", "1024", "1536", "2048x2", "2048x4",
                                  "4096"])
def test_telescope_matches_scan_hierarchical(name):
    cfg, jcfg = _machine(topology, name), _machine(jtopology, name)
    scheds = _stack_for(tuning, topology, cfg)
    jscheds = _stack_for(jtuning, jtopology, jcfg)
    assert [s.name for s in scheds] == [s.name for s in jscheds]
    n = cfg.n_pes
    ttab = barrier.stack_tables(scheds, cfg, device="cpu")
    jtab = jbarrier.stack_tables(jscheds, jcfg)
    _assert_tables_equal(jtab, ttab)
    assert (barrier.telescope_widths(ttab, n)
            == jbarrier.telescope_widths(jtab, n))
    arr = _uniform(0, n, 512.0)
    tele = sweep.simulate_schedules(torch.from_numpy(arr), scheds, cfg,
                                    core="telescope")
    scan = sweep.simulate_schedules(torch.from_numpy(arr), scheds, cfg,
                                    core="scan")
    _assert_bitwise(tele, scan, name)
    _assert_exact(tele, jsweep.simulate_schedules(arr, jscheds, jcfg), name)


@pytest.mark.parametrize("name", ["768", "1536", "2048x4"])
def test_telescope_matches_scan_hierarchical_placed(name):
    cfg, jcfg = _machine(topology, name), _machine(jtopology, name)
    scheds, placs = tuning._cross_placements(
        _stack_for(tuning, topology, cfg)[:6], placement.STRATEGIES, cfg)
    jscheds, jplacs = jtuning._cross_placements(
        _stack_for(jtuning, jtopology, jcfg)[:6], jplacement.STRATEGIES,
        jcfg)
    ttab = barrier.stack_tables(scheds, cfg, placs, device="cpu")
    _assert_tables_equal(jbarrier.stack_tables(jscheds, jcfg, jplacs), ttab)
    arr = _uniform(7, cfg.n_pes, 300.0)
    tele = sweep.simulate_schedules(torch.from_numpy(arr), scheds, cfg,
                                    placements=placs, core="telescope")
    scan = sweep.simulate_schedules(torch.from_numpy(arr), scheds, cfg,
                                    placements=placs, core="scan")
    _assert_bitwise(tele, scan, name)
    _assert_exact(tele, jsweep.simulate_schedules(
        arr, jscheds, jcfg, placements=jplacs), name)


@settings(max_examples=8, deadline=None)
@given(st.integers(0, 2**31 - 1),
       st.sampled_from([768, 1536, 3072]),
       st.sampled_from([None, "leaf_local", "tile_interleaved",
                        "group_hub", "central"]),
       st.floats(0.0, 4096.0))
def test_random_nonpow2_composition_equivalence(seed, n_pes, strat, delay):
    """A random non-power-of-two factorization, placement and scatter:
    the port's telescope equals its scan oracle bit for bit."""
    cfg = (C768 if n_pes == 768
           else topology.multi_cluster(C768, n_clusters=n_pes // 768))
    sched = barrier.mixed_radix_tree(
        _random_factorization(random.Random(seed), n_pes), n_pes=n_pes,
        cfg=cfg)
    plc = (None if strat is None
           else placement.place_counters(sched, strat, cfg))
    arr = delay * prng.uniform(prng.PRNGKey(seed, device="cpu"), (n_pes,))
    tele = barrier_sim.simulate(arr, sched, cfg=cfg, placement=plc,
                                core="telescope", device="cpu")
    scan = barrier_sim.simulate(arr, sched, cfg=cfg, placement=plc,
                                core="scan", device="cpu")
    _assert_bitwise(tele, scan, (n_pes, sched.name, strat, delay))


@pytest.mark.parametrize("seed,n_pes,strat", [(3, 768, None),
                                              (5, 1536, "group_hub"),
                                              (11, 3072, "tile_interleaved")])
def test_random_nonpow2_composition_matches_reference(seed, n_pes, strat):
    """Fixed draws of the property above, against the JAX package."""
    cfg = (C768 if n_pes == 768
           else topology.multi_cluster(C768, n_clusters=n_pes // 768))
    jcfg = (JC768 if n_pes == 768
            else jtopology.multi_cluster(JC768, n_clusters=n_pes // 768))
    sizes = _random_factorization(random.Random(seed), n_pes)
    sched = barrier.mixed_radix_tree(sizes, n_pes=n_pes, cfg=cfg)
    jsched = jbarrier.mixed_radix_tree(sizes, n_pes=n_pes, cfg=jcfg)
    plc = None if strat is None else placement.place_counters(sched, strat,
                                                              cfg)
    jplc = None if strat is None else jplacement.place_counters(
        jsched, strat, jcfg)
    arr = _uniform(seed, n_pes, 1000.0)
    got = barrier_sim.simulate(torch.from_numpy(arr), sched, cfg=cfg,
                               placement=plc, device="cpu")
    _assert_exact(got, jsim.simulate(arr, jsched, cfg=jcfg, placement=jplc),
                  (n_pes, sizes, strat))


def test_remote_tier_shows_in_simulation():
    """A cluster-straddling central counter costs more than the
    hierarchy-aligned tree under the same arrivals."""
    cfg = _machine(topology, "256")
    arr = torch.zeros(256)
    hier = barrier_sim.simulate(arr, barrier.mixed_radix_tree((8, 8, 4),
                                                              cfg=cfg),
                                cfg=cfg, device="cpu")
    flat = barrier_sim.simulate(arr, barrier.mixed_radix_tree((256,),
                                                              cfg=cfg),
                                cfg=cfg, device="cpu")
    assert flat.span_cycles.item() > hier.span_cycles.item()


# ---------------------------------------------------------------------------
# A whole multi-cluster grid (the reference's one-compile case: here one
# batched call, equal to the reference's grid and to its own sub-stacks).
# ---------------------------------------------------------------------------

def test_multicluster_grid_matches_reference():
    cfg, jcfg = _machine(topology, "256"), _machine(jtopology, "256")
    scheds = tuning.multicluster_schedules(cfg)
    res = sweep.sweep_schedules(prng.PRNGKey(3, device="cpu"), scheds,
                                delays=(0.0, 128.0, 2048.0), n_trials=4,
                                cfg=cfg, device="cpu")
    assert res.span_cycles.shape == (len(scheds), 3, 4)
    want = jsweep.sweep_schedules(jax.random.PRNGKey(3),
                                  jtuning.multicluster_schedules(jcfg),
                                  delays=(0.0, 128.0, 2048.0), n_trials=4,
                                  cfg=jcfg, core="telescope")
    _assert_exact(res, want, "grid")
    # A sub-stack may take tighter widths (a max over fewer rows): the
    # same bits.
    sub = sweep.sweep_schedules(prng.PRNGKey(3, device="cpu"), scheds[:8],
                                delays=(0.0, 128.0, 2048.0), n_trials=4,
                                cfg=cfg, device="cpu")
    for f in EXACT:
        assert torch.equal(getattr(sub, f), getattr(res, f)[:8]), f


def test_tables_and_widths_at_16384():
    """The benchmark's 16384-PE stacks: every table field and the
    widths equal the reference's (the widths sum to the recorded 18576
    and 32767)."""
    cfg, jcfg = _machine(topology, "16384"), _machine(jtopology, "16384")
    seg = [tuple(tuning._hier_segments(cfg.pes_per_cluster, cfg))]
    comps = tuning.multicluster_compositions(cfg, intra=seg)
    assert comps == jtuning.multicluster_compositions(jcfg, intra=seg)
    ttab = barrier.stack_tables(
        [barrier.mixed_radix_tree(c, cfg=cfg) for c in comps], cfg,
        device="cpu")
    jtab = jbarrier.stack_tables(
        [jbarrier.mixed_radix_tree(c, cfg=jcfg) for c in comps], jcfg)
    _assert_tables_equal(jtab, ttab)
    w = barrier.telescope_widths(ttab, 16384)
    assert w == jbarrier.telescope_widths(jtab, 16384)
    assert sum(w) == 18576
    assert sum(barrier.default_widths(16384, len(w) - 1)) == 32767
    flats = [(16384,), barrier.kary_tree(16, n_pes=16384, cfg=cfg).sizes]
    _assert_tables_equal(
        jbarrier.stack_tables([jbarrier.mixed_radix_tree(c, cfg=jcfg)
                               for c in flats], jcfg),
        barrier.stack_tables([barrier.mixed_radix_tree(c, cfg=cfg)
                              for c in flats], cfg, device="cpu"))
