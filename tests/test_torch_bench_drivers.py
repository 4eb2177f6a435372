"""Port parity: the schedule algebra's ``compose``/``describe`` and the
benchmark drivers of ``repro_torch.examples`` against the reference's
procedures run by the JAX package, at reduced sizes: Fig. 4b and claim
C3 (``fig4``), the energy benchmark at N = 64 (``bench_energy``, its 5G
section in both threefry streams) and the multi-cluster benchmark's
simulated columns on a 128-PE machine (``bench_multicluster``)."""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import benchmarks.bench_energy as jbench_energy
import benchmarks.bench_multicluster as jbench_mc
import benchmarks.fig4_random_delay as jfig4
from repro.core import barrier as jbarrier
from repro.core import barrier_sim as jsim
from repro.core import sweep as jsweep
from repro.core import topology as jtopology
from repro.core import tuning as jtuning
from repro_torch.core import barrier, topology
from repro_torch.examples import bench_energy, bench_multicluster, fig4
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

C768 = dict(n_pes=768, tiles_per_group=12, n_groups=8)


def _both(build):
    """``build(barrier_module, topology_module)`` in each package."""
    return build(barrier, topology), build(jbarrier, jtopology)


@pytest.mark.parametrize("build", [
    lambda b, t: b.central_counter(1024),
    lambda b, t: b.kary_tree(32),
    lambda b, t: b.kary_tree(4, n_pes=768, cfg=t.TeraPoolConfig(**C768)),
    lambda b, t: b.mixed_radix_tree((8, 16, 8)),
    lambda b, t: b.hw_event_unit(1024),
    lambda b, t: b.hw_event_unit(cfg=t.multi_cluster(n_clusters=4)),
    lambda b, t: b.partial_barrier(256, 16),
    lambda b, t: b.compose(b.kary_tree(8, n_pes=8), b.kary_tree(16, n_pes=16),
                           b.kary_tree(8, n_pes=8)),
    lambda b, t: b.compose(b.mixed_radix_tree((8, 16, 8)),
                           b.mixed_radix_tree((2, 2)),
                           cfg=t.multi_cluster(n_clusters=4)),
    lambda b, t: b.compose(b.kary_tree(4, n_pes=16),
                           b.kary_tree(4, n_pes=16), partial=True),
], ids=["central", "radix32", "radix4_768", "8x16x8", "hw", "hw_4cluster",
        "partial", "compose_tile_group_cluster", "compose_multicluster",
        "compose_partial"])
def test_compose_and_describe_match_reference(build):
    got, want = _both(build)
    assert barrier.describe(got) == jbarrier.describe(want)
    assert (got.n_pes, got.radix, got.partial, got.hw) == (
        want.n_pes, want.radix, want.partial, want.hw)
    assert [(l.group_size, l.span, l.latency) for l in got.levels] == [
        (l.group_size, l.span, l.latency) for l in want.levels]


def test_describe_strings():
    assert barrier.describe(barrier.central_counter(1024)) == (
        "1024: central counter over 1024 PEs, spans [1024], latencies [5]")
    assert barrier.describe(barrier.compose(
        barrier.kary_tree(8, n_pes=8), barrier.mixed_radix_tree((16, 8)))) \
        == ("8x16x8: mixed-radix tree over 1024 PEs, spans [8,128,1024], "
            "latencies [1,3,5]")
    with pytest.raises(ValueError, match="at least one"):
        barrier.compose()


@pytest.fixture(scope="module")
def fig4_grids():
    """The Fig. 4a grid at 4 trials, from each package."""
    res, _, _ = fig4.run_sweep("cpu", n_trials=4)
    jres = jsweep.sweep_barrier(jax.random.PRNGKey(fig4.KEY),
                                radices=list(jbarrier.all_radices()),
                                delays=fig4.DELAYS, n_trials=4)
    return res, jres


def test_fig4a_rows_match_reference(fig4_grids):
    res, jres = fig4_grids
    rows = fig4.fig4a(res)
    want = np.asarray(jres.mean_span)
    assert len(rows) == want.size
    for row in rows:
        i = list(np.asarray(jres.radices)).index(row["radix"])
        j = list(fig4.DELAYS).index(row["delay"])
        np.testing.assert_allclose(row["mean_span"], want[i, j], rtol=1e-6)


def test_fig4b_rows_match_reference(fig4_grids):
    """Best radix per delay exactly, its residency to rtol 1e-6, and the
    reference benchmark's overhead rows at its rounding."""
    res, jres = fig4_grids
    rows = fig4.fig4b(res)
    jrows = {name: frac for name, _, frac, _ in jfig4.fig4b(jres)}
    resid = np.asarray(jres.mean_residency_grid)
    assert list(fig4.SFRS) == jfig4.SFRS
    for j, row in enumerate(rows):
        i = list(np.asarray(jres.radices)).index(row["radix"])
        np.testing.assert_allclose(row["mean_residency"], resid[i, j],
                                   rtol=1e-6)
        for sfr, frac in row["overhead"].items():
            name = (f"fig4b_delay{int(row['delay'])}_sfr{sfr}"
                    f"_radix{row['radix']}")
            assert jrows.pop(name) == frac, name
    assert not jrows


def test_claim_c3_at_reduced_trials():
    """C3 on the reference test's draws at 4 trials: residencies to rtol
    1e-6 of the JAX package's (every delay and radix in one compiled
    ``sweep_arrivals``), and the SFR inside the claim's band."""
    got = fig4.claim_c3("cpu", n_trials=4)
    key = jax.random.PRNGKey(fig4.KEY)
    arr = jnp.stack([jsim.uniform_arrivals(key, delay, fig4.N_PES, 4)
                     for delay, _, _ in fig4.C3_BANDS])
    want = np.asarray(jsweep.sweep_arrivals(
        arr, [jbarrier.kary_tree(r) for r in fig4.C3_RADICES])
        .mean_residency).mean(axis=-1)
    assert len(got) == len(fig4.C3_BANDS)
    for k, (row, (delay, lo, hi)) in enumerate(zip(got, fig4.C3_BANDS)):
        assert (row["delay"], row["band"]) == (delay, [lo, hi])
        for i, r in enumerate(fig4.C3_RADICES):
            np.testing.assert_allclose(row["costs"][str(r)], want[i, k],
                                       rtol=1e-6)
        assert row["holds"] and lo < row["sfr_needed"] < hi


@pytest.fixture(scope="module")
def energy_reference():
    """The reference benchmark's three sections at N = 64 (its 5G
    section with the threefry flag off, as its file was drawn)."""
    saved = jbench_energy._NS, jbench_energy._5G_N
    jbench_energy._NS, jbench_energy._5G_N = (64,), 64
    try:
        rows = []
        out = {"energy_per_barrier": jbench_energy._energy_vs_n(rows),
               "pareto": jbench_energy._pareto(rows)}
        with jax.threefry_partitionable(False):
            out["fiveg"] = jbench_energy._fiveg(rows)
    finally:
        jbench_energy._NS, jbench_energy._5G_N = saved
    return out


def test_energy_sections_match_reference_at_64(energy_reference):
    assert bench_energy.energy_per_barrier(
        ns=(64,), device="cpu")[0] == energy_reference["energy_per_barrier"]
    assert bench_energy.pareto(64, device="cpu")[0] == \
        energy_reference["pareto"]


def test_energy_fiveg_section_matches_reference_at_64(energy_reference):
    """The 5G section, on the original stream, equals the reference's
    run with the flag off."""
    assert bench_energy.fiveg_energy(64, device="cpu")[0] == \
        energy_reference["fiveg"]


def test_energy_sections_match_recorded_file_at_64_and_256():
    """Delay 0 makes the per-barrier section independent of the draws:
    the port's CPU run equals ``BENCH_energy.json`` at 64 and 256."""
    bench = json.loads((Path(__file__).resolve().parents[1]
                        / "BENCH_energy.json").read_text())
    got = bench_energy.energy_per_barrier(ns=(64, 256), device="cpu")[0]
    for n in (64, 256):
        assert got[f"N={n}"] == bench["energy_per_barrier"][f"N={n}"]


def test_multicluster_columns_match_reference_at_128():
    """The simulated columns on 4 clusters of 32 PEs against the
    reference benchmark's own stacks swept by the JAX package."""
    got = bench_multicluster.bench_machine(128, device="cpu")
    jcfg = jbench_mc._machine(128)
    hier = jbench_mc._hier_schedules(jcfg)
    stack = hier + jbench_mc._flat_schedules(jcfg)
    assert got["n_schedules"] == len(stack)
    assert [s.name for s in bench_multicluster.hier_schedules(
        bench_multicluster.machine(128))] == [s.name for s in hier]
    res = jsweep.sweep_schedules(jbench_mc.KEY, stack,
                                 delays=jbench_mc.DELAYS,
                                 n_trials=jbench_mc.N_TRIALS, cfg=jcfg)
    spans = np.asarray(res.span_cycles).mean(axis=-1)[:, 0]
    hier_best, central = float(spans[:len(hier)].min()), float(
        spans[len(hier)])
    uniform_best = float(spans[len(hier):].min())
    assert got["hier_vs_flat"] == {
        "hier_best_span": round(hier_best, 1),
        "central_span": round(central, 1),
        "uniform_best_span": round(uniform_best, 1),
        "speedup_vs_central": round(central / hier_best, 2),
        "speedup_vs_uniform": round(uniform_best / hier_best, 2)}
    assert got["sweep"]["points"] == len(stack) * 2 * 4
    assert "one device" in got["sharding"]


def test_multicluster_widths_and_curation_match_reference():
    """The widths' sums (tables only) at 128 and at the recorded sizes,
    and the ``MAX_STACK`` curation's stack sizes 132/14/14."""
    for n, sums, count in ((128, None, None), (2048, (2333, 4095), 132),
                           (4096, (4654, 8191), 14),
                           (16384, (18576, 32767), 14)):
        cfg, jcfg = bench_multicluster.machine(n), jbench_mc._machine(n)
        tables = bench_multicluster.segment_tables(cfg, "cpu")
        seg = [tuple(jtuning._hier_segments(jcfg.pes_per_cluster, jcfg))]
        jtables = jbarrier.stack_tables(
            [jbarrier.mixed_radix_tree(c, cfg=jcfg) for c in
             jtuning.multicluster_compositions(jcfg, intra=seg)],
            jcfg)
        tight = barrier.telescope_widths(tables, n)
        assert tight == jbarrier.telescope_widths(jtables, n)
        if sums is not None:
            assert (sum(tight), sum(barrier.default_widths(
                n, len(tight) - 1))) == sums
            got = (len(bench_multicluster.hier_schedules(cfg))
                   + len(bench_multicluster.flat_schedules(cfg)))
            assert got == count == len(jbench_mc._hier_schedules(jcfg)) \
                + len(jbench_mc._flat_schedules(jcfg))


def test_multicluster_main_writes_its_record(tmp_path):
    out = tmp_path / "mc.json"
    bench_multicluster.main(["--device", "cpu", "--ns", "128",
                             "--out", str(out)])
    entry = json.loads(out.read_text())["N=128"]
    assert entry["n_schedules"] == 20
    assert set(entry["widths"]) >= {"sum_tight", "sum_fallback", "tight",
                                    "fallback", "speedup"}
