"""The port's serving, resilience and core benchmark drivers and its
benchmark runner (``repro_torch.examples.bench_serving``,
``bench_resilience``, ``bench_core`` and ``run``) at small N on the CPU:
each record carries the reference benchmark's keys and rows, every
served request is exact and eight coalesce into one dispatch, a
preempted sweep resumes bit for bit, both simulator cores agree, and
the runner refuses the tags it has no driver for."""
import json
from pathlib import Path

import pytest

from repro_torch.core import tuning
from repro_torch.examples import (bench_core, bench_resilience,
                                  bench_serving, run)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]


def test_bench_serving_record():
    record = bench_serving.measure("cpu", n=64)
    want_keys = set(json.loads((ROOT / "BENCH_serving.json").read_text()))
    assert set(record) == want_keys | {"device"}
    assert record["device"] == "cpu"
    assert (record["n_pes"], record["n_requests"], record["n_schedules"]) \
        == (64, 8, len(tuning.all_schedules(64, prune="none")))
    assert record["sequential_stats"] == {"batches": 8, "exact": 8,
                                          "cache_hits": 0}
    assert record["batch_efficiency_req_per_dispatch"] == 8.0
    assert record["accept_added_p99_le_10pct"] == (
        record["added_p99_pct"] <= 10.0)
    assert [r[0] for r in bench_serving.rows(record)] == [
        "serving_raw_N64", "serving_p99_N64", "serving_batched_N64",
        "serving_degraded_N64"]


def test_bench_resilience_record(tmp_path):
    record = bench_resilience.measure("cpu", n=64, work=tmp_path / "w")
    assert not (tmp_path / "w").exists()
    assert list(record["chunks"]) == ["4", "8", "16"]
    r = record["recovery"]
    assert r["resumed_equals_plain"]
    assert (r["killed_at"], r["chunks_total"], r["chunks_resumed"],
            r["chunks_computed"]) == (1, 2, 1, 1)
    assert record["accept_overhead_le_10pct"] == (
        record["chunks"]["8"]["overhead_pct"] <= 10.0)
    assert [row[0] for row in bench_resilience.rows(record)] == [
        f"resilience_{kind}_N64_c{c}" for c in (4, 8, 16)
        for kind in ("plain", "ckpt")] + [
        "resilience_killed_N64", "resilience_recovery_N64"]


def test_bench_core_record():
    record = bench_core.measure("cpu", ns=(64,))
    grids = record["N=64"]
    n_sched = len(tuning.enumerate_compositions(64))
    assert {g: e["points"] for g, e in grids.items()} == {
        "sweep_barrier": 6 * 4 * 16, "tune_barrier": n_sched * 4 * 4,
        "sweep_arrivals": n_sched * 3 * 4}
    assert all(e["cores_equal"] for e in grids.values())
    assert len(bench_core.rows(record)) == 9


@pytest.mark.parametrize("tag, item", [("collectives", "queue 1 item 2"),
                                       ("roofline", "queue 1 item 5")])
def test_runner_raises_for_tags_not_ported(tag, item):
    with pytest.raises(NotImplementedError, match=item):
        run.rows(tag, "cpu")


def test_runner_lists_every_reference_tag(capsys):
    run.main(["--list"])
    tags = [line.split()[0] for line in capsys.readouterr().out.splitlines()]
    assert tags == ["fig4", "fig5", "fig6", "fig7", "tuned", "placement",
                    "workload", "core", "multicluster", "energy",
                    "collectives", "resilience", "faults", "serving",
                    "roofline"]


@pytest.mark.parametrize("tag, module, sizes", [
    ("serving", bench_serving, {"N": 64}),
    ("resilience", bench_resilience, {"N": 64}),
    ("core", bench_core, {"NS": (64,)}),
], ids=["serving", "resilience", "core"])
def test_runner_drives_the_new_drivers(tag, module, sizes, tmp_path,
                                       monkeypatch, capsys):
    """One tag through the runner: the CSV header, the driver's rows,
    and its record written."""
    for name, value in sizes.items():
        monkeypatch.setattr(module, name, value)
    monkeypatch.setattr(module, "OUT", tmp_path / "out.json")
    if module is bench_resilience:
        monkeypatch.setattr(module, "WORK", tmp_path / "work")
    run.main([tag, "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,us_per_call,derived,compile_us"
    names = [line.split(",")[0] for line in lines[1:]]
    record = json.loads((tmp_path / "out.json").read_text())
    assert names == [row[0] for row in module.rows(record)]


def test_runner_runs_every_ported_tag_then_raises(monkeypatch, tmp_path,
                                                  capsys):
    monkeypatch.setattr(bench_serving, "N", 64)
    monkeypatch.setattr(bench_serving, "OUT", tmp_path / "out.json")
    monkeypatch.setattr(run, "DRIVERS", {"serving": bench_serving,
                                         "collectives": None})
    with pytest.raises(NotImplementedError, match="collectives"):
        run.main(["--device", "cpu"])
    assert len(capsys.readouterr().out.splitlines()) == 5
