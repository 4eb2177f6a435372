"""The port's figure drivers on the CPU against the rows of the
reference benchmarks, as the JAX package computes them
(``reference_values.json``: the ``bench_rows`` of ``fig5``, ``fig6`` and
``fig7``, and the sections ``fig_placement``, ``fig_tuned_tree`` and
``fig_workload_tuned``, each recomputed with JAX by
``tests/test_torch_reference_values.py``): every row's name and derived
value equal.  Each driver times its calls twice
(first call, steady state); here ``measure`` makes one call, since only
the rows are compared."""
import json
from pathlib import Path

import pytest

from repro_torch.examples import (fig5, fig6, fig7, fig_placement,
                                  fig_tuned_tree, fig_workload_tuned)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

PATH = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "reference_values.json")
FIGURES = {"fig_placement": fig_placement, "fig_tuned_tree": fig_tuned_tree,
           "fig_workload_tuned": fig_workload_tuned}
DRIVERS = (fig5, fig6, fig7, *FIGURES.values())


@pytest.fixture
def one_call(monkeypatch):
    """Each driver's ``measure`` as one untimed call."""
    for driver in DRIVERS:
        monkeypatch.setattr(driver, "measure",
                            lambda fn, device: (fn(), 0.0, 0.0))


def _load() -> dict:
    return json.loads(PATH.read_text())


def _rows(rows) -> list:
    """``[name, derived]`` of a driver's rows."""
    return [[row[0], row[2]] for row in rows]


def test_fig5_and_fig6_drivers_match_the_benchmark_rows(one_call):
    values = _load()
    assert (fig5.KEY, fig6.KEY, list(fig6.RADICES)) == (
        values["fig5"]["key"], values["fig6"]["key"],
        values["fig6"]["radices"])
    assert _rows(fig5.run("cpu")) == values["fig5"]["bench_rows"]
    assert _rows(fig6.run("cpu")) == values["fig6"]["bench_rows"]


def test_fig7_driver_matches_the_benchmark_rows(one_call):
    """The grid's cycles, speedups and fractions and the tuned modes'
    trees are the rows of ``benchmarks/fig7_5g_app.py``."""
    values = _load()["fig7"]
    assert (fig7.KEY, fig7.RADIX, list(fig7.GRID)) == (
        values["key"], values["radix"],
        [(r["n_rx"], r["ffts_per_round"]) for r in values["rows"]])
    assert _rows(fig7.run("cpu")) == values["bench_rows"]


@pytest.mark.parametrize("name", sorted(FIGURES))
def test_figure_driver_matches_the_benchmark_rows(one_call, name):
    want = _load()[name]
    assert want["benchmark"] == f"benchmarks/{name}.py"
    assert _rows(FIGURES[name].run("cpu")) == want["rows"]


def test_figure_drivers_write_their_records(tmp_path):
    """``main`` prints the rows and writes the record with its device
    and both timings of each call."""
    out = tmp_path / "fig5.json"
    rows = fig5.main(["--device", "cpu", "--out", str(out)])
    record = json.loads(out.read_text())
    assert record["figure"] == "fig5" and record["device"] == "cpu"
    assert record["rows"] == [list(r) for r in rows]
    assert all(r[1] > 0 and r[3] > 0 for r in record["rows"])
