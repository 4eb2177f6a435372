"""The rows of ``benchmarks/fig7_5g_app.py`` against the stored ``fig7``
section.

A JAX recompute of ``src/repro_torch/reference_values.json`` (the
helpers and the stored file are ``tests/test_torch_reference_values.py``'s),
in a file of its own: pytest-xdist's ``--dist loadfile`` runs a file on
one worker, and this test alone runs minutes on the CPU."""
from test_torch_reference_values import (  # noqa: F401  (one_call: a fixture)
    _bench_rows, _load, one_call)


def test_fig7_bench_rows_match_jax(one_call):
    """The rows of ``benchmarks/fig7_5g_app.py`` (the grid's cycles,
    speedups and fractions, the tuned modes' trees) are what the JAX
    package computes now."""
    assert _load()["fig7"]["bench_rows"] == _bench_rows("fig7_5g_app")
