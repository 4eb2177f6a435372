"""The rows of the beyond-figure benchmarks (``benchmarks/fig_placement.py``,
``fig_tuned_tree.py``, ``fig_workload_tuned.py``) against their stored
sections.

A JAX recompute of ``src/repro_torch/reference_values.json`` (the
helpers and the stored file are ``tests/test_torch_reference_values.py``'s),
in a file of its own: pytest-xdist's ``--dist loadfile`` runs a file on
one worker, and this test alone runs minutes on the CPU."""
import json

import pytest

from test_torch_reference_values import (  # noqa: F401  (one_call: a fixture)
    FIGURES, _figure, _load, one_call)


@pytest.mark.parametrize("name", FIGURES)
def test_figure_section_matches_jax(one_call, name):
    """Every row (name and derived value) of a beyond-figure benchmark
    is what the JAX package computes now."""
    assert _load()[name] == json.loads(json.dumps(_figure(name)))
