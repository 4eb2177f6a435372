"""The port stands alone: it never imports JAX or the JAX package, and
its entry points default to the GPU and raise without one instead of
falling back to the CPU."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import resolve_device
from repro_torch.core import (barrier, barrier_sim, fiveg, placement, prng,
                              sweep, tuning, workloads)
from repro_torch.kernels import ref

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
IMPORT = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(' '.join(sorted(m for m in sys.modules "
        "if m.startswith('repro_torch'))))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = set(out.stdout.split())
    assert len(loaded) >= 26
    assert {f"repro_torch.core.{m}" for m in (
        "placement", "workloads", "tuning", "xla_math")} <= loaded
    assert {f"repro_torch.kernels.{m}" for m in ("dotp", "axpy")} <= loaded
    assert "repro_torch.examples.barrier_tuning" in loaded


def test_no_source_imports_jax_or_the_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 15
    offenders = [str(f) for f in files if IMPORT.search(f.read_text())]
    assert not offenders, offenders


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; the default is usable")


@pytest.mark.parametrize("call", [
    lambda k: prng.PRNGKey(0),
    lambda k: resolve_device("cuda"),
    lambda k: barrier.level_table(barrier.kary_tree(32)),
    lambda k: barrier.stack_tables([barrier.kary_tree(32)]),
    lambda k: barrier_sim.simulate(torch.zeros(1024), barrier.kary_tree(32)),
    lambda k: barrier_sim.simulate_reference(torch.zeros(1024),
                                             barrier.kary_tree(32)),
    lambda k: barrier_sim.uniform_arrivals(k, 128.0, 1024),
    lambda k: sweep.sweep_barrier(k, n_pes=64, n_trials=2),
    lambda k: fiveg.simulate_app(k),
    lambda k: fiveg.compare_barriers(k),
    lambda k: fiveg.simulate_app_reference(k),
    lambda k: ref.digit_reverse_indices(16),
    lambda k: workloads.arrival_batch(prng.PRNGKey(0), "axpy_1Mi", (2, 64)),
    lambda k: tuning.tune_barrier(prng.PRNGKey(0), 64, n_trials=2),
    lambda k: tuning.tuned_for_workload("axpy_1Mi", 64),
    lambda k: placement.simulate_placed_reference(
        torch.zeros(64), barrier.kary_tree(8, n_pes=64),
        placement.place_counters(barrier.kary_tree(8, n_pes=64))),
    lambda k: fiveg.simulate_app(k, sync="workload"),
], ids=["PRNGKey", "resolve_device", "level_table", "stack_tables",
        "simulate", "simulate_reference", "uniform_arrivals",
        "sweep_barrier", "simulate_app", "compare_barriers",
        "simulate_app_reference", "digit_reverse_indices",
        "arrival_batch", "tune_barrier", "tuned_for_workload",
        "simulate_placed_reference", "simulate_app_workload"])
def test_entry_point_defaults_to_cuda_and_raises(call):
    _no_card()
    with pytest.raises(RuntimeError, match="cuda"):
        call(prng.PRNGKey(0, device="cpu"))


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result without a
    card, and also when it stands alone, without the package."""
    _no_card()
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", lone):
        out = subprocess.run([sys.executable, str(script)],
                             capture_output=True, text=True, timeout=120,
                             cwd=script.parent)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
