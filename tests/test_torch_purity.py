"""The port stands alone: it never imports JAX or the JAX package, and
its entry points default to the GPU and raise without one instead of
falling back to the CPU."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import resolve_device
from repro_torch.core import (barrier, barrier_sim, energy, fiveg,
                              placement, prng, sweep, tuning, workloads)
from repro_torch import configs
from repro_torch.examples import (bench_core, bench_energy, bench_faults,
                                  bench_multicluster, bench_resilience,
                                  bench_serving, fig4, fig5, fig6, fig7,
                                  fig_placement, fig_tuned_tree,
                                  fig_workload_tuned, run, serve_lm)
from repro_torch.kernels import ref
from repro_torch.launch import steps
from repro_torch.models import convert, init_caches
from repro_torch.runtime import (ResilienceConfig, ServerConfig, TuningServer,
                                 resilient_sweep_arrivals,
                                 resilient_sweep_schedules,
                                 resilient_sweep_workloads,
                                 resilient_tune_barrier)

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
    assert len(loaded) >= 51
    assert {f"repro_torch.core.{m}" for m in (
        "placement", "workloads", "tuning", "xla_math")} <= loaded
    assert {f"repro_torch.kernels.{m}" for m in ("dotp", "axpy",
                                                 "flash_attn",
                                                 "ssm_scan")} <= loaded
    assert {f"repro_torch.models.{m}" for m in (
        "config", "layers", "attention", "transformer", "convert", "mla",
        "moe", "ssm")} <= loaded
    assert {f"repro_torch.configs.{m}" for m in configs.ARCH_IDS} <= loaded
    assert {"repro_torch.launch.steps", "repro_torch.examples.serve_lm",
            "repro_torch.examples.barrier_tuning"} <= loaded
    assert {f"repro_torch.examples.{m}" for m in (
        "fig4", "bench_energy", "bench_multicluster", "bench_faults",
        "fig5", "fig6", "fig7", "fig_placement", "fig_tuned_tree",
        "fig_workload_tuned", "bench_serving", "bench_resilience",
        "bench_core", "run")} <= loaded
    assert {f"repro_torch.runtime.{m}" for m in (
        "schedule_cache", "inject", "fault", "elastic",
        "resilient_sweep", "serving")} | {"repro_torch.checkpoint.ckpt"} \
        <= loaded


def test_no_source_imports_jax_or_the_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 15
    offenders = [str(f) for f in files if IMPORT.search(f.read_text())]
    assert not offenders, offenders


# A store that the resilient sweeps never reach: they raise on the
# device first.
_RESILIENCE = ResilienceConfig(ckpt_dir="build/never-written")


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
    lambda k: resilient_sweep_schedules(
        k, [barrier.kary_tree(8, n_pes=64)], n_trials=2,
        resilience=_RESILIENCE),
    lambda k: resilient_sweep_arrivals(
        torch.zeros(2, 64), [barrier.kary_tree(8, n_pes=64)],
        resilience=_RESILIENCE),
    lambda k: resilient_tune_barrier(prng.PRNGKey(0), 64, n_trials=2,
                                     resilience=_RESILIENCE),
    lambda k: resilient_sweep_workloads(prng.PRNGKey(0), ("axpy_1Mi",), 64,
                                        n_trials=2, resilience=_RESILIENCE),
], ids=["PRNGKey", "resolve_device", "level_table", "stack_tables",
        "simulate", "simulate_reference", "uniform_arrivals",
        "sweep_barrier", "simulate_app", "compare_barriers",
        "simulate_app_reference", "digit_reverse_indices",
        "arrival_batch", "tune_barrier", "tuned_for_workload",
        "simulate_placed_reference", "simulate_app_workload",
        "resilient_sweep_schedules", "resilient_sweep_arrivals",
        "resilient_tune_barrier", "resilient_sweep_workloads"])
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


@pytest.mark.parametrize("call", [
    lambda: barrier_sim.simulate(torch.zeros(1024), barrier.kary_tree(32),
                                 faults=barrier.NO_FAULTS),
    lambda: barrier_sim.simulate_robust_reference(
        torch.zeros(64), barrier.kary_tree(8, n_pes=64)),
    lambda: energy.energy_reference(torch.zeros(64),
                                    barrier.kary_tree(8, n_pes=64)),
    lambda: fiveg.degradation_curve(prng.PRNGKey(0, device="cpu"), (0.0,),
                                    modes=("central",)),
    lambda: bench_faults.degradation_sweep(n_pes=64, n_trials=2),
    lambda: bench_faults.fiveg_degradation(),
], ids=["simulate_faults", "simulate_robust_reference", "energy_reference",
        "degradation_curve", "bench_faults_sweep", "bench_faults_fiveg"])
def test_fault_entry_points_default_to_cuda_and_raise(call):
    _no_card()
    with pytest.raises(RuntimeError, match="cuda"):
        call()


@pytest.mark.parametrize("call", [
    lambda: fig4.run_sweep(n_trials=2),
    lambda: fig4.claim_c3(n_trials=1),
    lambda: bench_energy.energy_per_barrier(ns=(64,)),
    lambda: bench_energy.fiveg_energy(64),
    lambda: bench_multicluster.bench_machine(128),
    lambda: fig5.suite(),
    lambda: fig6.grid(),
    lambda: fig7.grid(),
    lambda: fig7.tuned_modes(),
    lambda: fig_placement.placement_tradeoff(),
    lambda: fig_placement.placed_5g(),
    lambda: fig_placement.banking_sensitivity(),
    lambda: fig_tuned_tree.tuned_vs_uniform(),
    lambda: fig_tuned_tree.tuned_5g(),
    lambda: fig_workload_tuned.workload_tuned_kernels(),
    lambda: fig_workload_tuned.workload_5g(),
    lambda: TuningServer(),
    lambda: TuningServer(ServerConfig(), start=False),
    lambda: bench_serving.measure(n=64),
    lambda: bench_resilience.measure(n=64),
    lambda: bench_core.measure(ns=(64,)),
    lambda: run.main(["serving"]),
], ids=["fig4_sweep", "claim_c3", "energy_per_barrier", "fiveg_energy",
        "multicluster", "fig5", "fig6", "fig7", "fig7_tuned_modes",
        "placement_tradeoff", "placed_5g", "banking_sensitivity",
        "tuned_vs_uniform", "tuned_5g", "workload_tuned_kernels",
        "workload_5g", "tuning_server", "tuning_server_unstarted",
        "bench_serving", "bench_resilience", "bench_core", "run_serving"])
def test_driver_entry_points_default_to_cuda_and_raise(call):
    _no_card()
    with pytest.raises(RuntimeError, match="cuda"):
        call()


_QWEN = configs.get_smoke("qwen3_4b")
_DEEPSEEK = configs.get_smoke("deepseek_v3_671b")
_MOONSHOT = configs.get_smoke("moonshot_v1_16b_a3b")
_FALCON = configs.get_smoke("falcon_mamba_7b")
_HYMBA = configs.get_smoke("hymba_1_5b")


def _jax_style_mla_cache():
    """A cache tree as the reference's (an ``MLACache`` of numpy)."""
    from repro_torch.models.mla import MLACache
    return {"layers": MLACache(*(np.zeros((1, 2, 4), np.float32),) * 2,
                               np.zeros((1, 2), np.int32))}


def _jax_style_hybrid_cache():
    """A hybrid cache tree as the reference's (a dict of a ``KVCache`` and
    an ``SSMCache`` of numpy)."""
    from repro_torch.models.attention import KVCache
    from repro_torch.models.ssm import SSMCache
    return {"layers": {
        "attn": KVCache(*(np.zeros((1, 2, 4, 1, 8), np.float32),) * 2,
                        np.zeros((1, 2, 4), np.int32)),
        "ssm": SSMCache(np.zeros((1, 2, 3, 8), np.float32),
                        np.zeros((1, 2, 8, 4), np.float32))}}


@pytest.mark.parametrize("call", [
    lambda: init_caches(_QWEN, 1, 8),
    lambda: steps.build_prefill_step(_QWEN, batch=1, seq_len=8),
    lambda: steps.build_decode_step(_QWEN, batch=1, max_len=8),
    lambda: convert.from_jax_params({"w": torch.zeros(2).numpy()}),
    lambda: serve_lm.serve(_QWEN, batch=1, prompt_len=4, tokens=2),
    lambda: init_caches(_DEEPSEEK, 1, 8),
    lambda: steps.build_prefill_step(_DEEPSEEK, batch=1, seq_len=8),
    lambda: serve_lm.serve(_DEEPSEEK, batch=1, prompt_len=4, tokens=2),
    lambda: serve_lm.serve(_MOONSHOT, batch=1, prompt_len=4, tokens=2),
    lambda: convert.caches_from_jax(_jax_style_mla_cache()),
    lambda: init_caches(_FALCON, 1, 8),
    lambda: init_caches(_HYMBA, 1, 8),
    lambda: steps.build_prefill_step(_FALCON, batch=1, seq_len=8),
    lambda: steps.build_decode_step(_HYMBA, batch=1, max_len=8),
    lambda: serve_lm.serve(_FALCON, batch=1, prompt_len=4, tokens=2),
    lambda: serve_lm.serve(_HYMBA, batch=1, prompt_len=4, tokens=2),
    lambda: convert.caches_from_jax(_jax_style_hybrid_cache()),
], ids=["init_caches", "build_prefill_step", "build_decode_step",
        "from_jax_params", "serve", "init_caches_mla",
        "build_prefill_step_mla", "serve_mla", "serve_moe",
        "caches_from_jax", "init_caches_ssm", "init_caches_hybrid",
        "build_prefill_step_ssm", "build_decode_step_hybrid", "serve_ssm",
        "serve_hybrid", "caches_from_jax_hybrid"])
def test_lm_entry_points_default_to_cuda_and_raise(call):
    _no_card()
    with pytest.raises(RuntimeError, match="cuda"):
        call()
