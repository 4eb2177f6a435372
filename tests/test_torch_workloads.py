"""Port parity: the Fig. 5/6 arrival models against the JAX package.

Every ``ARRIVAL_KERNELS`` entry's ``arrival_batch`` must equal the
reference's bit for bit (the normal draws, XLA's ``exp`` and the C
library's ``powf`` included), at the full 1024-PE width and on a
re-scaled 64-PE machine, and so must the single-key samplers of the
benchmark suite and the Fig. 5 summary statistic.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import fiveg as jfiveg
from repro.core import workloads as jworkloads
from repro_torch.core import fiveg, prng, workloads


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


def test_registries_match():
    assert workloads.FIG6_KERNELS == jworkloads.FIG6_KERNELS
    assert workloads.ARRIVAL_KERNELS == jworkloads.ARRIVAL_KERNELS
    assert ([(f.name, f.default)
             for f in dataclasses.fields(workloads.KernelCosts)]
            == [(f.name, f.default)
                for f in dataclasses.fields(jworkloads.KernelCosts)])


@pytest.mark.parametrize("kernel", jworkloads.ARRIVAL_KERNELS)
@pytest.mark.parametrize("shape", [(3, 1024), (4, 64)])
def test_arrival_batch_bit_exact(kernel, shape):
    seed = 1 + jworkloads.ARRIVAL_KERNELS.index(kernel)
    want = jworkloads.arrival_batch(jax.random.PRNGKey(seed), kernel, shape)
    got = workloads.arrival_batch(prng.PRNGKey(seed, device="cpu"), kernel,
                                  shape)
    assert got.shape == shape and got.dtype == torch.float32
    assert np.array_equal(_bits(got), _bits(want))


def test_fiveg_epoch_models_follow_the_app_config():
    japp = jfiveg.FiveGConfig(n_rx=16, ffts_per_round=1)
    tapp = fiveg.FiveGConfig(n_rx=16, ffts_per_round=1)
    for kernel in ("fiveg_fft_stage", "fiveg_matmul_row"):
        want = jworkloads.arrival_batch(jax.random.PRNGKey(5), kernel,
                                        (2, 1024), app=japp)
        got = workloads.arrival_batch(prng.PRNGKey(5, device="cpu"), kernel,
                                      (2, 1024), app=tapp)
        assert np.array_equal(_bits(got), _bits(want))


def test_suite_samplers_and_fig5_gap_bit_exact():
    jkey, tkey = jax.random.PRNGKey(1), prng.PRNGKey(1, device="cpu")
    jsuite, tsuite = jworkloads.benchmark_suite(), workloads.benchmark_suite()
    assert list(tsuite) == list(jsuite)
    for kernel, dims in jsuite.items():
        assert list(tsuite[kernel]) == list(dims)
        for label, fn in dims.items():
            want = fn(jkey)
            got = tsuite[kernel][label](tkey)
            assert np.array_equal(_bits(got), _bits(want)), (kernel, label)
            assert (workloads.cdf_first_last_gap(got).item()
                    == float(jworkloads.cdf_first_last_gap(want)))


def test_validation():
    key = prng.PRNGKey(0, device="cpu")
    with pytest.raises(ValueError, match="unknown arrival kernel"):
        workloads.arrival_batch(key, "nope", (2, 64))
    with pytest.raises(ValueError, match="at least one trial"):
        workloads.arrival_batch(key, "axpy_1Mi", (0, 64))
    with pytest.raises(ValueError, match="frac"):
        workloads.straggler_arrivals(key, 1024, frac=0.0)
    with pytest.raises(ValueError, match="tail"):
        workloads.straggler_arrivals(key, 1024, tail="cauchy")


@pytest.mark.parametrize("model", [
    dict(p_fail=0.02, p_straggler=0.1, straggler_scale=2000.0),
    dict(p_stall=0.3, stall_cycles=1234.5),
    dict(p_straggler=0.5, straggler_sigma=2.0),
    dict(p_fail=0.05, p_stall=0.05, p_straggler=0.05)])
def test_apply_faults_bit_exact(model):
    """Stragglers (lognormal through XLA's ``exp``), stalls and fail-stops
    drawn over a (kernel, trial, PE) batch equal the reference's."""
    arr = (np.random.default_rng(1).random((2, 3, 64)) * 500).astype(
        np.float32)
    want = jworkloads.apply_faults(jax.random.PRNGKey(7), arr,
                                   jworkloads.PEFaultModel(**model))
    got = workloads.apply_faults(prng.PRNGKey(7, device="cpu"),
                                 torch.from_numpy(arr),
                                 workloads.PEFaultModel(**model))
    assert got.dtype == torch.float32
    assert np.array_equal(_bits(got), _bits(want))


def test_fault_mask_and_model_defaults():
    want = jworkloads.fault_mask(jax.random.PRNGKey(3), 1024, 0.05)
    got = workloads.fault_mask(prng.PRNGKey(3, device="cpu"), 1024, 0.05)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert ([(f.name, f.default)
             for f in dataclasses.fields(workloads.PEFaultModel)]
            == [(f.name, f.default)
                for f in dataclasses.fields(jworkloads.PEFaultModel)])
    arr = torch.arange(64, dtype=torch.float32)
    assert torch.equal(workloads.apply_faults(
        prng.PRNGKey(0, device="cpu"), arr, workloads.NO_PE_FAULTS), arr)
    with pytest.raises(ValueError, match="p_fail"):
        workloads.PEFaultModel(p_fail=1.5)
    with pytest.raises(ValueError, match="p_straggler"):
        workloads.PEFaultModel(p_straggler=-0.1)
