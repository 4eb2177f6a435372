"""Port parity: the 5G slot of ``examples/fiveg_pipeline.py`` (OFDM
demodulation by ``ops.fft4``, beamforming by two ``ops.matmul``) against
the JAX package's kernels on the same numpy inputs, on the CPU, where the
port's wrappers take their plain versions and the reference's Pallas
kernels run in interpret mode.  Tolerances are the reference's kernel
tests': rtol 1e-3 and atol 2e-3 for the FFT, rtol 1e-4 and atol 1e-4
sqrt(K) for the product.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.examples import fiveg_pipeline
from repro_torch.kernels import fft4, matmul

# (n_rx, n_sc, n_beams, n_symbols): antennas, sub-carriers, beams, symbols.
SMALL = [(4, 64, 3, 2), (8, 256, 4, 1)]


@pytest.mark.parametrize("n_rx,n_sc,n_beams,n_symbols", SMALL)
def test_slot_matches_reference_kernels(n_rx, n_sc, n_beams, n_symbols):
    re, im, coef = fiveg_pipeline.make_inputs(n_rx, n_sc, n_beams,
                                              n_symbols, seed=3)
    got = fiveg_pipeline.slot(*(torch.from_numpy(a)
                                for a in (re, im, coef)))
    jr, ji = jops.fft4(jnp.asarray(re), jnp.asarray(im))
    for name, want in (("fr", jr), ("fi", ji)):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want),
                                   rtol=1e-3, atol=2e-3, err_msg=name)
    cols = n_symbols * n_sc
    for name, spec in (("beams_r", got["fr"]), ("beams_i", got["fi"])):
        want = jops.matmul(jnp.asarray(coef),
                           jnp.asarray(spec.numpy().reshape(n_rx, cols)))
        assert got[name].shape == (n_beams, cols)
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4 * n_rx ** 0.5,
                                   err_msg=name)


@pytest.mark.parametrize("n_rx,n_sc,n_beams,n_symbols", SMALL)
def test_execute_is_make_inputs_then_slot(n_rx, n_sc, n_beams, n_symbols):
    """``execute`` makes its inputs with numpy from the seed and runs
    ``slot`` on them: the same bits as calling the two apart, and its
    outputs pass ``check`` against numpy in complex128."""
    out = fiveg_pipeline.execute(n_rx, n_sc, n_beams, n_symbols, seed=5,
                                 device="cpu")
    inputs = fiveg_pipeline.make_inputs(n_rx, n_sc, n_beams, n_symbols,
                                        seed=5)
    for name, a in zip(("re", "im", "coef"), inputs):
        assert np.array_equal(out[name], a), name
    apart = fiveg_pipeline.slot(*(torch.from_numpy(a) for a in inputs))
    for name, t in apart.items():
        assert torch.equal(out[name], t), name
    errs = fiveg_pipeline.check(out)
    assert set(errs) == {"fft", "beams_r", "beams_i"}


def test_slot_on_cpu_tensors_launches_no_kernel():
    before = (fft4.LAUNCHES, fft4.FUSED_LAUNCHES, matmul.LAUNCHES)
    fiveg_pipeline.slot(*(torch.from_numpy(a) for a in
                          fiveg_pipeline.make_inputs(4, 64, 3, 2)))
    assert (fft4.LAUNCHES, fft4.FUSED_LAUNCHES, matmul.LAUNCHES) == before
