"""The fused FFT's split of long rows, and ``ops.fft4`` run through it on
the CPU: the plan for every power of 4 up to 4^9 at the real ``L_MAX``
and at small ones, the plan's CPU path against the plain all-stage chain
bit for bit, and against the JAX package's ``fft4`` at
tests/test_kernels.py's tolerances.  The CUDA kernels behind it are held
against the same plain chain on the card (tests/test_torch_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import fft4, ops, ref
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
RNG = np.random.default_rng(15)


def _planes(rows, n, scale=1.0):
    return tuple(torch.from_numpy(
        (RNG.standard_normal((rows, n)) * scale).astype(np.float32))
        for _ in range(2))


def _stage_chain(re, im):
    """The plain stage chain over whole rows, one stage at a time."""
    n = re.shape[1]
    for s in range(fft4.log4(n)):
        re, im = fft4.fft4_stage_plain(re, im,
                                       *ops._stage_twiddles(n, s, CPU))
    return re, im


@pytest.mark.parametrize("stages", range(1, 10))
@pytest.mark.parametrize("l_max", [fft4.L_MAX, 64, 4])
def test_plan_splits_rows_longer_than_l_max(stages, l_max):
    n = 4 ** stages
    lead, length = fft4.fft4_plan(n, l_max)
    assert length == min(n, l_max)
    assert 4 ** lead * length == n
    assert lead == max(0, stages - fft4.log4(l_max))


def test_l_max_is_the_largest_power_of_4_whose_planes_fit_a_block():
    """re/im float32 planes of L points take 8 L bytes; a block of the
    H100 may hold 227 KB (232,448 bytes) of shared memory."""
    assert fft4.L_MAX == 4 ** 7
    assert 8 * fft4.L_MAX <= 232448 < 8 * 4 * fft4.L_MAX


@pytest.mark.parametrize("n,l_max", [(32, fft4.L_MAX), (64, 32), (64, 2),
                                     (0, 16)])
def test_plan_rejects_lengths_that_are_no_power_of_4(n, l_max):
    with pytest.raises(ValueError, match="power"):
        fft4.fft4_plan(n, l_max)


@pytest.mark.parametrize("n", [16, 64, 256, 1024, 4096])
@pytest.mark.parametrize("l_max", [4, 16, 64])
def test_cpu_path_through_the_plan_equals_the_stage_chain(n, l_max,
                                                          monkeypatch):
    """Leading stage launches, then the fused stages over the reshaped
    sub-transforms: bit for bit the plain chain over whole rows.  A small
    ``L_MAX`` drives the split at lengths the CPU runs quickly."""
    monkeypatch.setattr(fft4, "L_MAX", l_max)
    re, im = _planes(3, n)
    before = (fft4.LAUNCHES, fft4.FUSED_LAUNCHES)
    got = ops.fft4(re, im)
    assert (fft4.LAUNCHES, fft4.FUSED_LAUNCHES) == before   # CPU: plain
    want = _stage_chain(re, im)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("stages", [8, 9])
def test_rows_above_the_real_l_max_split_bit_for_bit(stages):
    """4^8 and 4^9 points at the real ``L_MAX``: one and two leading
    stages, then the fused stages over 16384-point sub-transforms."""
    n = 4 ** stages
    assert fft4.fft4_plan(n) == (stages - 7, fft4.L_MAX)
    re, im = _planes(2, n)
    got = ops.fft4(re, im)
    want = _stage_chain(re, im)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("n", [4, 16, 256, 4096])
def test_fused_plain_cuts_each_stage_from_the_table(n):
    wr, wi = ops.fused_twiddles(n, CPU)
    assert wr.shape == wi.shape == (n - 1,)
    off = 0
    for s in range(fft4.log4(n)):
        swr, swi = ops._stage_twiddles(n, s, CPU)
        q = swr.shape[1]
        assert torch.equal(wr[off:off + 3 * q].view(3, q), swr)
        assert torch.equal(wi[off:off + 3 * q].view(3, q), swi)
        off += 3 * q
    re, im = _planes(5, n)
    got = fft4.fft4_fused(re, im, wr, wi)
    want = _stage_chain(re, im)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("n", [16, 64, 256, 1024])
@pytest.mark.parametrize("l_max", [fft4.L_MAX, 16])
def test_fft4_through_the_plan_matches_jax_and_numpy(n, l_max, monkeypatch):
    monkeypatch.setattr(fft4, "L_MAX", l_max)
    re, im = _planes(3, n, 0.5)
    gr, gi = ops.fft4(re, im)
    jr, ji = jops.fft4(jnp.asarray(re.numpy()), jnp.asarray(im.numpy()))
    np.testing.assert_allclose(gr.numpy(), np.asarray(jr), rtol=1e-3,
                               atol=2e-3)
    np.testing.assert_allclose(gi.numpy(), np.asarray(ji), rtol=1e-3,
                               atol=2e-3)
    idx = ref.digit_reverse_indices(n, device="cpu").numpy()
    want = np.fft.fft(re.numpy() + 1j * im.numpy(), axis=-1)
    np.testing.assert_allclose(gr.numpy()[:, idx], want.real, rtol=1e-3,
                               atol=2e-3)
    np.testing.assert_allclose(gi.numpy()[:, idx], want.imag, rtol=1e-3,
                               atol=2e-3)


def test_fft4_of_one_point_is_the_point():
    re, im = _planes(2, 1)
    got = ops.fft4(re, im)
    assert torch.equal(got[0], re) and torch.equal(got[1], im)


def test_fused_wrapper_validates_arguments():
    wr, wi = ops.fused_twiddles(64, CPU)
    with pytest.raises(ValueError, match="power-of-4"):
        fft4.fft4_fused(torch.ones(2, 32), torch.ones(2, 32), wr[:31],
                        wi[:31])
    big = 4 * fft4.L_MAX
    with pytest.raises(ValueError, match="L <="):
        fft4.fft4_fused(torch.ones(1, big), torch.ones(1, big),
                        torch.ones(big - 1), torch.ones(big - 1))
    with pytest.raises(ValueError, match="twiddle table"):
        fft4.fft4_fused(torch.ones(2, 64), torch.ones(2, 64), wr[:10],
                        wi[:10])
    with pytest.raises(TypeError, match="float32"):
        fft4.fft4_fused(torch.ones(2, 64, dtype=torch.float64),
                        torch.ones(2, 64, dtype=torch.float64), wr, wi)
    with pytest.raises(ValueError, match="matching"):
        fft4.fft4_fused(torch.ones(2, 64), torch.ones(3, 64), wr, wi)
