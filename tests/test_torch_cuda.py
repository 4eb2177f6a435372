"""The port on the card: each CUDA kernel against its plain version, and
the simulator on the GPU against itself on the CPU.  Every test here
needs a CUDA device and skips without one; run them on the GPU machine
with ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import fiveg, prng, sweep
from repro_torch.kernels import fft4, matmul, ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [16, 256, 4096])
@pytest.mark.parametrize("rows", [3, 896])
def test_fft4_stage_kernel_matches_plain(cuda, n, rows):
    gen = torch.Generator(device=cuda).manual_seed(n + rows)
    re = torch.randn(rows, n, device=cuda, generator=gen)
    im = torch.randn(rows, n, device=cuda, generator=gen)
    before = fft4.LAUNCHES
    for s in range(int(round(np.log(n) / np.log(4)))):
        wr, wi = ops._stage_twiddles(n, s, cuda)
        kr, ki = fft4.fft4_stage(re, im, wr, wi)
        pr, pi = fft4.fft4_stage_plain(re, im, wr, wi)
        scale = max(pr.abs().max().item(), pi.abs().max().item())
        torch.testing.assert_close(kr, pr, rtol=0, atol=1e-5 * scale)
        torch.testing.assert_close(ki, pi, rtol=0, atol=1e-5 * scale)
        re, im = pr, pi
    assert fft4.LAUNCHES == before + int(round(np.log(n) / np.log(4)))


@pytest.mark.parametrize("shape", [(8, 16, 8), (100, 60, 72),
                                   (256, 512, 128), (129, 257, 65),
                                   (32, 64, 57344)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_kernel_matches_plain(cuda, shape, dtype):
    m, k, n = shape
    gen = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = torch.randn(m, k, device=cuda, generator=gen).to(dtype)
    w = torch.randn(k, n, device=cuda, generator=gen).to(dtype)
    before = matmul.LAUNCHES
    got = ops.matmul(x, w)
    assert matmul.LAUNCHES == before + 1
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, matmul.matmul_plain(x, w), rtol=1e-4,
                               atol=1e-4 * k ** 0.5)


def test_kernels_reject_other_dtypes(cuda):
    x = torch.ones(4, 4, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        ops.matmul(x, x)


def test_simulator_on_card_equals_cpu(cuda):
    key = prng.PRNGKey(0, device="cpu")
    app = fiveg.FiveGConfig(n_rx=16, ffts_per_round=4)
    for mode in ("central", "partial", "hw"):
        gpu = fiveg.simulate_app(key, app, sync=mode, device=cuda)
        cpu = fiveg.simulate_app(key, app, sync=mode, device="cpu")
        assert gpu.total_cycles.item() == cpu.total_cycles.item()
    gpu = sweep.sweep_barrier(key, n_pes=256, n_trials=8, device=cuda)
    cpu = sweep.sweep_barrier(key, n_pes=256, n_trials=8, device="cpu")
    assert torch.equal(gpu.span_cycles.cpu(), cpu.span_cycles)
