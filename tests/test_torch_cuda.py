"""The port on the card: each CUDA kernel against its plain version, and
the simulator on the GPU against itself on the CPU.  Every test here
needs a CUDA device and skips without one; run them on the GPU machine
with ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import fiveg, prng, sweep
from repro_torch.kernels import _build, axpy, dotp, fft4, matmul, ops, ref

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


def _pair(cuda, n, dtype, seed, offset=0):
    """Two operands of ``n`` elements; ``offset`` > 0 shifts their base
    pointers off 16-byte alignment (the kernels' scalar path)."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(n + offset, device=cuda, generator=gen).to(dtype)
    y = torch.randn(n + offset, device=cuda, generator=gen).to(dtype)
    return x[offset:], y[offset:]


def _dotp_limits(x, y):
    """Each leaf's partial within 1e-5 of its own sum |x_i y_i| (s_j);
    a whole dot product within 1e-5 * sqrt(sum_j s_j^2), the leaves'
    limits combined as independent errors."""
    leaf = 1e-5 * ref.dotp_partials(x.abs(), y.abs())
    return leaf, leaf.square().sum().sqrt().item()


@pytest.mark.parametrize("n", [1, 100, 32768, 32769, 1000003, 1 << 20])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1])
def test_dotp_leaf_and_central_kernels_match_plain(cuda, n, dtype, offset):
    x, y = _pair(cuda, n, dtype, n + offset, offset)
    leaf_lim, sum_lim = _dotp_limits(x, y)
    before = dict(dotp.LAUNCHES)
    parts = dotp.dotp_partials(x, y)
    assert parts.shape == (dotp.leaf_count(n),)
    assert ((parts - dotp.dotp_partials_plain(x, y)).abs()
            <= leaf_lim).all()
    central = dotp.dotp_central(x, y)
    assert central.shape == () and central.dtype == torch.float32
    assert abs(central.item() - dotp.dotp_central_plain(x, y).item()) <= \
        sum_lim
    assert dotp.LAUNCHES["dotp_partials"] == before["dotp_partials"] + 1
    assert dotp.LAUNCHES["dotp_central"] == before["dotp_central"] + 1


@pytest.mark.parametrize("n", [1, 5, 32, 33, 2048, 100000])
@pytest.mark.parametrize("radix", [2, 3, 32, 1024, 4096])
def test_combine_partials_kernel_matches_plain(cuda, n, radix):
    gen = torch.Generator(device=cuda).manual_seed(n * radix)
    parts = torch.randn(n, device=cuda, generator=gen)
    got = dotp.combine_partials(parts, radix)
    want = dotp.combine_partials_plain(parts, radix)
    assert got.shape == want.shape == (-(-n // radix),)
    assert ((got - want).abs()
            <= 1e-6 * dotp.combine_partials_plain(parts.abs(), radix)).all()


@pytest.mark.parametrize("n", [128, 1000, 8192, 1 << 20])
@pytest.mark.parametrize("radix", [0, 2, 4, 16, 32, 1024])
def test_dotp_chain_launches_and_matches_plain(cuda, n, radix):
    x, y = _pair(cuda, n, torch.float32, radix)
    before = sum(dotp.LAUNCHES.values())
    got = ops.dotp(x, y, radix=radix)
    assert sum(dotp.LAUNCHES.values()) == before + 1 + ops.dotp_levels(
        n, radix)
    assert abs(got.item() - ref.dotp(x, y).item()) <= _dotp_limits(x, y)[1]


@pytest.mark.parametrize("n", [1, 7, 4096, (1 << 20) + 3])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("offset", [0, 1])
def test_axpy_kernel_matches_plain(cuda, n, dtype, tol, offset):
    x, y = _pair(cuda, n, dtype, 7 * n + offset, offset)
    before = axpy.LAUNCHES
    got = ops.axpy(1.7, x, y)
    assert axpy.LAUNCHES == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), axpy.axpy_plain(1.7, x, y).float(),
                               rtol=tol, atol=tol)


def test_new_kernels_reject_other_dtypes(cuda):
    x = torch.ones(64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        ops.dotp(x, x)
    with pytest.raises(TypeError):
        ops.axpy(2.0, x, x)
    with pytest.raises(TypeError):
        dotp.combine_partials(x, 4)


def test_failed_build_raises_instead_of_falling_back(cuda, monkeypatch,
                                                     tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "nvcc_path",
                        lambda: str(tmp_path / "missing" / "nvcc"))
    x = torch.ones(64, device=cuda)
    with pytest.raises(RuntimeError, match="nvcc"):
        ops.axpy(2.0, x, x)
    with pytest.raises(RuntimeError, match="nvcc"):
        ops.dotp(x, x, radix=4)
