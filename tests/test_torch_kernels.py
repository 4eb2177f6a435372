"""Port parity: the 5G pipeline's kernels against the JAX package, at
the shapes and tolerances of tests/test_kernels.py.  On the CPU the
wrappers run their plain PyTorch versions (the CUDA kernels are held
against those on the card by chip_smoke.py and tests/test_torch_cuda.py).
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fft4 as jfft4
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build, fft4, matmul, ops, ref

RNG = np.random.default_rng(42)


def _arr(shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("n", [16, 64, 256, 1024])
def test_fft4_vs_numpy_and_reference(n):
    re, im = _arr((3, n), 0.5), _arr((3, n), 0.5)
    gr, gi = ops.fft4(torch.from_numpy(re), torch.from_numpy(im))
    assert gr.dtype == gi.dtype == torch.float32
    idx = ref.digit_reverse_indices(n, device="cpu").numpy()
    assert np.array_equal(idx, np.asarray(jref.digit_reverse_indices(n)))
    want = np.fft.fft(re + 1j * im, axis=-1)
    np.testing.assert_allclose(gr.numpy()[:, idx], want.real, rtol=1e-3,
                               atol=2e-3)
    np.testing.assert_allclose(gi.numpy()[:, idx], want.imag, rtol=1e-3,
                               atol=2e-3)
    jr, ji = jops.fft4(jnp.asarray(re), jnp.asarray(im))
    np.testing.assert_allclose(gr.numpy(), np.asarray(jr), rtol=1e-3,
                               atol=2e-3)
    np.testing.assert_allclose(gi.numpy(), np.asarray(ji), rtol=1e-3,
                               atol=2e-3)


@pytest.mark.parametrize("shape", [(8, 16, 8), (100, 60, 72),
                                   (256, 512, 128), (129, 257, 65)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_vs_reference(shape, dtype):
    m, k, n = shape
    x = torch.from_numpy(_arr((m, k))).to(getattr(torch, dtype))
    w = torch.from_numpy(_arr((k, n))).to(getattr(torch, dtype))
    got = ops.matmul(x, w)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    jx = jnp.asarray(x.float().numpy()).astype(dtype)
    jw = jnp.asarray(w.float().numpy()).astype(dtype)
    tol = 1e-4 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(jops.matmul(jx, jw)),
                               rtol=tol, atol=tol * k ** 0.5)


@pytest.mark.parametrize("n", [16, 256, 4096])
def test_stage_planes_match_complex_stage(n):
    """The plain re/im-plane stage (the kernel's twin) against the
    complex-arithmetic stage of ref.py, stage by stage."""
    re, im = torch.from_numpy(_arr((2, n))), torch.from_numpy(_arr((2, n)))
    for s in range(int(round(np.log(n) / np.log(4)))):
        wr, wi = ops._stage_twiddles(n, s, torch.device("cpu"))
        pr, pi = fft4.fft4_stage_plain(re, im, wr, wi)
        cr, ci = ref._fft4_stage(re, im, s, n)
        torch.testing.assert_close(pr, cr, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(pi, ci, rtol=1e-5, atol=1e-5)
        re, im = pr, pi


def test_stage_matches_reference_pallas_stage():
    """One stage against the reference's Pallas kernel (interpret mode),
    with the reference's twiddles."""
    n, s = 256, 1
    re, im = _arr((8, n)), _arr((8, n))
    jwr, jwi = jops._stage_twiddles(n, s)
    wr, wi = ops._stage_twiddles(n, s, torch.device("cpu"))
    np.testing.assert_allclose(wr.numpy(), np.asarray(jwr), atol=1e-6)
    np.testing.assert_allclose(wi.numpy(), np.asarray(jwi), atol=1e-6)
    jr, ji = jfft4.fft4_stage(jnp.asarray(re), jnp.asarray(im), jwr, jwi)
    gr, gi = fft4.fft4_stage(torch.from_numpy(re), torch.from_numpy(im),
                             wr, wi)
    np.testing.assert_allclose(gr.numpy(), np.asarray(jr), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(gi.numpy(), np.asarray(ji), rtol=1e-5,
                               atol=1e-5)


def test_cpu_tensors_take_the_plain_path_uncounted():
    before = (fft4.LAUNCHES, matmul.LAUNCHES)
    ops.fft4(torch.ones(2, 64), torch.zeros(2, 64))
    ops.matmul(torch.ones(3, 4), torch.ones(4, 5))
    assert (fft4.LAUNCHES, matmul.LAUNCHES) == before


def test_wrappers_validate_arguments():
    with pytest.raises(ValueError, match="power-of-4"):
        ops.fft4(torch.ones(2, 32), torch.ones(2, 32))
    wr, wi = ops._stage_twiddles(64, 0, torch.device("cpu"))
    with pytest.raises(TypeError, match="float32"):
        fft4.fft4_stage(torch.ones(2, 64, dtype=torch.float64),
                        torch.ones(2, 64, dtype=torch.float64), wr, wi)
    with pytest.raises(ValueError, match="twiddles"):
        fft4.fft4_stage(torch.ones(2, 64), torch.ones(2, 64), wr[:, :5],
                        wi[:, :5])
    with pytest.raises(ValueError, match=r"\(M, K\) @ \(K, N\)"):
        ops.matmul(torch.ones(3, 4), torch.ones(5, 6))
    with pytest.raises(ValueError, match="inner dimensions"):
        ref.matmul(torch.ones(3, 4), torch.ones(5, 6))


def test_plain_matmul_chunks_the_contraction(monkeypatch):
    """Chunking the K axis to bound memory leaves the product intact."""
    x, w = torch.from_numpy(_arr((5, 37))), torch.from_numpy(_arr((37, 6)))
    whole = ref.matmul(x, w)
    monkeypatch.setattr(ref, "_MM_CHUNK_ELEMS", 60)
    torch.testing.assert_close(ref.matmul(x, w), whole, rtol=1e-5,
                               atol=1e-5)


def test_build_targets_hopper(monkeypatch):
    """The kernels are built for sm_90a into a plain-C shared library
    under build/torch_ext, named by a digest of source and flags."""
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    root = Path(__file__).resolve().parents[1]
    assert _build.BUILD_DIR == root / "build" / "torch_ext"
    out = _build.library_path("matmul")
    assert out.parent == _build.BUILD_DIR and out.name.startswith("libmatmul-")
    cmd = _build.nvcc_command("matmul", out)
    assert cmd[0] == "nvcc" and cmd[-1].endswith("csrc/matmul.cu")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert {"-shared", "-O3", "-fPIC"} <= set(cmd)
    assert sorted(p.stem for p in _build.CSRC.glob("*.cu")) == [
        "fft4_stage", "matmul"]
