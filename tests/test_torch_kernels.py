"""Port parity: the port's kernels (the 5G pipeline's FFT stage and
matmul, the Fig. 5/6 dot product and AXPY) against the JAX package, at
the shapes and tolerances of tests/test_kernels.py.  On the CPU the
wrappers run their plain PyTorch versions (the CUDA kernels are held
against those on the card by chip_smoke.py and tests/test_torch_cuda.py).
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dotp as jdotp
from repro.kernels import fft4 as jfft4
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build, axpy, dotp, fft4, matmul, ops, ref

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
    before = (fft4.LAUNCHES, matmul.LAUNCHES, axpy.LAUNCHES,
              dict(dotp.LAUNCHES))
    ops.fft4(torch.ones(2, 64), torch.zeros(2, 64))
    ops.matmul(torch.ones(3, 4), torch.ones(4, 5))
    ops.axpy(2.0, torch.ones(40000), torch.ones(40000))
    for radix in (0, 2):
        ops.dotp(torch.ones(40000), torch.ones(40000), radix=radix)
    assert (fft4.LAUNCHES, matmul.LAUNCHES, axpy.LAUNCHES,
            dict(dotp.LAUNCHES)) == before


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
        "axpy", "dotp", "fft4_stage", "matmul"]


def test_missing_compiler_raises(monkeypatch, tmp_path):
    """A build that cannot run nvcc raises; nothing falls back."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "nvcc_path",
                        lambda: str(tmp_path / "missing" / "nvcc"))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load("dotp", {})
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("n", [64, 1000, 4096, 10000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_axpy_vs_reference(n, dtype):
    """``ops.axpy`` against the reference's Pallas kernel (interpret
    mode) at tests/test_kernels.py's shapes and tolerances."""
    xs, ys = _arr((n,)), _arr((n,))
    x = torch.from_numpy(xs).to(getattr(torch, dtype))
    y = torch.from_numpy(ys).to(getattr(torch, dtype))
    got = ops.axpy(1.7, x, y)
    assert got.dtype == x.dtype and got.shape == (n,)
    want = jops.axpy(1.7, jnp.asarray(x.float().numpy()).astype(dtype),
                     jnp.asarray(y.float().numpy()).astype(dtype))
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("n", [128, 1000, 8192])
@pytest.mark.parametrize("radix", [0, 2, 4, 16])
def test_dotp_vs_reference(n, radix):
    x, y = _arr((n,)), _arr((n,))
    got = ops.dotp(torch.from_numpy(x), torch.from_numpy(y), radix=radix)
    assert got.shape == () and got.dtype == torch.float32
    want = jops.dotp(jnp.asarray(x), jnp.asarray(y), radix=radix)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)
    np.testing.assert_allclose(got.item(), float(jref.dotp(x, y)),
                               rtol=1e-4)


@pytest.mark.parametrize("n", [333, 5 * 333, 40000, 70001])
@pytest.mark.parametrize("radix", [2, 4, 16, 64])
def test_dotp_tree_equals_central(n, radix):
    """The barrier radix never changes the result (the reference's
    property test), on the plain paths."""
    x, y = torch.from_numpy(_arr((n,))), torch.from_numpy(_arr((n,)))
    np.testing.assert_allclose(ops.dotp(x, y, radix=0).item(),
                               ops.dotp(x, y, radix=radix).item(),
                               rtol=1e-5)


@pytest.mark.parametrize("n", [128, 1000, 8192, 1 << 20])
def test_dotp_leaf_and_level_counts_match_reference(n):
    """The tree over ``n`` elements has the reference's leaves (one per
    (256, 128) tile of its 128-lane view) and, at every radix, its
    number of combine levels."""
    rows = -(-n // 128)
    tiles = -(-rows // min(jdotp.TILE_ROWS, rows))
    assert dotp.leaf_count(n) == tiles
    assert ref.DOTP_LEAF == jdotp.TILE_ROWS * jdotp.TILE_COLS
    x = torch.ones(n)
    assert dotp.dotp_partials(x, x).shape == (tiles,)
    for radix in (2, 4, 16, 32, 1024):
        parts, levels = jnp.ones((tiles, 1)), 0
        while parts.shape[0] > 1:
            parts = jdotp.combine_partials(parts, radix)
            levels += 1
        assert ops.dotp_levels(n, radix) == levels
        assert float(parts[0, 0]) == float(tiles)
    assert ops.dotp_levels(n, 0) == ops.dotp_levels(n, 1) == 0
    if n == 1 << 20:
        assert tiles == 32


def test_dotp_plain_twins():
    x, y = torch.from_numpy(_arr((70001,))), torch.from_numpy(_arr((70001,)))
    parts = dotp.dotp_partials(x, y)
    assert parts.shape == (3,)
    torch.testing.assert_close(parts[0], (x[:32768] * y[:32768]).sum())
    torch.testing.assert_close(dotp.combine_partials(parts, 2),
                               torch.stack([parts[:2].sum(), parts[2]]))
    torch.testing.assert_close(dotp.dotp_central(x, y), parts.sum())
    with pytest.raises(ValueError, match="radix"):
        dotp.combine_partials(parts, 1)
    with pytest.raises(ValueError, match="shape"):
        ops.dotp(x, y[:5])
    with pytest.raises(ValueError, match="at least one"):
        ops.dotp(x[:0], y[:0])
    with pytest.raises(ValueError, match="shape"):
        ops.axpy(1.0, x, y[:5])


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n", [(1 << 20) + 5, 1 << 22])
def test_chip_smoke_dotp_checks_catch_a_zeroed_leaf(n):
    """chip_smoke.py's dot-product limits pass the plain results and fail
    one leaf zeroed, in the partials and in the central sum, on the
    plain paths at up to 128 leaves."""
    smoke = _chip_smoke()
    x, y = torch.from_numpy(_arr((n,))), torch.from_numpy(_arr((n,)))
    parts, plain = dotp.dotp_partials(x, y), ref.dotp_partials(x, y)
    leaf_lim, sum_lim = smoke.dotp_limits(ref, x, y)
    assert leaf_lim.shape == parts.shape == (dotp.leaf_count(n),)
    assert smoke.check_leaves(parts, plain, leaf_lim, "plain")[1] <= 1.0
    central = dotp.dotp_central(x, y).item()
    smoke.check_sum(central, ref.dotp(x, y).item(), sum_lim, "plain")
    fault = smoke.planted_leaf_fault(ref, x, y, parts, central)
    assert fault["caught"] == {"dotp_partials": True, "dotp_central": True}
    assert abs(fault["leaf_sum"]) > sum_lim
