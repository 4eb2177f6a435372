"""Port parity: the port's kernels (the 5G pipeline's FFT stage and
matmul, the Fig. 5/6 dot product, AXPY, DCT and Conv2D, and the C library
``powf``) against the JAX package, at
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
from repro_torch.kernels import (_build, axpy, conv2d, dct, dotp, fft4,
                                 flash_attn, matmul, ops, powf, ref)

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
                                   (256, 512, 128), (129, 257, 65),
                                   (32, 64, 57344)])
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
        "axpy", "conv2d", "dct", "dotp", "fft4_stage", "flash_attn",
        "flash_attn_bwd", "matmul", "powf", "ssm_scan"]


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


@pytest.mark.parametrize("n", [1, 2, 31, 32, 33, 2048, 5000])
@pytest.mark.parametrize("radix", [2, 3, 32, 1024])
def test_combine_tree_plain_equals_the_level_chains(n, radix):
    """The tree's plain version is the chain of ``ref.combine_partials``
    levels, bit for bit, and agrees with JAX's chain of Pallas
    ``combine_partials`` launches (interpret mode) to float32 rounding of
    another summation order: 1e-6 of the sum of |partial|."""
    parts = _arr((n,))
    before = dict(dotp.LAUNCHES)
    got = dotp.combine_tree(torch.from_numpy(parts), radix)
    assert dotp.LAUNCHES == before      # CPU: the plain version
    assert got.shape == () and got.dtype == torch.float32
    chain = torch.from_numpy(parts)
    while chain.numel() > 1:
        chain = ref.combine_partials(chain, radix)
    assert torch.equal(got, chain[0])
    assert torch.equal(dotp.combine_tree_plain(torch.from_numpy(parts),
                                               radix), got)
    jchain = jnp.asarray(parts[:, None])
    while jchain.shape[0] > 1:
        jchain = jdotp.combine_partials(jchain, radix)
    np.testing.assert_allclose(got.item(), float(jchain[0, 0]), rtol=0,
                               atol=1e-6 * np.abs(parts).sum())


@pytest.mark.parametrize("n", [1, 40000, 70001, 1 << 20])
@pytest.mark.parametrize("radix", [2, 3, 32, 1024])
def test_dotp_on_cpu_tensors_is_the_plain_level_chain(n, radix):
    """On CPU tensors ``ops.dotp`` at radix > 1 is the plain leaves and
    the plain level chain, bit for bit, and counts no launch."""
    x, y = torch.from_numpy(_arr((n,))), torch.from_numpy(_arr((n,)))
    before = dict(dotp.LAUNCHES)
    got = ops.dotp(x, y, radix=radix)
    assert dotp.LAUNCHES == before
    parts = ref.dotp_partials(x, y)
    while parts.numel() > 1:
        parts = ref.combine_partials(parts, radix)
    assert got.shape == () and torch.equal(got, parts[0])


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
    with pytest.raises(ValueError, match="radix"):
        dotp.combine_tree(parts, 1)
    with pytest.raises(ValueError, match="shape"):
        dotp.combine_tree(parts[:0], 2)
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


class _ChainMatmul:
    """Stand-ins for the matmul kernel on the CPU: ``matmul`` sums k in
    order, one float32 multiply and add per step, so every slice of a
    call is that call's bits; ``split`` sums the two halves of k apart
    when x has more than 32 rows, so row slices differ."""

    @staticmethod
    def matmul(x, w):
        out = torch.zeros(x.shape[0], w.shape[1])
        for k in range(x.shape[1]):
            out = out + x[:, k:k + 1] * w[k:k + 1]
        return out

    @staticmethod
    def split(x, w):
        if x.shape[0] <= 32:
            return _ChainMatmul.matmul(x, w)
        h = x.shape[1] // 2
        return (_ChainMatmul.matmul(x[:, :h], w[:h])
                + _ChainMatmul.matmul(x[:, h:], w[h:]))


def test_chip_smoke_matmul_layout_check_holds_a_chain_and_catches_a_split():
    """chip_smoke.py's row, column and offset-view identities for the
    matmul kernel pass a product summed in k order and fail one whose
    sum order depends on the row count (split-K above 32 rows)."""
    smoke = _chip_smoke()
    rec = smoke.matmul_layout_checks(torch, _ChainMatmul,
                                     torch.Generator().manual_seed(17))
    assert rec["rows"] == [1, 31, 32, 33] and len(rec["views"]) == 3
    split = type("Split", (), {"matmul": staticmethod(_ChainMatmul.split)})
    with pytest.raises(AssertionError, match="slices differ"):
        smoke.matmul_layout_checks(torch, split,
                                   torch.Generator().manual_seed(17))


def test_chip_smoke_slot_bound_adds_its_kernels_work():
    """The 5G slot's bound counts the FFT's planes and twiddles and both
    products' bytes once: 0.0307 ms at 3.35 TB/s for the 896 x 4096
    slot, the FFT's 0.0175 plus twice the product's 0.0066."""
    smoke = _chip_smoke()
    fft_b, _ = smoke.fft_work(896, 4096)
    mm_b, mm_f = smoke.matmul_work(32, 64, 57344, 4)
    assert fft_b == 4 * 896 * 4096 * 4 + 2 * 4095 * 4
    assert (mm_b, mm_f) == ((32 * 64 + 64 * 57344 + 32 * 57344) * 4,
                            2.0 * 32 * 64 * 57344)
    b, f = smoke.slot_work(896, 4096, 32, 64)
    assert (b, f) == (fft_b + 2 * mm_b, smoke.fft_work(896, 4096)[1]
                      + 2 * mm_f)
    ms, by = smoke.bound(b, f, "float32")
    assert by == "bytes" and 0.0306 < ms < 0.0308


@pytest.mark.parametrize("d,causal", [(80, False), (192, True)])
def test_chip_smoke_bf16_row_check_catches_planted_faults(d, causal):
    """chip_smoke.py's bf16 attention check (each query row's error over
    its largest output, against float32 attention on the same bf16
    inputs) passes the plain bf16 version and fails its three planted
    faults, on the plain path at hubert's (D 80) and nemotron's (D 192)
    widths, 256 keys."""
    smoke = _chip_smoke()
    gen = torch.Generator().manual_seed(d)
    q = torch.randn(1, 4, 256, d, generator=gen).bfloat16()
    k, v = (torch.randn(1, 2, 256, d, generator=gen).bfloat16()
            for _ in range(2))
    got = flash_attn.flash_attention(q, k, v, causal=causal)
    rows = smoke.check_bf16_rows(flash_attn, q, k, v, causal, got, got)
    assert 0 < rows["row_scaled_err"] <= smoke.FA_BF16_ROW_TOL
    faults = smoke.fa_planted_faults(flash_attn, q, k, v, causal, got, got)
    assert sorted(faults) == ["out_last_16_zeroed", "pv_tile_skipped",
                              "qk_last_k16_dropped"]
    assert all(f["row_scaled_err"] > smoke.FA_BF16_ROW_TOL
               for f in faults.values())


@pytest.mark.parametrize("hw", [(8, 8), (16, 20), (32, 32)])
def test_conv2d_vs_reference(hw):
    """``ops.conv2d`` against the reference's Pallas kernel (interpret
    mode) and its jnp oracle, at tests/test_kernels.py's shapes and
    tolerance."""
    img, kern = _arr((3, *hw)), _arr((3, 3))
    got = ops.conv2d(torch.from_numpy(img), torch.from_numpy(kern))
    assert got.dtype == torch.float32 and got.shape == (3, *hw)
    for want in (jops.conv2d(jnp.asarray(img), jnp.asarray(kern)),
                 jref.conv2d(jnp.asarray(img), jnp.asarray(kern))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("n", [8, 64, 256])
def test_dct_vs_reference(n):
    """``ops.dct`` against the reference's Pallas kernel (interpret mode)
    and its jnp oracle, at tests/test_kernels.py's shapes and
    tolerance."""
    x = _arr((33, n))
    got = ops.dct(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (33, n)
    for want in (jops.dct(jnp.asarray(x)), jref.dct(jnp.asarray(x))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                                   atol=1e-3)
        np.testing.assert_allclose(ref.dct(torch.from_numpy(x)).numpy(),
                                   np.asarray(want), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("n", [32, 1000, 4096])
def test_dct_basis_orthonormal_and_float32_like_reference(n):
    """The basis is orthonormal and is the reference's float32 basis:
    its angles are rounded to float32 as the reference rounds them (a
    float64 basis would differ by about 1e-3 at n = 4096)."""
    b = ref.dct_basis(n, device="cpu")
    assert b.dtype == torch.float32
    want = np.asarray(jref.dct_basis(n))
    np.testing.assert_allclose(b.numpy(), want, rtol=0, atol=1e-6)
    if n == 32:
        np.testing.assert_allclose((b @ b.T).numpy(), np.eye(n), atol=1e-5)
    elif n == 4096:
        k = np.arange(n, dtype=np.float64)[:, None]
        i = np.arange(n, dtype=np.float64)[None, :]
        exact = np.cos(np.pi * (2 * i + 1) * k / (2 * n))
        exact *= np.where(k == 0, np.sqrt(1 / n), np.sqrt(2 / n))
        assert np.abs(exact - want).max() > 1e-5   # the hazard is real
    assert ops.dct_basis_t(n, torch.device("cpu")) is ops.dct_basis_t(
        n, torch.device("cpu"))


def test_dct_conv2d_plain_twins_and_validation():
    """The wrappers take their plain versions on the CPU without
    counting, and validate shapes and types like the other kernels."""
    before = (dct.LAUNCHES, conv2d.LAUNCHES, powf.LAUNCHES)
    x = torch.from_numpy(_arr((5, 16)))
    bt = ops.dct_basis_t(16, torch.device("cpu"))
    assert torch.equal(dct.dct(x, bt), dct.dct_plain(x, bt))
    assert torch.equal(dct.dct(x.to(torch.bfloat16), bt),
                       dct.dct_plain(x.to(torch.bfloat16).float(), bt))
    img, k = torch.from_numpy(_arr((2, 9, 7))), torch.from_numpy(_arr((3, 3)))
    assert torch.equal(conv2d.conv2d(img, k), conv2d.conv2d_plain(img, k))
    powf.powf(torch.ones(4), 2.0)
    assert (dct.LAUNCHES, conv2d.LAUNCHES, powf.LAUNCHES) == before
    with pytest.raises(ValueError, match=r"basis_t \(n, n\)"):
        dct.dct(x, bt[:8])
    with pytest.raises(TypeError, match="float32 basis"):
        dct.dct(x, bt.double())
    with pytest.raises(ValueError, match=r"\(3, 3\) kernel"):
        conv2d.conv2d(img, k[:2])
    with pytest.raises(ValueError, match=r"\(B, H, W\)"):
        conv2d.conv2d(img[0], k)
    with pytest.raises(TypeError, match="float32 bases"):
        powf.powf(torch.ones(4, dtype=torch.float64), 2.0)


def test_powf_plain_is_the_c_library():
    """The plain powf is the host's C library ``powf``, one call per
    element, in one C loop; it agrees with the reference's XLA ``pow``
    on every base of a sample spanning the Pareto tail's range."""
    import ctypes
    import ctypes.util
    import jax
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    lib.powf.argtypes = [ctypes.c_float, ctypes.c_float]
    lib.powf.restype = ctypes.c_float
    y = -1.0 / 1.5
    bases = np.geomspace(1e-10, 5e-5, 4099).astype(np.float32)
    bases = np.concatenate([bases, [0.0, 1.0, np.inf, 2.5e-42]]
                           ).astype(np.float32)
    got = powf.powf_plain(torch.from_numpy(bases), y).numpy()
    want = np.asarray([lib.powf(float(b), np.float32(y)) for b in bases],
                      np.float32)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    xla = np.asarray(jax.jit(lambda b: b ** (-1.0 / 1.5))(bases[:4099]))
    assert np.array_equal(got[:4099].view(np.int32), xla.view(np.int32))


def test_chip_smoke_kernel_tables_cover_every_kernel():
    """The summary line of chip_smoke.py names a source and a replaced
    site for every kernel it lists, and each source exists."""
    smoke = _chip_smoke()
    root = Path(__file__).resolve().parents[1]
    assert set(smoke.KERNELS) == set(smoke.SOURCES) == set(smoke.REPLACES)
    for name in smoke.KERNELS:
        assert (root / smoke.SOURCES[name]).is_file(), name
        path, line = smoke.REPLACES[name].split(":")
        assert (root / path).is_file() and int(line) > 0, name


@pytest.mark.parametrize("timing", ["eager", "graph"])
def test_chip_smoke_kernel_entry_says_how_it_was_timed(timing):
    """Every entry of the summary line carries the contract's keys and
    its timing method; a graph-timed entry also gives its eager times."""
    smoke = _chip_smoke()
    rec = {"max_abs_err": 0.0, "ms": 0.04, "plain_ms": 1.6,
           "bound_ms": 0.0175, "bound_by": "bytes", "library_ms": 0.08,
           "shape": [896, 4096]}
    if timing == "graph":
        rec.update(timing="graph", eager_ms=0.05, library_eager_ms=0.09)
    entry = smoke.kernel_entry("fft4_fused", rec, 1)
    assert {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"} \
        <= set(entry)
    assert entry["timing"] == timing and entry["launches"] == 1
    assert ("eager_ms" in entry) == (timing == "graph")
    if timing == "graph":
        assert (entry["eager_ms"], entry["library_eager_ms"]) == (0.05, 0.09)


def test_chip_smoke_pareto_range_covers_the_model():
    """The powf check's base range holds every base the Pareto tail
    passes to ``powf`` at 64, 256 and 1024 PEs."""
    from repro_torch.core import workloads
    smoke = _chip_smoke()
    first, last = smoke.pareto_base_range(workloads)
    seen = []
    for n in (64, 256, 1024):
        work = ((1 << 18) / n) * workloads.COSTS.axpy_per_elem
        c = np.float32(work ** -1.5)
        d = np.float32(work ** -1.5 - (256 * work) ** -1.5)
        u = np.concatenate([np.linspace(0, 1, 1001, dtype=np.float32)[:-1],
                            [np.nextafter(np.float32(1), np.float32(0))]])
        seen.append(c - u * d)
    bits = np.concatenate(seen).astype(np.float32).view(np.int32)
    assert first <= bits.min() and bits.max() <= last
