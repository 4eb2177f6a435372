"""The port on the card: each CUDA kernel against its plain version, and
the simulator on the GPU against itself on the CPU.  Every test here
needs a CUDA device and skips without one; run them on the GPU machine
with ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch
from attention_rows import bwd_from_records, row_errs

from repro_torch.core import barrier, fiveg, prng, sweep
from repro_torch.kernels import (_build, axpy, conv2d, dct, dotp, fft4,
                                 flash_attn, flash_attn_bwd, matmul, ops,
                                 powf, ref, ssm_scan, ssm_scan_bwd)
from repro_torch.models import attention

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
                                   (32, 64, 57344), (1, 64, 57344),
                                   (31, 64, 4096), (33, 64, 1000),
                                   (65, 100, 4100), (32, 64, 57343)])
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


def test_matmul_slices_equal_the_whole_call(cuda):
    """Every output is one fmaf chain in increasing k whatever block it
    falls in: the first t rows of a call equal the call on x[:t], and its
    first c columns the call on w[:, :c], bit for bit, on both sides of
    the 32 x 128 block tile and of a warp's 32 columns, and off the float4
    grid (c = 57343)."""
    gen = torch.Generator(device=cuda).manual_seed(17)
    x = torch.randn(65, 64, device=cuda, generator=gen)
    w = torch.randn(64, 57344, device=cuda, generator=gen)
    full = ops.matmul(x, w)
    for t in (1, 31, 32, 33):
        assert torch.equal(ops.matmul(x[:t], w), full[:t]), t
    for c in (5, 33, 127, 129, 1000, 57343):
        assert torch.equal(ops.matmul(x, w[:, :c]), full[:, :c]), c


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_offset_views_give_the_aligned_bits(cuda, dtype):
    """x as an offset row slice of a larger tensor, x one element off
    16-byte alignment, and w one element off it (the element-wise copy
    of w in place of cp.async) all give the aligned call's bits, and
    match the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(18)
    m, k, n = 32, 64, 4096
    big = torch.randn(m + 7, k, device=cuda, generator=gen).to(dtype)
    w = torch.randn(k, n, device=cuda, generator=gen).to(dtype)
    x = big[3:3 + m]
    full = ops.matmul(x.clone(), w)
    torch.testing.assert_close(full, matmul.matmul_plain(x, w), rtol=1e-4,
                               atol=1e-4 * k ** 0.5)
    assert torch.equal(ops.matmul(x, w), full)
    flat_x = torch.empty(m * k + 1, device=cuda, dtype=dtype)
    flat_x[1:].view(m, k).copy_(x)
    assert torch.equal(ops.matmul(flat_x[1:].view(m, k), w), full)
    flat_w = torch.empty(k * n + 1, device=cuda, dtype=dtype)
    flat_w[1:].view(k, n).copy_(w)
    assert torch.equal(ops.matmul(x, flat_w[1:].view(k, n)), full)


def test_fiveg_slot_launches_one_fft_and_two_matmuls(cuda):
    """The 5G slot on resident inputs: one fused FFT launch, no stage
    launch, two matmul launches, and the same bits as ``execute``."""
    from repro_torch.examples import fiveg_pipeline
    out = fiveg_pipeline.execute(device="cuda")
    inputs = [torch.from_numpy(out[k]).to(cuda) for k in ("re", "im",
                                                          "coef")]
    before = (fft4.FUSED_LAUNCHES, fft4.LAUNCHES, matmul.LAUNCHES)
    got = fiveg_pipeline.slot(*inputs)
    assert (fft4.FUSED_LAUNCHES - before[0], fft4.LAUNCHES - before[1],
            matmul.LAUNCHES - before[2]) == (1, 0, 2)
    for name in ("fr", "fi", "beams_r", "beams_i"):
        assert torch.equal(got[name], out[name]), name
    fiveg_pipeline.check(out)


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
    """The central accumulator is one launch; a tree is two below
    dotp.TREE_MAX leaves: the leaves, then every level in one launch."""
    x, y = _pair(cuda, n, torch.float32, radix)
    before = sum(dotp.LAUNCHES.values())
    got = ops.dotp(x, y, radix=radix)
    assert sum(dotp.LAUNCHES.values()) == before + (1 if radix <= 1 else 2)
    assert abs(got.item() - ref.dotp(x, y).item()) <= _dotp_limits(x, y)[1]


def _kernel_chain(parts, radix):
    """The tree as one combine_partials launch per level."""
    while parts.numel() > 1:
        parts = dotp.combine_partials(parts, radix)
    return parts[0]


@pytest.mark.parametrize("n", [1, 2, 31, 32, 33, 2048, 5000, 58112, 58113,
                               100000])
@pytest.mark.parametrize("radix", [2, 3, 32, 1024])
def test_combine_tree_equals_the_per_level_chain(cuda, n, radix):
    """One tree launch gives the bits of the chain of per-level launches,
    below and above the shared-memory cap (above it, per-level launches
    run until the count fits); every level of the chain is within 1e-6
    of each group's sum |partial| of the plain level."""
    gen = torch.Generator(device=cuda).manual_seed(n + radix)
    parts = torch.randn(n, device=cuda, generator=gen)
    before = dict(dotp.LAUNCHES)
    got = dotp.combine_tree(parts, radix)
    pre, m = 0, n
    while m > dotp.TREE_MAX:
        m, pre = -(-m // radix), pre + 1
    assert dotp.LAUNCHES["combine_tree"] == before["combine_tree"] + 1
    assert dotp.LAUNCHES["combine_partials"] == \
        before["combine_partials"] + pre
    assert got.shape == () and got.dtype == torch.float32
    assert torch.equal(got, _kernel_chain(parts, radix))
    level = parts
    while level.numel() > 1:
        nxt = dotp.combine_partials(level, radix)
        assert ((nxt - dotp.combine_partials_plain(level, radix)).abs()
                <= 1e-6 * dotp.combine_partials_plain(level.abs(),
                                                      radix)).all()
        level = nxt
    assert torch.equal(got, level[0])


def test_combine_tree_cap_is_the_kernels(cuda):
    lib = _build.load("dotp", dotp._SIGNATURES)
    assert lib.dotp_tree_max() == dotp.TREE_MAX == 232448 // 4


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
    with pytest.raises(TypeError):
        dotp.combine_tree(x, 4)


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


@pytest.mark.parametrize("shape", [(33, 8), (33, 64), (33, 256), (2, 4096),
                                   (257, 4096), (64, 4096), (256, 4096),
                                   (4096, 4096), (300, 1000), (5, 37),
                                   (70, 1001)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_dct_kernel_matches_plain(cuda, shape, dtype):
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = torch.randn(*shape, device=cuda, generator=gen).to(dtype)
    before = dct.LAUNCHES
    got = ops.dct(x)
    assert dct.LAUNCHES == before + 1 and got.dtype == torch.float32
    bt = ops.dct_basis_t(shape[1], x.device)
    torch.testing.assert_close(got, dct.dct_plain(x, bt), rtol=1e-3,
                               atol=1e-3)
    torch.testing.assert_close(bt.cpu(), ops.dct_basis_t(
        shape[1], torch.device("cpu")), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dct_rows_do_not_depend_on_the_tile(cuda, dtype):
    """Every output is one FMA chain in increasing k whatever tile the row
    count picks, so the first rows of a large call equal the same rows
    alone, bit for bit (the suite's 2, 64 and 256 rows against 4096),
    and a row off 16-byte alignment (the element-wise copy) gives the
    aligned call's bits too."""
    gen = torch.Generator(device=cuda).manual_seed(16)
    x = torch.randn(4096, 4096, device=cuda, generator=gen).to(dtype)
    full = ops.dct(x)
    for t in (2, 64, 256):
        assert torch.equal(ops.dct(x[:t]), full[:t])
    flat = torch.empty(2 * 4096 + 1, device=cuda, dtype=dtype)
    rows = flat[1:].view(2, 4096)
    rows.copy_(x[:2])
    assert torch.equal(ops.dct(rows), full[:2])


@pytest.mark.parametrize("shape", [(3, 8, 8), (3, 16, 20), (3, 32, 32),
                                   (1, 512, 512), (2, 33, 65)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_conv2d_kernel_matches_plain(cuda, shape, dtype):
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    img = torch.randn(*shape, device=cuda, generator=gen).to(dtype)
    k = torch.randn(3, 3, device=cuda, generator=gen)
    before = conv2d.LAUNCHES
    got = ops.conv2d(img, k)
    assert conv2d.LAUNCHES == before + 1 and got.dtype == torch.float32
    # The same float32 multiplies and adds in the same order: equal bits.
    assert torch.equal(got, conv2d.conv2d_plain(img, k))


def test_powf_kernel_equals_the_c_library(cuda):
    y = -1.0 / 1.5
    specials = torch.tensor(
        [0.0, -0.0, 1.0, -1.0, 2.0, -2.0, float("inf"), float("-inf"),
         1e-45, 2.5e-42, 1.1754942e-38, 3.4028235e38, 1e-30, 1e30, 0.5],
        device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    bases = torch.cat([specials, torch.rand(1 << 16, device=cuda,
                                            generator=gen) * 1e-4])
    for exponent in (y, 2.0, 3.0, -1.0, 0.5, 0.0, 1e10, -1e10, 127.5):
        before = powf.LAUNCHES
        got = powf.powf(bases, exponent)
        assert powf.LAUNCHES == before + 1
        want = powf.powf_plain(bases, exponent)
        same = (got == want) | (torch.isnan(got) & torch.isnan(want))
        assert bool(same.all()), (exponent, bases[~same][:5].tolist())
        assert torch.equal(torch.signbit(got[~torch.isnan(got)]),
                           torch.signbit(want[~torch.isnan(want)]))


def _same_as_c_library(got, want) -> bool:
    """Equal values and signs, NaN where the C library gives NaN (NaN
    payloads excepted)."""
    nan = torch.isnan(want)
    return (torch.equal(torch.isnan(got), nan)
            and torch.equal(got[~nan].view(torch.int32),
                            want[~nan].view(torch.int32)))


@pytest.mark.parametrize("n", [0, 1, 3, 4, 8191, 8192, (1 << 24) + 3])
def test_powf_kernel_at_every_size(cuda, n):
    """Both of the kernel's paths (one base a thread below 270,336 bases,
    two 16-byte packs a thread above) and their ragged ends."""
    gen = torch.Generator(device=cuda).manual_seed(n)
    bases = torch.rand(n, device=cuda, generator=gen) * 1e-3 + 1e-6
    for exponent in (-1.0 / 1.5, 3.0):
        got = powf.powf(bases, exponent)
        assert got.shape == bases.shape
        assert _same_as_c_library(got, powf.powf_plain(bases, exponent))


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("n", [8192, (1 << 20) + 5])
def test_powf_kernel_on_offset_views(cuda, offset, n):
    """A base pointer 4, 8 or 12 bytes past a 16-byte boundary: the
    scalar prologue, then the packs."""
    gen = torch.Generator(device=cuda).manual_seed(offset)
    whole = torch.rand(n + offset, device=cuda, generator=gen) + 0.25
    view = whole[offset:]
    assert view.data_ptr() % 16 == 4 * offset
    got = powf.powf(view, -1.0 / 1.5)
    assert _same_as_c_library(got, powf.powf_plain(view, -1.0 / 1.5))


@pytest.mark.parametrize("n", [64, 1 << 20])
def test_powf_kernel_special_bases(cuda, n):
    """Zero, subnormal, infinite, NaN and negative bases among ordinary
    ones, under integer (odd and even) and non-integer exponents, on
    both paths."""
    specials = torch.tensor(
        [0.0, -0.0, 1.0, -1.0, 2.0, -2.0, -3.0, -0.5, 1e-45, -1e-45,
         2.5e-42, -2.5e-42, 1.1754942e-38, 3.4028235e38, -3.4028235e38,
         float("inf"), float("-inf"), float("nan")], device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(n)
    bases = torch.rand(n, device=cuda, generator=gen) * 4.0 - 2.0
    idx = torch.randint(0, n, (n // 8,), device=cuda, generator=gen)
    bases[idx] = specials[torch.arange(idx.numel(), device=cuda)
                          % specials.numel()]
    for exponent in (3.0, 2.0, -1.0, -2.0, 0.5, -1.0 / 1.5, 0.0, 1e10,
                     -1e10, 127.5, float("inf"), float("-inf"),
                     float("nan")):
        got = powf.powf(bases, exponent)
        assert _same_as_c_library(got, powf.powf_plain(bases, exponent)), \
            exponent


def test_robust_simulator_on_card_equals_cpu(cuda):
    key = prng.PRNGKey(0, device="cpu")
    app = fiveg.FiveGConfig(n_rx=16, ffts_per_round=4)
    for mode in ("tree", "partial"):
        faults = fiveg.FiveGFaults(fail_rate=0.02, timeout_cycles=2000.0,
                                   seed=1)
        gpu = fiveg.simulate_app(key, app, sync=mode, faults=faults,
                                 device=cuda)
        cpu = fiveg.simulate_app(key, app, sync=mode, faults=faults,
                                 device="cpu")
        for c in ("total_cycles", "completion_rate", "timed_out_levels"):
            assert getattr(gpu, c).item() == getattr(cpu, c).item(), c
    spec = barrier.fault_spec(timeout_cycles=500.0, quorum_frac=0.95)
    gpu = sweep.sweep_barrier(key, n_pes=256, n_trials=8, faults=spec,
                              device=cuda)
    cpu = sweep.sweep_barrier(key, n_pes=256, n_trials=8, faults=spec,
                              device="cpu")
    for f in ("span_cycles", "abandoned_pes", "timed_out_levels"):
        assert torch.equal(getattr(gpu, f).cpu(), getattr(cpu, f)), f


# flash_attention: float32 at the reference's tolerance; bf16 within two
# bf16 ulps relative plus 1.6e-2 absolute (p and the output are rounded to
# bf16 at other places in the kernel and the plain version).
FA_TOL = {torch.float32: 2e-3, torch.bfloat16: 1.6e-2}
# bf16 against float32 attention on the same bf16 inputs, each query row's
# largest error over that row's largest output (FA_TOL[bf16] is loose where
# outputs average hundreds of keys): the output's and p's bf16 rounding are
# 2^-9 relative each; 2^-6 leaves a factor of four (chip_smoke.py's
# FA_BF16_ROW_TOL).
FA_BF16_ROW_TOL = 2.0 ** -6


def row_scaled_err(got, want) -> float:
    diff = (got.float() - want.float()).abs().amax(dim=-1)
    return (diff / want.float().abs().amax(dim=-1)).max().item()


@pytest.mark.parametrize("s,d", [(64, 16), (128, 32), (256, 64), (33, 8),
                                 (100, 128)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda, s, d, causal, dtype):
    gen = torch.Generator(device=cuda).manual_seed(s + d)
    q, k, v = (0.5 * torch.randn(2, 2, s, d, device=cuda, generator=gen)
               for _ in range(3))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    before = flash_attn.LAUNCHES
    got = ops.flash_attention(q, k, v, causal=causal)
    assert flash_attn.LAUNCHES == before + 1
    assert got.dtype == dtype
    want = flash_attn.flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=FA_TOL[dtype],
                               atol=FA_TOL[dtype])


@pytest.mark.parametrize("b,h,hk,s", [(1, 8, 2, 100), (2, 7, 1, 48),
                                      (2, 32, 8, 512)])
def test_flash_attention_kernel_grouped_heads_bf16(cuda, b, h, hk, s):
    gen = torch.Generator(device=cuda).manual_seed(h * hk + s)
    q = torch.randn(b, h, s, 128, device=cuda, generator=gen).bfloat16()
    k = torch.randn(b, hk, s, 128, device=cuda, generator=gen).bfloat16()
    v = torch.randn(b, hk, s, 128, device=cuda, generator=gen).bfloat16()
    got = flash_attn.flash_attention(q, k, v, causal=True)
    want = flash_attn.flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=1.6e-2,
                               atol=1.6e-2)


def test_model_attention_on_card_launches_the_kernel(cuda):
    """models.attention.flash_attention on CUDA tensors is the kernel on
    (B, H, S, D) transposes; the chunked plain algorithm agrees."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(2, 64, 4, 16, device=cuda, generator=gen)
    k = torch.randn(2, 64, 2, 16, device=cuda, generator=gen)
    v = torch.randn(2, 64, 2, 16, device=cuda, generator=gen)
    before = flash_attn.LAUNCHES
    got = attention.flash_attention(q, k, v, causal=True, chunk=32)
    assert flash_attn.LAUNCHES == before + 1
    want = attention.chunked_attention(q, k, v, causal=True, chunk=32)
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("kwargs", [{"window": 16}, {}])
def test_model_attention_on_card_raises_for_later_slices(cuda, kwargs):
    """The sliding window launches the kernel and agrees with the chunked
    plain algorithm; a (D, Dv) pair the kernel has not (here (16, 8))
    raises, and never falls back."""
    q = torch.randn(1, 32, 2, 16, device=cuda)
    v = torch.randn(1, 32, 2, 8, device=cuda)
    before = flash_attn.LAUNCHES
    if kwargs:
        got = attention.flash_attention(q, q, q, causal=True, chunk=32,
                                        **kwargs)
        assert flash_attn.LAUNCHES == before + 1
        want = attention.chunked_attention(q, q, q, causal=True, chunk=32,
                                           **kwargs)
        torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)
        return
    else:
        with pytest.raises(ValueError, match="Dv"):
            attention.flash_attention(q, q, v, causal=True, chunk=32)
        with pytest.raises(ValueError, match="Dv"):
            flash_attn.flash_attention(q.transpose(1, 2), q.transpose(1, 2),
                                       v.transpose(1, 2))
    assert flash_attn.LAUNCHES == before


@pytest.mark.parametrize("d,dv", [(192, 128), (24, 16)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale", [None, 0.37])
@pytest.mark.parametrize("s,group", [(100, 1), (300, 4)])
def test_flash_attention_value_width_pairs(cuda, d, dv, causal, dtype, scale,
                                           s, group):
    """MLA's pairs, DeepSeek-V3's (192, 128) (``wgmma`` in bf16) and its
    smoke config's (24, 16) (the FMA kernel), against the plain version:
    float32 within 1e-4, bf16 within FA_TOL and FA_BF16_ROW_TOL of each
    row's scale; a scale other than D ** -0.5 as well as the default."""
    gen = torch.Generator(device=cuda).manual_seed(d + dv + s + group)
    q = torch.randn(2, 2 * group, s, d, device=cuda, generator=gen).to(dtype)
    k = torch.randn(2, 2, s, d, device=cuda, generator=gen).to(dtype)
    v = torch.randn(2, 2, s, dv, device=cuda, generator=gen).to(dtype)
    before = flash_attn.LAUNCHES
    got = flash_attn.flash_attention(q, k, v, causal=causal, scale=scale)
    assert flash_attn.LAUNCHES == before + 1
    assert got.shape == (2, 2 * group, s, dv) and got.dtype == dtype
    want = flash_attn.flash_attention_plain(q, k, v, causal=causal,
                                            scale=scale)
    tol = 1e-4 if dtype == torch.float32 else FA_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        ref32 = flash_attn.flash_attention_plain(
            q.float(), k.float(), v.float(), causal=causal, scale=scale)
        assert row_scaled_err(got, ref32) <= FA_BF16_ROW_TOL
    # The scale matters: the default's result is another one.
    if scale is not None:
        other = flash_attn.flash_attention(q, k, v, causal=causal)
        assert (other.float() - got.float()).abs().max().item() > 10 * tol


@pytest.mark.parametrize("d,dv", [(192, 128), (24, 16)])
def test_model_attention_on_card_runs_mla_pairs(cuda, d, dv):
    """The model's attention with MLA's widths and scale launches the
    kernel on its (B, S, H, D) projections and writes (B, S, H, Dv); the
    chunked plain algorithm agrees."""
    gen = torch.Generator(device=cuda).manual_seed(d * dv)
    q = torch.randn(2, 96, 4, d, device=cuda, generator=gen).bfloat16()
    k = torch.randn(2, 96, 4, d, device=cuda, generator=gen).bfloat16()
    v = torch.randn(2, 96, 4, dv, device=cuda, generator=gen).bfloat16()
    before = flash_attn.LAUNCHES
    got = attention.flash_attention(q, k, v, causal=True, scale=d ** -0.5)
    assert flash_attn.LAUNCHES == before + 1 and got.shape == (2, 96, 4, dv)
    want = attention.chunked_attention(q, k, v, causal=True, chunk=32,
                                       scale=d ** -0.5)
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=FA_TOL[torch.bfloat16],
                               atol=FA_TOL[torch.bfloat16])


@pytest.mark.parametrize("d", [80, 192])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,group", [(100, 1), (300, 12)])
def test_flash_attention_at_the_configs_head_widths(cuda, d, causal, dtype,
                                                    s, group):
    """hubert-xlarge's D 80 and nemotron-4-340b's D 192 (grouped 12 to 1,
    as nemotron's 96 heads read 8): the kernel against its plain version,
    within FA_TOL in bf16 and 1e-4 in float32 (both sum float32 products;
    1e-4 leaves the exponentials' and the order's rounding a wide
    margin); bf16 also within FA_BF16_ROW_TOL of each row's scale."""
    gen = torch.Generator(device=cuda).manual_seed(d + s + group)
    q = torch.randn(2, 2 * group, s, d, device=cuda, generator=gen)
    k, v = (torch.randn(2, 2, s, d, device=cuda, generator=gen)
            for _ in range(2))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    before = flash_attn.LAUNCHES
    got = ops.flash_attention(q, k, v, causal=causal)
    assert flash_attn.LAUNCHES == before + 1 and got.dtype == dtype
    want = flash_attn.flash_attention_plain(q, k, v, causal=causal)
    tol = 1e-4 if dtype == torch.float32 else FA_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        ref32 = flash_attn.flash_attention_plain(q.float(), k.float(),
                                                 v.float(), causal=causal)
        assert row_scaled_err(got, ref32) <= FA_BF16_ROW_TOL


@pytest.mark.parametrize("d", [80, 192])
def test_model_attention_on_card_runs_the_configs_head_widths(cuda, d):
    """The model's attention at D 80 and 192 launches the kernel on its
    (B, S, H, D) projections; the chunked plain algorithm agrees."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    q = torch.randn(2, 96, 4, d, device=cuda, generator=gen).bfloat16()
    k, v = (torch.randn(2, 96, 2, d, device=cuda, generator=gen).bfloat16()
            for _ in range(2))
    before = flash_attn.LAUNCHES
    got = attention.flash_attention(q, k, v, causal=True)
    assert flash_attn.LAUNCHES == before + 1
    want = attention.chunked_attention(q, k, v, causal=True, chunk=32)
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=FA_TOL[torch.bfloat16],
                               atol=FA_TOL[torch.bfloat16])


def test_flash_attention_rejects_other_head_dims_and_dtypes(cuda):
    x = torch.ones(1, 2, 8, 24, device=cuda)
    with pytest.raises(ValueError):
        flash_attn.flash_attention(x, x, x)
    x = torch.ones(1, 2, 8, 16, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attn.flash_attention(x, x, x)


def _bf16(cuda, gen, *shape):
    return torch.randn(*shape, device=cuda, generator=gen).bfloat16()


@pytest.mark.parametrize("d", [64, 80, 128, 192])
@pytest.mark.parametrize("s", [33, 100, 2047, 2048])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 4, 7])
def test_flash_attention_wgmma_matches_plain(cuda, d, s, causal, group):
    """The wgmma kernel (bf16, D 64, 80, 128 and 192) against the plain
    version;
    the same inputs as the model's (B, S, H, D) tensors seen through
    transpose(1, 2) give the contiguous call's bits."""
    hk = 1 if group == 7 else 2
    h = group * hk
    gen = torch.Generator(device=cuda).manual_seed(s + d + group)
    q = _bf16(cuda, gen, 2, h, s, d)
    k, v = _bf16(cuda, gen, 2, hk, s, d), _bf16(cuda, gen, 2, hk, s, d)
    before = flash_attn.LAUNCHES
    got = ops.flash_attention(q, k, v, causal=causal)
    assert flash_attn.LAUNCHES == before + 1
    want = flash_attn.flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=FA_TOL[torch.bfloat16],
                               atol=FA_TOL[torch.bfloat16])
    assert torch.equal(_views_and_out(q, k, v, causal), got)


def _views_and_out(q, k, v, causal):
    """The kernel on the model's layout: q, k, v as (B, S, H, D) tensors
    seen through transpose(1, 2), written into a transposed (B, S, H, D)
    output."""
    qv, kv, vv = (t.transpose(1, 2).contiguous().transpose(1, 2)
                  for t in (q, k, v))
    out = torch.empty(q.shape[0], q.shape[2], q.shape[1], q.shape[3],
                      device=q.device, dtype=q.dtype)
    flash_attn.flash_attention(qv, kv, vv, causal=causal,
                               out=out.transpose(1, 2))
    return out.transpose(1, 2)


@pytest.mark.parametrize("d", [80, 192])
@pytest.mark.parametrize("s,t,causal", [(100, 300, False), (300, 100, False),
                                        (1, 65, False), (1000, 1000, True),
                                        (1000, 1000, False), (129, 129, True),
                                        (63, 63, True)])
def test_flash_attention_wgmma_ragged_lengths(cuda, d, s, t, causal):
    """D 80 and 192 on the wgmma kernel at lengths off its 128-row query
    tiles and its 128- (D 80) or 64-row (D 192) key tiles, T above and
    below S: the plain version within FA_TOL, float32 attention on the
    same bf16 inputs within FA_BF16_ROW_TOL of each row's scale, and the
    model's strided views the contiguous call's bits."""
    gen = torch.Generator(device=cuda).manual_seed(d * s + t)
    q = _bf16(cuda, gen, 2, 4, s, d)
    k, v = _bf16(cuda, gen, 2, 2, t, d), _bf16(cuda, gen, 2, 2, t, d)
    before = flash_attn.LAUNCHES
    got = flash_attn.flash_attention(q, k, v, causal=causal)
    assert flash_attn.LAUNCHES == before + 1
    want = flash_attn.flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=FA_TOL[torch.bfloat16],
                               atol=FA_TOL[torch.bfloat16])
    ref32 = flash_attn.flash_attention_plain(q.float(), k.float(), v.float(),
                                             causal=causal)
    assert row_scaled_err(got, ref32) <= FA_BF16_ROW_TOL
    assert torch.equal(_views_and_out(q, k, v, causal), got)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_d192_grouped_12_to_1(cuda, causal):
    """nemotron-4-340b's grouping (96 query heads read 8 KV heads) at D
    192, on the model's strided views: 24 query heads reading 2, a ragged
    length."""
    gen = torch.Generator(device=cuda).manual_seed(192 + causal)
    q = _bf16(cuda, gen, 1, 24, 333, 192)
    k, v = _bf16(cuda, gen, 1, 2, 333, 192), _bf16(cuda, gen, 1, 2, 333, 192)
    got = _views_and_out(q, k, v, causal)
    want = flash_attn.flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=FA_TOL[torch.bfloat16],
                               atol=FA_TOL[torch.bfloat16])
    assert torch.equal(flash_attn.flash_attention(q, k, v, causal=causal),
                       got)


# The wgmma kernel's persistent grid (flash_attn.fwd_plan): fewer items
# than multiprocessors and many more, ragged lengths, windows at the edges
# of its 128-row items and 128-key tiles (64-key at D 192).
@pytest.mark.parametrize("d,dv,b,h,hk,s,window", [
    (64, 64, 1, 2, 1, 100, 0), (128, 128, 1, 3, 1, 2048, 0),
    (128, 128, 4, 32, 8, 1024, 0), (192, 128, 2, 16, 16, 1000, 0),
    (192, 192, 1, 24, 2, 777, 0), (80, 80, 2, 16, 16, 640, 0),
    (64, 64, 2, 10, 2, 1100, 1), (64, 64, 2, 10, 2, 1100, 127),
    (64, 64, 2, 10, 2, 1100, 128), (64, 64, 2, 10, 2, 1100, 129),
    (64, 64, 4, 25, 5, 2048, 1024), (128, 128, 2, 8, 2, 1100, 127),
    (128, 128, 2, 8, 2, 1100, 128), (128, 128, 2, 8, 2, 1100, 129)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_persistent_grid(cuda, d, dv, b, h, hk, s, window,
                                         causal):
    """The plain version within FA_TOL and float32 attention on the same
    inputs within FA_BF16_ROW_TOL of each row's scale; a second run, and
    the same items in the other order on its own grid, give the same
    bits."""
    gen = torch.Generator(device=cuda).manual_seed(d + h + s + window)
    q = _bf16(cuda, gen, b, h, s, d)
    k, v = _bf16(cuda, gen, b, hk, s, d), _bf16(cuda, gen, b, hk, s, dv)
    before = flash_attn.LAUNCHES
    got = flash_attn.flash_attention(q, k, v, causal=causal, window=window)
    assert flash_attn.LAUNCHES == before + 1
    want = flash_attn.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=FA_TOL[torch.bfloat16],
                               atol=FA_TOL[torch.bfloat16])
    ref32 = flash_attn.flash_attention_plain(q.float(), k.float(), v.float(),
                                             causal=causal, window=window)
    assert row_scaled_err(got, ref32) <= FA_BF16_ROW_TOL
    assert torch.equal(
        flash_attn.flash_attention(q, k, v, causal=causal, window=window),
        got)
    sms = flash_attn.sm_count(torch.cuda.current_device())
    plan = flash_attn.fwd_plan(b, h, s, s, d, dv, causal, window, sms)
    other = plan.reordered(1 - plan.order, sms)
    out = torch.empty_like(got)
    flash_attn.launch(q, k, v, out, None, d ** -0.5, causal, window, other)
    assert torch.equal(out, got)


def test_flash_attention_persistent_grid_lse_and_views(cuda):
    """DeepSeek-V3's pair with the rows' log-sum-exp, within 1e-5 of the
    plain one, and on the model's strided views the contiguous call's
    bits."""
    gen = torch.Generator(device=cuda).manual_seed(27)
    q = (0.5 * torch.randn(2, 8, 700, 192, device=cuda, generator=gen)
         ).bfloat16()
    k = (0.5 * torch.randn(2, 8, 700, 192, device=cuda, generator=gen)
         ).bfloat16()
    v = _bf16(cuda, gen, 2, 8, 700, 128)
    lse = torch.empty(2, 8, 700, device=cuda)
    got = flash_attn.flash_attention(q, k, v, causal=True, lse=lse)
    torch.testing.assert_close(lse, ref.attention_lse(q, k, causal=True),
                               rtol=0, atol=1e-5)
    qv, kv, vv = (t.transpose(1, 2).contiguous().transpose(1, 2)
                  for t in (q, k, v))
    out = torch.empty(2, 700, 8, 128, device=cuda, dtype=torch.bfloat16)
    flash_attn.flash_attention(qv, kv, vv, causal=True,
                               out=out.transpose(1, 2))
    assert torch.equal(out.transpose(1, 2), got)


@pytest.mark.parametrize("d", flash_attn.HEAD_DIMS)
@pytest.mark.parametrize("s,t", [(1, 1), (65, 200), (200, 65), (1000, 1000)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_fma_kernel_every_width(cuda, d, s, t, causal):
    """The float32 kernel (register-tiled FMAs) at every head width, at
    lengths off its 64-row tiles, grouped heads 3 to 1: the plain version
    within 1e-4 (both sum float32 products; chip_smoke.py's FA_F32_TOL),
    and the model's strided views the contiguous call's bits."""
    gen = torch.Generator(device=cuda).manual_seed(d + s + 7 * t)
    q = torch.randn(2, 6, s, d, device=cuda, generator=gen)
    k, v = (torch.randn(2, 2, t, d, device=cuda, generator=gen)
            for _ in range(2))
    before = flash_attn.LAUNCHES
    got = flash_attn.flash_attention(q, k, v, causal=causal)
    assert flash_attn.LAUNCHES == before + 1
    want = flash_attn.flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert torch.equal(_views_and_out(q, k, v, causal), got)


@pytest.mark.parametrize("s,t", [(1, 1), (65, 200), (1000, 1000)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_fma_kernel_bf16_d8(cuda, s, t, causal):
    """bf16 at D 8 (the smoke configs) on the FMA kernel, p rounded to
    bf16 before PV: the plain version within FA_TOL."""
    _check_bf16_fma(cuda, 8, s, t, causal)


@pytest.mark.parametrize("s,t", [(1, 1), (65, 200), (1000, 1000)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_fma_kernel_bf16_d40(cuda, s, t, causal):
    """bf16 at D 40 (examples/train_lm.py's 10m scale, not a multiple of
    mma's 16 features) on the FMA kernel: the plain version within
    FA_TOL."""
    _check_bf16_fma(cuda, 40, s, t, causal)


def _check_bf16_fma(cuda, d, s, t, causal):
    gen = torch.Generator(device=cuda).manual_seed(d + s + t)
    q = _bf16(cuda, gen, 2, 4, s, d)
    k, v = _bf16(cuda, gen, 2, 2, t, d), _bf16(cuda, gen, 2, 2, t, d)
    got = flash_attn.flash_attention(q, k, v, causal=causal)
    want = flash_attn.flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=FA_TOL[torch.bfloat16],
                               atol=FA_TOL[torch.bfloat16])
    assert torch.equal(_views_and_out(q, k, v, causal), got)


def test_flash_attention_rejects_layouts_the_kernel_cannot_read(cuda):
    x = torch.zeros(1, 2, 64, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="feature axis"):
        flash_attn.flash_attention(x.transpose(2, 3), x, x)
    flat = torch.zeros(2 * 64 * 64 + 1, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attn.flash_attention(x, flat[1:].view(1, 2, 64, 64), x)


def test_model_attention_reads_and_writes_the_projections_in_place(cuda):
    """At D = 128 the model's attention is one launch and one allocation,
    its output: no copy of q, k or v, and an output the (B, S, H * D)
    reshape reads as a view."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    q = _bf16(cuda, gen, 2, 256, 8, 128)
    k, v = _bf16(cuda, gen, 2, 256, 2, 128), _bf16(cuda, gen, 2, 256, 2, 128)
    attention.flash_attention(q, k, v, causal=True)     # build and warm
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats(cuda)["allocation.all.allocated"]
    before = flash_attn.LAUNCHES
    out = attention.flash_attention(q, k, v, causal=True)
    assert flash_attn.LAUNCHES == before + 1
    assert torch.cuda.memory_stats(cuda)["allocation.all.allocated"] \
        == allocs + 1
    assert out.shape == q.shape and out.is_contiguous()
    assert out.reshape(2, 256, -1).data_ptr() == out.data_ptr()
    want = attention.chunked_attention(q, k, v, causal=True, chunk=64)
    torch.testing.assert_close(out.float(), want.float(),
                               rtol=FA_TOL[torch.bfloat16],
                               atol=FA_TOL[torch.bfloat16])


def _stage_kernel_chain(re, im):
    n = re.shape[1]
    for s in range(fft4.log4(n)):
        re, im = fft4.fft4_stage(re, im, *ops._stage_twiddles(n, s, re.device))
    return re, im


@pytest.mark.parametrize("n", [16, 64, 256, 1024, 4096])
@pytest.mark.parametrize("rows", [3, 896])
def test_fft4_fused_is_one_launch_equal_to_the_stage_chain(cuda, n, rows):
    """One fused launch, equal to the stage kernel chain and to its plain
    version (the plain stage chain) within 1e-5 of the largest output."""
    gen = torch.Generator(device=cuda).manual_seed(n * rows)
    re = torch.randn(rows, n, device=cuda, generator=gen)
    im = torch.randn(rows, n, device=cuda, generator=gen)
    before = (fft4.LAUNCHES, fft4.FUSED_LAUNCHES)
    fr, fi = ops.fft4(re, im)
    assert (fft4.LAUNCHES, fft4.FUSED_LAUNCHES) == (before[0],
                                                    before[1] + 1)
    cr, ci = _stage_kernel_chain(re, im)
    scale = max(cr.abs().max().item(), ci.abs().max().item())
    torch.testing.assert_close(fr, cr, rtol=0, atol=1e-5 * scale)
    torch.testing.assert_close(fi, ci, rtol=0, atol=1e-5 * scale)
    pr, pi = fft4.fft4_fused_plain(re, im, *ops.fused_twiddles(n, cuda))
    torch.testing.assert_close(fr, pr, rtol=0, atol=1e-5 * scale)
    torch.testing.assert_close(fi, pi, rtol=0, atol=1e-5 * scale)


def test_fft4_above_l_max_runs_stage_launches_then_the_fused_kernel(cuda):
    rows, n = 3, 4 ** 8
    gen = torch.Generator(device=cuda).manual_seed(8)
    re = torch.randn(rows, n, device=cuda, generator=gen)
    im = torch.randn(rows, n, device=cuda, generator=gen)
    lead, length = fft4.fft4_plan(n)
    assert (lead, length) == (1, fft4.L_MAX)
    before = (fft4.LAUNCHES, fft4.FUSED_LAUNCHES)
    fr, fi = ops.fft4(re, im)
    assert (fft4.LAUNCHES, fft4.FUSED_LAUNCHES) == (before[0] + lead,
                                                    before[1] + 1)
    want = torch.fft.fft(torch.complex(re.double(), im.double()))[
        :, ref.digit_reverse_indices(n, device=cuda)]
    torch.testing.assert_close(fr.double(), want.real, rtol=1e-3, atol=2e-3)
    torch.testing.assert_close(fi.double(), want.imag, rtol=1e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# The tuning-serving daemon on the card.
# ---------------------------------------------------------------------------

def _serve_on_card(cuda, requests, client_stream=None, in_thread=False):
    """Submit ``requests()`` before the worker starts (one coalesced
    dispatch), from a client thread and/or inside ``client_stream``;
    returns the responses and the server's stats."""
    import threading
    from repro_torch.runtime.serving import ServerConfig, TuningServer
    srv = TuningServer(ServerConfig(batch_window=0.01), start=False,
                       device=cuda)
    tickets = []

    def client():
        if client_stream is None:
            tickets.extend(srv.submit(r) for r in requests())
            return
        with torch.cuda.stream(client_stream):
            tickets.extend(srv.submit(r) for r in requests())

    if in_thread:
        t = threading.Thread(target=client)
        t.start()
        t.join(timeout=120)
        assert not t.is_alive()
    else:
        client()
    srv.start()
    out = [t.result(timeout=120) for t in tickets]
    srv.close()
    return out, srv.stats


def _serving_requests(cuda):
    """Two kernel requests (the Pareto straggler's draw launches the
    ``powf`` kernel) and a trace computed on the current stream."""
    from repro_torch.core.topology import TeraPoolConfig
    from repro_torch.runtime.serving import TuneRequest
    cfg = TeraPoolConfig(n_pes=256)

    def make():
        trace = 300.0 * prng.uniform(prng.PRNGKey(5, device=cuda), (8, 256))
        trace = trace.sqrt() * trace.sqrt()      # more work on this stream
        return [TuneRequest(kernel="straggler_pareto", cfg=cfg),
                TuneRequest(kernel="dotp_1Mi", cfg=cfg, objective="pareto"),
                TuneRequest(arrivals=trace, cfg=cfg)]
    return make


def test_serving_side_stream_client_equals_default_stream(cuda):
    """A client on a side stream in its own thread gets the answers of a
    client on the default stream, bit for bit."""
    make = _serving_requests(cuda)
    base, stats = _serve_on_card(cuda, make)
    side, side_stats = _serve_on_card(cuda, make,
                                      client_stream=torch.cuda.Stream(cuda),
                                      in_thread=True)
    assert stats.batches == side_stats.batches == 1
    for a, b in zip(base, side):
        assert (a.provenance, a.tier, a.name) == (b.provenance, b.tier,
                                                  b.name) == (
            "batched", "exact", a.name)
        assert (a.mean_span, a.mean_energy) == (b.mean_span, b.mean_energy)
        for field in sweep.BarrierResult._fields:
            assert torch.equal(getattr(a.result, field),
                               getattr(b.result, field)), field


def test_serving_batched_equals_unbatched_on_card(cuda):
    from repro_torch.core import tuning
    from repro_torch.runtime.serving import TuneRequest
    traces = [300.0 * prng.uniform(prng.PRNGKey(10 + i, device=cuda),
                                   (4, 1024)) for i in range(4)]
    resps, stats = _serve_on_card(
        cuda, lambda: [TuneRequest(arrivals=t) for t in traces])
    assert stats.batches == 1 and stats.batch_efficiency == 4.0
    scheds = tuning.all_schedules(1024, prune="hierarchy")
    for trace, resp in zip(traces, resps):
        solo = sweep.sweep_arrivals(trace, scheds)
        for field in sweep.BarrierResult._fields:
            assert torch.equal(getattr(resp.result, field),
                               getattr(solo, field)), field


def test_serving_straggler_request_draw_equals_main_thread(cuda):
    """A ``straggler_pareto`` request submitted from a client thread
    draws, through the ``powf`` kernel, what ``arrival_batch`` draws on
    the main thread, bit for bit."""
    import threading
    from repro_torch.core import workloads
    from repro_torch.runtime.serving import (ServerConfig, TuneRequest,
                                             TuningServer, _kernel_key)
    srv = TuningServer(ServerConfig(), start=False, device=cuda)
    before = powf.LAUNCHES
    t = threading.Thread(target=lambda: srv.submit(
        TuneRequest(kernel="straggler_pareto")))
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and powf.LAUNCHES == before + 1
    got = srv._queue[0].arrivals
    srv.close(drain=False)
    want = workloads.arrival_batch(_kernel_key("straggler_pareto", cuda),
                                   "straggler_pareto", (8, 1024))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# ---------------------------------------------------------------------------
# The MoE and MLA families on the card.
# ---------------------------------------------------------------------------

def test_moe_combine_gives_the_same_bits_twice(cuda):
    """The MoE layer on the card at DeepSeek-V3's routing (256 experts,
    top-8, capacity dropping some tokens): two runs give identical bits
    (no atomics in the dispatch or the combine)."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import moe
    cfg = dataclasses.replace(configs.get_smoke("deepseek_v3_671b"),
                              n_experts=256, top_k=8, d_ff_expert=64,
                              capacity_factor=0.5)
    gen = torch.Generator(device=cuda).manual_seed(7)
    p = {n: (torch.randn(d.shape, device=cuda, generator=gen)
             * d.shape[-2] ** -0.5).to(getattr(torch, d.dtype))
         for n, d in moe.moe_defs(cfg).items()}
    x = torch.randn(4, 512, cfg.d_model, device=cuda,
                    generator=gen).bfloat16()
    a, aux_a = moe.moe_apply(p, x, cfg)
    b, aux_b = moe.moe_apply(p, x, cfg)
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert torch.equal(aux_a, aux_b)
    cpu, aux_cpu = moe.moe_apply({n: t.cpu() for n, t in p.items()},
                                 x.cpu(), cfg)
    torch.testing.assert_close(a.cpu().float(), cpu.float(),
                               rtol=2 ** -6, atol=2 ** -7 * cpu.float()
                               .abs().max().item())


@pytest.mark.parametrize("arch", ["deepseek_v3_671b", "moonshot_v1_16b_a3b"])
def test_smoke_serve_on_card_matches_the_cpu_port(cuda, arch):
    """The smoke config's serve loop (float32 end to end, the published
    routing) on the card against the port on the CPU: logits within
    1e-4, greedy tokens equal; the prefill launches the kernel once a
    layer."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.core import prng
    from repro_torch.launch import steps
    from repro_torch.models import init_caches, init_params, transformer
    cfg = dataclasses.replace(configs.get_smoke(arch),
                              compute_dtype="float32")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 64)))
    runs = {}
    for dev in (torch.device("cpu"), cuda):
        params = init_params(cfg, prng.PRNGKey(0, device=dev))
        caches = init_caches(cfg, 2, 64, torch.float32, device=dev)
        before = flash_attn.LAUNCHES
        with torch.inference_mode():
            logits, caches, _, _ = transformer.forward(
                params, cfg, {"tokens": toks[:, :60].to(dev)},
                caches=caches, last_only=True)
        launches = flash_attn.LAUNCHES - before
        decode, _ = steps.build_decode_step(cfg, batch=2, max_len=64,
                                            device=dev)
        outs = [logits[:, -1].cpu()]
        for i in range(3):
            logits, caches = decode(params, caches,
                                    toks[:, 60 + i:61 + i].to(dev),
                                    torch.full((2,), 60 + i,
                                               dtype=torch.int32,
                                               device=dev))
            outs.append(logits[:, 0].cpu())
        runs[dev.type] = (outs, launches)
    assert runs["cpu"][1] == 0 and runs["cuda"][1] == cfg.n_layers
    for g, w in zip(runs["cuda"][0], runs["cpu"][0]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
        assert torch.equal(g.argmax(-1), w.argmax(-1))


# ---------------------------------------------------------------------------
# The sliding window (the hybrid family) and the selective scan (SSM).
# ---------------------------------------------------------------------------

# (D, dtype) of each attention kernel the window reaches: the FMA kernel
# in float32 and at bf16 D 8 (the hymba smoke width), mma.sync at bf16 D
# 16, wgmma at bf16 D 64 (Hymba-1.5B's width) and 128.
WINDOW_KERNELS = [(8, torch.float32), (8, torch.bfloat16),
                  (64, torch.float32), (16, torch.bfloat16),
                  (64, torch.bfloat16), (128, torch.bfloat16)]


@pytest.mark.parametrize("window", [1, 7, 63, 64, 1000, 1024, 1100])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d,dtype", WINDOW_KERNELS)
def test_flash_attention_window_matches_plain(cuda, window, causal, d,
                                              dtype):
    """S = T = 1100 (query tiles straddle the window's edge at every
    window here, and a ragged last tile), 10 query heads on 2 KV heads (g
    = 5, Hymba's grouping), windows 1 to >= S; bf16 also against float32
    attention row by row."""
    gen = torch.Generator(device=cuda).manual_seed(window + d)
    q = torch.randn(1, 10, 1100, d, device=cuda, generator=gen).to(dtype)
    k = torch.randn(1, 2, 1100, d, device=cuda, generator=gen).to(dtype)
    v = torch.randn(1, 2, 1100, d, device=cuda, generator=gen).to(dtype)
    before = flash_attn.LAUNCHES
    got = flash_attn.flash_attention(q, k, v, causal=causal, window=window)
    assert flash_attn.LAUNCHES == before + 1
    want = flash_attn.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=FA_TOL[dtype],
                               atol=FA_TOL[dtype])
    if dtype == torch.bfloat16:
        ref32 = flash_attn.flash_attention_plain(
            q.float(), k.float(), v.float(), causal=causal, window=window)
        assert row_scaled_err(got, ref32) <= FA_BF16_ROW_TOL


@pytest.mark.parametrize("d,dtype", WINDOW_KERNELS)
def test_flash_attention_window_planted_faults(cuda, d, dtype):
    """The checks above must see a wrong window: the kernel at window 64
    against the plain version at 63 and 65 (one key too few or too many,
    here in every row past the 64th) and without a window (the scan from
    key 0 unmasked); and a 64-key tile of values zeroed inside the
    window.  Each fault passes neither the tolerance nor the row check."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    q = torch.randn(1, 10, 600, d, device=cuda, generator=gen).to(dtype)
    k = torch.randn(1, 2, 600, d, device=cuda, generator=gen).to(dtype)
    v = torch.randn(1, 2, 600, d, device=cuda, generator=gen).to(dtype)
    got = flash_attn.flash_attention(q, k, v, causal=True, window=64)
    v_gap = v.clone()
    v_gap[:, :, 520:584] = 0
    faults = {w: flash_attn.flash_attention_plain(q, k, v, causal=True,
                                                  window=w)
              for w in (63, 65, 0)}
    faults["v_tile"] = flash_attn.flash_attention_plain(q, k, v_gap,
                                                        causal=True, window=64)
    tol = FA_TOL[dtype]
    for name, bad in faults.items():
        close = torch.allclose(got.float(), bad.float(), rtol=tol, atol=tol)
        assert not close, name
        assert row_scaled_err(got, bad.float()) > FA_BF16_ROW_TOL, name


def test_flash_attention_window_needs_s_le_t(cuda):
    q = torch.randn(1, 2, 64, 16, device=cuda)
    k = torch.randn(1, 2, 32, 16, device=cuda)
    before = flash_attn.LAUNCHES
    with pytest.raises(ValueError, match="S <= T"):
        flash_attn.flash_attention(q, k, k, window=8)
    assert flash_attn.LAUNCHES == before


def test_model_attention_window_on_card_matches_chunked(cuda):
    """``models.attention.flash_attention`` with Hymba's window on (B, S, H,
    D) projections (bf16, D 64, 25 heads on 5) against the chunked plain
    algorithm on the card (the reference's ``swa_fast`` path)."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn(2, 2048, 25, 64, device=cuda, generator=gen).bfloat16()
    k = torch.randn(2, 2048, 5, 64, device=cuda, generator=gen).bfloat16()
    v = torch.randn(2, 2048, 5, 64, device=cuda, generator=gen).bfloat16()
    got = attention.flash_attention(q, k, v, causal=True, window=1024)
    want = attention.chunked_attention(q, k, v, causal=True, window=1024)
    torch.testing.assert_close(got.float(), want.float(), rtol=1.6e-2,
                               atol=1.6e-2)


def _scan_inputs(cuda, b, s, di, n, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    dt = torch.nn.functional.softplus(
        torch.randn(b, s, di, device=cuda, generator=gen) - 2.0)
    x = torch.randn(b, s, di, device=cuda, generator=gen)
    bm = torch.randn(b, s, n, device=cuda, generator=gen)
    cm = torch.randn(b, s, n, device=cuda, generator=gen)
    a = -torch.arange(1, n + 1, device=cuda, dtype=torch.float32).expand(
        di, n).contiguous()
    d = torch.randn(di, device=cuda, generator=gen)
    h0 = torch.randn(b, di, n, device=cuda, generator=gen)
    return dt, x, bm, cm, a, d, h0


# The scan kernel against its plain version: both sum float32 products of
# O(1) values over at most n = 16 states a step, in other orders, and
# exponentials an ulp or two apart; the states decay, so errors do not
# grow with S.
SCAN_TOL = 1e-4


@pytest.mark.parametrize("s", [1, 255, 256, 2048])
@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("di", [128, 300])
def test_ssm_scan_kernel_matches_plain(cuda, s, n, di):
    """S at, below and past the plain version's 256-step chunk, a nonzero
    start state, channel counts that fill and do not fill a 128-channel
    block."""
    args = _scan_inputs(cuda, 2, s, di, n, s + n + di)
    before = ssm_scan.LAUNCHES
    y, h = ssm_scan.ssm_scan(*args)
    assert ssm_scan.LAUNCHES == before + 1
    wy, wh = ssm_scan.ssm_scan_plain(*args)
    torch.testing.assert_close(y, wy, rtol=SCAN_TOL, atol=SCAN_TOL)
    torch.testing.assert_close(h, wh, rtol=SCAN_TOL, atol=SCAN_TOL)


SCAN_PAIRS = [(lanes, n) for n in ssm_scan.STATES
              for lanes in ssm_scan.lane_counts(n)]


@pytest.mark.parametrize("b", [1, 5])
@pytest.mark.parametrize("di", [33, 300])
@pytest.mark.parametrize("s", [1, 17, 255, 256, 2048])
@pytest.mark.parametrize("lanes,n", SCAN_PAIRS)
def test_ssm_scan_every_lane_count_matches_plain(cuda, lanes, n, s, di, b):
    """Each lane count the kernel instantiates against the plain scan: S
    of one step, inside a 16-step tile, around the plain version's
    256-step chunk and the prefill's 2048; channels that do not fill a
    block (33: rows not 16-byte aligned, so 4-byte copies; 300), one and
    five batch rows, a nonzero start state.  Each call is one launch."""
    args = _scan_inputs(cuda, b, s, di, n, 7 * s + n + di + b + lanes)
    before = ssm_scan.LAUNCHES
    y, h = ssm_scan.launch(*args, lanes)
    assert ssm_scan.LAUNCHES == before + 1
    wy, wh = ssm_scan.ssm_scan_plain(*args)
    torch.testing.assert_close(y, wy, rtol=SCAN_TOL, atol=SCAN_TOL)
    torch.testing.assert_close(h, wh, rtol=SCAN_TOL, atol=SCAN_TOL)


@pytest.mark.parametrize("n", [8, 16])
def test_ssm_scan_final_states_do_not_depend_on_the_lanes(cuda, n):
    """Each state runs the same instructions whatever the lane count, so
    the final states of every lane count are equal bit for bit (y sums
    in another order and is only close)."""
    args = _scan_inputs(cuda, 3, 300, 3200, n, n)
    runs = {lanes: ssm_scan.launch(*args, lanes)
            for lanes in ssm_scan.lane_counts(n)}
    for lanes, (y, h) in runs.items():
        assert torch.equal(h, runs[1][1]), lanes
        torch.testing.assert_close(y, runs[1][0], rtol=SCAN_TOL,
                                   atol=SCAN_TOL)


def test_ssm_scan_offset_operands_match_plain(cuda):
    """Operands that are contiguous but start 4 bytes past a 16-byte
    boundary (a view at storage offset 1) take the 4-byte copies, at a
    d_inner whose rows would otherwise be aligned."""
    b, s, di, n = 2, 40, 64, 16
    args = _scan_inputs(cuda, b, s, di, n, 3)
    offset = []
    for t in args:
        flat = torch.empty(t.numel() + 1, device=cuda)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16 == 4
        offset.append(view)
    wy, wh = ssm_scan.ssm_scan_plain(*args)
    for lanes in ssm_scan.lane_counts(n):
        y, h = ssm_scan.launch(*offset, lanes)
        torch.testing.assert_close(y, wy, rtol=SCAN_TOL, atol=SCAN_TOL)
        torch.testing.assert_close(h, wh, rtol=SCAN_TOL, atol=SCAN_TOL)


def test_ssm_scan_lane_counts_are_the_instantiated_ones(cuda):
    """The library's instantiations are the Python table's: shared
    memory for each of them and none for any other (lanes, n); a launch
    at a lane count the kernel lacks raises (cudaErrorInvalidValue) and
    is not counted."""
    lib = _build.load("ssm_scan", ssm_scan._SIGNATURES)
    for n in (4, 8, 16, 32):
        for lanes in (0, 1, 2, 3, 4, 8, 16):
            want = n in ssm_scan.STATES and lanes in ssm_scan.lane_counts(n)
            assert (lib.ssm_scan_smem(lanes, n) > 0) == want, (lanes, n)
    args = _scan_inputs(cuda, 1, 20, 64, 8, 1)
    before = ssm_scan.LAUNCHES
    for lanes in (0, 3, 8, 16):
        with pytest.raises(RuntimeError, match="launch failed"):
            ssm_scan.launch(*args, lanes)
    assert ssm_scan.LAUNCHES == before
    assert ssm_scan.scan_plan(1, 64, 8).lanes in ssm_scan.lane_counts(8)


def test_ssm_scan_kernel_rejects_what_it_cannot_take(cuda):
    args = list(_scan_inputs(cuda, 1, 8, 16, 4, 0))
    with pytest.raises(ValueError, match="states"):
        ssm_scan.ssm_scan(*args)
    args = list(_scan_inputs(cuda, 1, 8, 16, 8, 0))
    bad = list(args)
    bad[1] = args[1].double()
    with pytest.raises(TypeError):
        ssm_scan.ssm_scan(*bad)
    bad = list(args)
    bad[1] = args[1].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ssm_scan.ssm_scan(*bad)


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "hymba_1_5b"])
def test_ssm_hybrid_smoke_serve_on_card_matches_the_cpu_port(cuda, arch):
    """The smoke config's serve loop (float32 end to end) on the card
    against the port on the CPU: logits within 1e-4, greedy tokens equal;
    the prefill launches the scan kernel once a layer, and hymba the
    attention kernel once a layer (its window of 16 under a 60-token
    prefill)."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.core import prng
    from repro_torch.launch import steps
    from repro_torch.models import init_caches, init_params, transformer
    cfg = dataclasses.replace(configs.get_smoke(arch),
                              compute_dtype="float32")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 64)))
    runs = {}
    for dev in (torch.device("cpu"), cuda):
        params = init_params(cfg, prng.PRNGKey(0, device=dev))
        caches = init_caches(cfg, 2, 64, torch.float32, device=dev)
        before = flash_attn.LAUNCHES, ssm_scan.LAUNCHES
        with torch.inference_mode():
            logits, caches, _, _ = transformer.forward(
                params, cfg, {"tokens": toks[:, :60].to(dev)},
                caches=caches, last_only=True)
        launches = (flash_attn.LAUNCHES - before[0],
                    ssm_scan.LAUNCHES - before[1])
        decode, _ = steps.build_decode_step(cfg, batch=2, max_len=64,
                                            device=dev)
        outs = [logits[:, -1].cpu()]
        for i in range(3):
            logits, caches = decode(params, caches,
                                    toks[:, 60 + i:61 + i].to(dev),
                                    torch.full((2,), 60 + i,
                                               dtype=torch.int32,
                                               device=dev))
            outs.append(logits[:, 0].cpu())
        runs[dev.type] = (outs, launches)
    attn_layers = cfg.n_layers if cfg.family == "hybrid" else 0
    assert runs["cpu"][1] == (0, 0)
    assert runs["cuda"][1] == (attn_layers, cfg.n_layers)
    for g, w in zip(runs["cuda"][0], runs["cpu"][0]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
        assert torch.equal(g.argmax(-1), w.argmax(-1))


# ---------------------------------------------------------------------------
# The attention backward kernels (training).
# ---------------------------------------------------------------------------

def _bwd_inputs(cuda, dtype, b, h, hk, s, t, d, seed, dv=None):
    dv = d if dv is None else dv
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q = (0.5 * torch.randn(b, h, s, d, device=cuda, generator=gen)).to(dtype)
    k = (0.5 * torch.randn(b, hk, t, d, device=cuda, generator=gen)).to(dtype)
    v = torch.randn(b, hk, t, dv, device=cuda, generator=gen).to(dtype)
    do = torch.randn(b, h, s, dv, device=cuda, generator=gen).to(dtype)
    return q, k, v, do


def _scaled_err(got, want) -> float:
    """Largest |got - want| over the largest |want|."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


# The backward against its plain version (autograd through the float32
# reference): float32 sums in other orders, 1e-5 of the gradient's scale
# (3e-6 seen); bf16 rounds P and dS to bf16 before their products and the
# gradients to bf16, 2e-2 of the scale (5.4e-3 seen).
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


# Ragged lengths, groups of 1 and 4, S = 1000 (no multiple of the wgmma
# kernels' 64- and 128-row tiles) and Qwen3-4B's training heads (32 / 8
# at 2048).
@pytest.mark.parametrize("d", flash_attn.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,hk,s,t", [(2, 2, 77, 77), (8, 2, 300, 300),
                                      (4, 1, 130, 200), (8, 2, 1000, 1000),
                                      (32, 8, 2048, 2048)])
def test_flash_attention_bwd_matches_plain(cuda, d, dtype, causal, h, hk, s,
                                           t):
    q, k, v, do = _bwd_inputs(cuda, dtype, 2, h, hk, s, t, d, d + s)
    lse = torch.empty(2, h, s, device=cuda)
    out = flash_attn.flash_attention(q, k, v, causal=causal, lse=lse)
    torch.testing.assert_close(lse, ref.attention_lse(q, k, causal=causal),
                               rtol=0, atol=1e-5)
    before = flash_attn_bwd.LAUNCHES
    got = flash_attn_bwd.flash_attention_bwd(q, k, v, out, do, lse,
                                             causal=causal)
    assert flash_attn_bwd.LAUNCHES == before + 1
    want = flash_attn_bwd.flash_attention_bwd_plain(q, k, v, do,
                                                    causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert _scaled_err(g, w) <= BWD_TOL[dtype]


# Multi-head latent attention's pairs: DeepSeek-V3's (192, 128) on the
# wgmma kernels in bf16, its smoke config's (24, 16) on the FMAs, both on
# the FMAs in float32; MLA's scale (the default, D ** -0.5) and another;
# ragged lengths, groups of 1 and 4, and DeepSeek-V3's 128 heads at 2048;
# then lengths around the (192, 128) kernels' 64-query items and 128-key
# dK/dV tiles (63, 64, 65, 129; S past T and T past S), and 12 KV heads,
# a launch group of 8 and one of 4.
BWD_PAIR_SHAPES = [(2, 2, 77, 77), (8, 2, 300, 300), (4, 1, 130, 200),
                   (8, 8, 1000, 1000), (128, 128, 2048, 2048),
                   (4, 4, 63, 63), (4, 4, 64, 64), (4, 4, 65, 65),
                   (4, 1, 129, 129), (4, 4, 200, 130), (12, 12, 129, 129),
                   (24, 12, 130, 200)]


@pytest.mark.parametrize("d,dv", [(192, 128), (24, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("scale", [None, 0.37])
@pytest.mark.parametrize("h,hk,s,t", BWD_PAIR_SHAPES)
def test_flash_attention_bwd_pairs_match_plain(cuda, d, dv, dtype, causal,
                                               scale, h, hk, s, t):
    b = 1 if h == 128 else 2
    q, k, v, do = _bwd_inputs(cuda, dtype, b, h, hk, s, t, d, d + s, dv)
    lse = torch.empty(b, h, s, device=cuda)
    out = flash_attn.flash_attention(q, k, v, causal=causal, scale=scale,
                                     lse=lse)
    torch.testing.assert_close(
        lse, ref.attention_lse(q, k, causal=causal, scale=scale), rtol=0,
        atol=1e-5)
    before = flash_attn_bwd.LAUNCHES
    got = flash_attn_bwd.flash_attention_bwd(q, k, v, out, do, lse,
                                             causal=causal, scale=scale)
    assert flash_attn_bwd.LAUNCHES == before + 1
    want = flash_attn_bwd.flash_attention_bwd_plain(q, k, v, do,
                                                    causal=causal,
                                                    scale=scale)
    for g, w, width in zip(got, want, (d, d, dv)):
        assert g.dtype == dtype and g.shape == w.shape
        assert g.shape[-1] == width
        assert _scaled_err(g, w) <= BWD_TOL[dtype]


@pytest.mark.parametrize("d,dv", [(192, 128), (24, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_pairs_are_deterministic(cuda, d, dv, dtype):
    """No atomics at the pairs either: two runs give the same bits."""
    q, k, v, do = _bwd_inputs(cuda, dtype, 1, 8, 2, 700, 700, d, 5, dv)
    lse = torch.empty(1, 8, 700, device=cuda)
    out = flash_attn.flash_attention(q, k, v, lse=lse)
    a = flash_attn_bwd.flash_attention_bwd(q, k, v, out, do, lse)
    b = flash_attn_bwd.flash_attention_bwd(q, k, v, out, do, lse)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,hk,s,t", BWD_PAIR_SHAPES[5:])
def test_flash_attention_bwd_pair_is_deterministic_around_its_tiles(
        cuda, causal, h, hk, s, t):
    """DeepSeek-V3's pair on the wgmma kernels in bf16 at the lengths
    around their tiles: two runs give the same bits (no atomics; every
    block writes its own rows)."""
    q, k, v, do = _bwd_inputs(cuda, torch.bfloat16, 2, h, hk, s, t, 192, 7,
                              128)
    lse = torch.empty(2, h, s, device=cuda)
    out = flash_attn.flash_attention(q, k, v, causal=causal, lse=lse)
    a = flash_attn_bwd.flash_attention_bwd(q, k, v, out, do, lse,
                                           causal=causal)
    b = flash_attn_bwd.flash_attention_bwd(q, k, v, out, do, lse,
                                           causal=causal)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hk,s", [(8, 2, 700), (8, 2, 1000), (32, 8, 2048)])
def test_flash_attention_bwd_is_deterministic(cuda, dtype, h, hk, s):
    """No atomics: two runs give the same bits."""
    q, k, v, do = _bwd_inputs(cuda, dtype, 1, h, hk, s, s, 128, 3)
    lse = torch.empty(1, h, s, device=cuda)
    out = flash_attn.flash_attention(q, k, v, lse=lse)
    a = flash_attn_bwd.flash_attention_bwd(q, k, v, out, do, lse)
    b = flash_attn_bwd.flash_attention_bwd(q, k, v, out, do, lse)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_flash_attention_bwd_refuses_before_any_launch(cuda):
    """A window over more query rows than keys, a negative window or a
    pair outside ``flash_attn.PAIRS`` raises ValueError and launches
    nothing."""
    x = torch.zeros(1, 2, 8, 192, device=cuda, dtype=torch.bfloat16)
    v64 = torch.zeros(1, 2, 8, 64, device=cuda, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 8, device=cuda)
    before = flash_attn_bwd.LAUNCHES
    with pytest.raises(ValueError, match="S <= T"):
        flash_attn_bwd.flash_attention_bwd(x, x[:, :, :4], x[:, :, :4], x, x,
                                           lse, window=4)
    with pytest.raises(ValueError, match="window"):
        flash_attn_bwd.flash_attention_bwd(x, x, x, x, x, lse, window=-2)
    with pytest.raises(ValueError, match="192, 64"):
        flash_attn_bwd.flash_attention_bwd(x, x, v64, v64, v64, lse)
    x24 = torch.zeros(1, 2, 8, 24, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="24, 8"):
        flash_attn_bwd.flash_attention_bwd(x24, x24, x24[..., :8],
                                           x24[..., :8], x24[..., :8], lse)
    assert flash_attn_bwd.LAUNCHES == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_model_attention_gradient_on_card_matches_chunked(cuda, dtype):
    """The model's attention under autograd on the card runs the kernels
    both ways (a ``_KernelAttention`` node) and its gradients match the
    plain chunked attention's under autograd on the card."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    ops_ = [torch.randn(2, 256, hh, 16, device=cuda, generator=gen)
            .to(dtype).requires_grad_() for hh in (8, 2, 2)]
    fwd, bwd = flash_attn.LAUNCHES, flash_attn_bwd.LAUNCHES
    out = attention.flash_attention(*ops_, causal=True, chunk=32)
    assert type(out.grad_fn).__name__ == "_KernelAttentionBackward"
    got = torch.autograd.grad(out.float().square().sum(), ops_)
    assert (flash_attn.LAUNCHES, flash_attn_bwd.LAUNCHES) == (fwd + 1,
                                                             bwd + 1)
    plain = attention.chunked_attention(*ops_, causal=True, chunk=32)
    want = torch.autograd.grad(plain.float().square().sum(), ops_)
    for g, w in zip(got, want):
        assert _scaled_err(g, w) <= BWD_TOL[dtype]


# DeepSeek-V3's smoke config (MLA at (24, 16), MoE, the mtp head) under
# autograd on the card, the kernels both ways against the plain chunked
# attention: the loss to 1e-5 (float32) and 2e-3 (bf16), each gradient
# leaf within 3e-3 (float32, the CPU's bound against JAX in
# test_torch_lm_train_mtp.py) and 0.1 (bf16, chip_smoke.py's full-width
# bound) of its largest element.  bf16 takes neutral routing (capacity
# factor 8, every expert; tests/lm_parity.py's neutral_routing): one bf16
# ulp flips a near-tied expert otherwise.
MLA_SMOKE_TOL = {"float32": (1e-5, 3e-3), "bfloat16": (2e-3, 0.1)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deepseek_smoke_gradients_on_card_match_chunked(cuda, dtype,
                                                        monkeypatch):
    import dataclasses

    from repro_torch import configs
    from repro_torch.data import DataConfig, batch_for_model
    from repro_torch.models import init_params, layers, loss_fn
    base = configs.get_smoke("deepseek_v3_671b")
    over = {"compute_dtype": dtype}
    if dtype == "bfloat16":
        over.update(capacity_factor=8.0, top_k=base.n_experts)
    cfg = dataclasses.replace(base, **over)
    params = init_params(cfg, prng.PRNGKey(0, device=cuda))
    leaves = [t.requires_grad_(True) for _, t in layers.tree_items(params)]
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in batch_for_model(
        cfg, DataConfig(seed=0, seq_len=64, global_batch=2,
                        vocab_size=cfg.vocab_size), 0).items()}

    def run():
        loss, _ = loss_fn(params, cfg, batch)
        return loss.item(), torch.autograd.grad(loss, leaves)

    fwd, bwd = flash_attn.LAUNCHES, flash_attn_bwd.LAUNCHES
    got_loss, got = run()
    # Remat runs each layer's forward twice; the mtp block's once.
    assert flash_attn.LAUNCHES - fwd == 2 * cfg.n_layers + 1
    assert flash_attn_bwd.LAUNCHES - bwd == cfg.n_layers + 1
    monkeypatch.setattr(attention, "flash_attention",
                        attention.chunked_attention)
    want_loss, want = run()
    loss_tol, grad_tol = MLA_SMOKE_TOL[dtype]
    assert abs(got_loss - want_loss) <= loss_tol * abs(want_loss)
    for g, w in zip(got, want):
        assert w.abs().max() > 0
        assert _scaled_err(g, w) <= grad_tol


def test_kernels_without_backward_refuse_a_gradient(cuda):
    """No gradient passes silently through a kernel wrapper that has no
    backward: the forward kernel itself and the scan kernel's wrapper
    raise, and so does the model's attention under a window over more
    query rows than keys or at a pair outside ``flash_attn.PAIRS``; under
    a window with S <= T it is ``_KernelAttention``."""
    q = torch.randn(1, 4, 64, 64, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        flash_attn.flash_attention(q, q, q)
    with torch.no_grad():
        flash_attn.flash_attention(q, q, q)
    m = torch.randn(1, 64, 4, 64, device=cuda, requires_grad=True)
    with pytest.raises(ValueError, match="S <= T"):
        attention.flash_attention(m, m[:, :32], m[:, :32], window=16)
    out = attention.flash_attention(m, m, m, window=16)
    assert type(out.grad_fn).__name__ == "_KernelAttentionBackward"
    m192 = torch.randn(1, 64, 4, 192, device=cuda, requires_grad=True)
    with pytest.raises(ValueError, match="192, 64"):
        attention.flash_attention(m192, m192, m192[..., :64])
    x = torch.randn(1, 8, 128, device=cuda, requires_grad=True)
    n = 16
    with pytest.raises(RuntimeError, match="no gradient of its own"):
        ssm_scan.ssm_scan(x, x, torch.randn(1, 8, n, device=cuda),
                          torch.randn(1, 8, n, device=cuda),
                          -torch.rand(128, n, device=cuda),
                          torch.randn(128, device=cuda),
                          torch.zeros(1, 128, n, device=cuda))


def test_train_lm_default_scale_trains_on_card(cuda, tmp_path):
    """``examples/train_lm.py``'s default ``10m`` scale (head width 40)
    trains on the card through both attention kernels, and its loss
    falls over 40 steps."""
    from repro_torch.examples import train_lm
    cfg = train_lm.scale_config("10m")
    assert cfg.head_dim == 40
    fwd, bwd = flash_attn.LAUNCHES, flash_attn_bwd.LAUNCHES
    out = train_lm.train(cfg, steps=40, seq=64, ckpt=str(tmp_path),
                         log_every=0, device=cuda)
    assert flash_attn.LAUNCHES > fwd and flash_attn_bwd.LAUNCHES > bwd
    losses = [h.metrics["loss"] for h in out["history"]]
    assert len(losses) == 40 and all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 1.0


# ---------------------------------------------------------------------------
# The scan's backward (G3) and attention's backward under the window (G2).
# ---------------------------------------------------------------------------

# The scan's backward against its plain version (float32 autograd through
# the chunked scan), each gradient to 1e-4 of its largest element: float32
# sums over time, channels or states in other orders, and the kernel's
# decays are ex2.approx, an ulp or two from torch's exp.
SCAN_BWD_TOL = 1e-4


def _offset(cuda, t):
    """A contiguous copy of ``t`` that starts 4 bytes past a 16-byte
    boundary (a view at storage offset 1)."""
    flat = torch.empty(t.numel() + 1, device=cuda)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    return view


def _scan_grad_run(cuda, b, s, di, n, seed, with_dh, chunk=None,
                   offset=False):
    args = _scan_inputs(cuda, b, s, di, n, seed)
    gen = torch.Generator(device=cuda).manual_seed(seed + 1)
    dy = torch.randn(b, s, di, device=cuda, generator=gen)
    dh = torch.randn(b, di, n, device=cuda, generator=gen) if with_dh \
        else None
    ckpt = torch.empty(b, ssm_scan_bwd.checkpoints(s), di, n, device=cuda)
    ssm_scan.ssm_scan(*args, ckpt=ckpt)
    before = ssm_scan_bwd.LAUNCHES
    ops = [*args, dy, dh]
    if offset:
        ops = [None if t is None else _offset(cuda, t) for t in ops]
    got = ssm_scan_bwd.ssm_scan_bwd(*ops, ckpt=ckpt, chunk=chunk)
    assert ssm_scan_bwd.LAUNCHES == before + 1
    want = ssm_scan_bwd.ssm_scan_bwd_plain(*args, dy, dh)
    return args, dy, dh, ckpt, got, want


# The backward's chunk lengths under test: one tile, and every length the
# plan picks from.
SCAN_BWD_CHUNKS = (16,) + ssm_scan_bwd.CHUNK_STEPS


@pytest.mark.parametrize("n", ssm_scan.STATES)
@pytest.mark.parametrize("s", [1, 15, 16, 300])
@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("chunk", SCAN_BWD_CHUNKS)
def test_ssm_scan_bwd_matches_plain(cuda, n, s, with_dh, chunk):
    """n 8 and 16 (2 and 4 lanes) and every chunk length; S below one
    16-step checkpoint interval, at it and ragged past the plain
    version's 256-step chunk (below one chunk, at it, and ragged over
    several); the final state's gradient absent and present; 200 channels
    (a ragged last block) over 2 batch rows."""
    _, _, _, _, got, want = _scan_grad_run(cuda, 2, s, 200, n,
                                           s + n + n // 4, with_dh, chunk)
    for name, g, w in zip(("dt", "x", "B", "C", "A", "D", "h0"), got, want):
        assert g.shape == w.shape and torch.isfinite(g).all(), name
        assert _scaled_err(g, w) <= SCAN_BWD_TOL, name


@pytest.mark.parametrize("n", ssm_scan.STATES)
@pytest.mark.parametrize("di,offset", [(33, False), (64, True),
                                       (33, True)])
@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("chunk", [16, 64])
def test_ssm_scan_bwd_scalar_staging_matches_plain(cuda, n, di, offset,
                                                   with_dh, chunk):
    """The 4-byte copies of the walk's and the pre-pass's staging: an odd
    d_inner (rows off 16-byte boundaries), operands at storage offset 1
    at a d_inner whose rows would be aligned, and both; 300 steps over
    19 or 5 chunks, so the pre-pass runs."""
    _, _, _, _, got, want = _scan_grad_run(cuda, 2, 300, di, n,
                                           di + n + chunk, with_dh, chunk,
                                           offset)
    for name, g, w in zip(("dt", "x", "B", "C", "A", "D", "h0"), got, want):
        assert g.shape == w.shape and torch.isfinite(g).all(), name
        assert _scaled_err(g, w) <= SCAN_BWD_TOL, name


@pytest.mark.parametrize("di", [8192, 3200])
@pytest.mark.parametrize("chunk", ssm_scan_bwd.CHUNK_STEPS)
def test_ssm_scan_bwd_at_the_training_shapes(cuda, di, chunk):
    """Falcon-Mamba-7B's (1, 2048, 8192, 16) and Hymba-1.5B's (1, 2048,
    3200, 16) training micro-batches (4 lanes at both) at every chunk
    length the plan picks from, twice: the same bits."""
    args, dy, _, ckpt, got, want = _scan_grad_run(cuda, 1, 2048, di, 16,
                                                  di, False, chunk)
    for g, w in zip(got, want):
        assert _scaled_err(g, w) <= SCAN_BWD_TOL
    again = ssm_scan_bwd.ssm_scan_bwd(*args, dy, ckpt=ckpt, chunk=chunk)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_ssm_scan_checkpoints_are_the_states_at_the_tiles(cuda):
    """The forward's checkpoint j is the state before step 16 j: h0, then
    the plain scan's final state over the first 16 j steps."""
    args = _scan_inputs(cuda, 2, 70, 96, 16, 4)
    ckpt = torch.empty(2, 5, 96, 16, device=cuda)
    y, h = ssm_scan.ssm_scan(*args, ckpt=ckpt)
    wy, _ = ssm_scan.ssm_scan(*args)
    assert torch.equal(y, wy)
    assert torch.equal(ckpt[:, 0], args[6])
    for j in range(1, 5):
        cut = [t[:, :16 * j] if t.dim() == 3 and t.shape[1] == 70 else t
               for t in args]
        torch.testing.assert_close(ckpt[:, j],
                                   ssm_scan.ssm_scan_plain(*cut)[1],
                                   rtol=SCAN_TOL, atol=SCAN_TOL)


def test_ssm_scan_bwd_planted_fault_dropped_partial(cuda):
    """The check must see one block's dB partial dropped: dB summed over
    every block of channels but the second (channels 32-63 at the plan's
    4 lanes) is the plain version's gradient of the scan without those
    channels (each channel's recurrence is its own), and it fails the
    tolerance against the kernel's dB."""
    args, dy, _, _, got, want = _scan_grad_run(cuda, 1, 300, 256, 16, 11,
                                               False)
    keep = torch.cat([torch.arange(0, 32), torch.arange(64, 256)]).to(cuda)
    dt, x, bm, cm, a, d, h0 = args
    dropped = ssm_scan_bwd.ssm_scan_bwd_plain(
        dt[..., keep], x[..., keep], bm, cm, a[keep], d[keep], h0[:, keep],
        dy[..., keep])[2]
    assert _scaled_err(got[2], want[2]) <= SCAN_BWD_TOL
    assert _scaled_err(got[2], dropped) > SCAN_BWD_TOL


def test_ssm_scan_bwd_planted_fault_dropped_chunk_carry(cuda):
    """The check must see a chunk's incoming carry dropped: with the
    carry into the first 64-step chunk zero, that chunk's gradients are
    the plain version's of the scan cut after step 64 (the later steps
    reach the earlier ones only through that carry), and they fail the
    tolerance against the kernel's d(dt) and dx there (dh0, 64 decays
    away from the carry, moves by less: 8.6e-5 of itself, seen)."""
    args, dy, _, _, got, want = _scan_grad_run(cuda, 1, 300, 256, 16, 13,
                                               False, 64)
    cut = [t[:, :64] if t.dim() == 3 and t.shape[1] == 300 else t
           for t in args]
    dropped = ssm_scan_bwd.ssm_scan_bwd_plain(*cut, dy[:, :64])
    for i in (0, 1):
        assert _scaled_err(got[i], want[i]) <= SCAN_BWD_TOL
        assert _scaled_err(got[i][:, :64], dropped[i]) > SCAN_BWD_TOL


def test_ssm_scan_bwd_refuses_without_checkpoints(cuda):
    args = _scan_inputs(cuda, 1, 32, 64, 16, 1)
    dy = torch.zeros(1, 32, 64, device=cuda)
    before = ssm_scan_bwd.LAUNCHES
    with pytest.raises(ValueError, match="checkpoints"):
        ssm_scan_bwd.ssm_scan_bwd(*args, dy)
    with pytest.raises(ValueError, match="chunk"):
        ssm_scan_bwd.ssm_scan_bwd(*args, dy, chunk=24,
                                  ckpt=torch.empty(1, 2, 64, 16,
                                                   device=cuda))
    assert ssm_scan_bwd.LAUNCHES == before


def _window_errs(got, want) -> list:
    """:func:`_scaled_err` of each gradient; one that is exactly zero is
    held at the largest of the three's scale instead (at window 1 under
    causal masking a row sees only itself, p = 1 and dS = dP - delta = 0,
    so dQ and dK vanish but for rounding)."""
    top = max(w.float().abs().max().item() for w in want)
    return [(g.float() - w.float()).abs().max().item()
            / (w.float().abs().max().item() or top)
            for g, w in zip(got, want)]


def _window_bwd(cuda, d, dv, dtype, causal, window, s=1100, h=10, hk=2,
                seed=0):
    q, k, v, do = _bwd_inputs(cuda, dtype, 1, h, hk, s, s, d, seed + window,
                              dv)
    lse = torch.empty(1, h, s, device=cuda)
    out = flash_attn.flash_attention(q, k, v, causal=causal, window=window,
                                     lse=lse)
    torch.testing.assert_close(
        lse, ref.attention_lse(q, k, causal=causal, window=window), rtol=0,
        atol=1e-5)
    before = flash_attn_bwd.LAUNCHES
    got = flash_attn_bwd.flash_attention_bwd(q, k, v, out, do, lse,
                                             causal=causal, window=window)
    assert flash_attn_bwd.LAUNCHES == before + 1
    return (q, k, v, do, out, lse), got


@pytest.mark.parametrize("window", [1, 7, 63, 64, 1000, 1024, 1100])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d,dtype", WINDOW_KERNELS)
def test_flash_attention_bwd_window_matches_plain(cuda, window, causal, d,
                                                  dtype):
    """The forward's window tests' shapes (S = T = 1100, 10 heads on 2: g
    = 5; windows 1 to >= S) and kernels (FMA, mma.sync, wgmma) under the
    unwindowed backward's bounds."""
    (q, k, v, do, _, _), got = _window_bwd(cuda, d, d, dtype, causal, window)
    want = flash_attn_bwd.flash_attention_bwd_plain(
        q, k, v, do, causal=causal, window=window)
    for g in got:
        assert g.dtype == dtype and torch.isfinite(g.float()).all()
    assert max(_window_errs(got, want)) <= BWD_TOL[dtype]


@pytest.mark.parametrize("window", [7, 64, 1000])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d,dv,dtype", [
    (192, 128, torch.bfloat16), (24, 16, torch.bfloat16),
    (24, 16, torch.float32), (32, 32, torch.bfloat16),
    (40, 40, torch.bfloat16), (80, 80, torch.bfloat16),
    (192, 192, torch.bfloat16)])
def test_flash_attention_bwd_window_at_every_kernel(cuda, window, causal, d,
                                                    dv, dtype):
    """The window at the kernels the forward's window tests leave out:
    the (192, 128) wgmma kernels (128-key dK/dV blocks), mma.sync at 32,
    80 and 192, the FMAs at 40 and (24, 16)."""
    (q, k, v, do, _, _), got = _window_bwd(cuda, d, dv, dtype, causal, window,
                                           s=700, h=8, hk=8)
    want = flash_attn_bwd.flash_attention_bwd_plain(
        q, k, v, do, causal=causal, window=window)
    assert max(_window_errs(got, want)) <= BWD_TOL[dtype]


@pytest.mark.parametrize("d,dv", [(64, 64), (192, 128)])
def test_flash_attention_bwd_window_is_deterministic(cuda, d, dv):
    (q, k, v, do, out, lse), a = _window_bwd(cuda, d, dv, torch.bfloat16,
                                             True, 1024, s=2048, h=25, hk=5)
    b = flash_attn_bwd.flash_attention_bwd(q, k, v, out, do, lse,
                                           causal=True, window=1024)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("d,dtype", WINDOW_KERNELS)
def test_flash_attention_bwd_window_planted_faults(cuda, d, dtype):
    """The check must see a window off by one 64-key tile: the kernel at
    window 128 against the plain backward at 64 and 192, and without a
    window, fails the bound in some gradient."""
    (q, k, v, do, _, _), got = _window_bwd(cuda, d, d, dtype, True, 128,
                                           s=600)
    for w in (64, 192, 0):
        bad = flash_attn_bwd.flash_attention_bwd_plain(
            q, k, v, do, causal=True, window=w)
        assert max(_scaled_err(g, b) for g, b in zip(got, bad)) \
            > BWD_TOL[dtype], w


@pytest.mark.parametrize("window", [1, 63, 64, 65, 1024, None])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [130, 1100])
def test_flash_attention_bwd_d64_window_gqa(cuda, s, causal, window):
    """G2's kernels (bf16 at (64, 64): the row records' pre-pass, dK/dV,
    dQ) at Hymba-1.5B's 25 heads on 5, S no
    multiple of the 64-row tiles, windows from 1 to S itself (None), under
    the windowed bound; two runs give the same bits."""
    window = s if window is None else window
    (q, k, v, do, out, lse), got = _window_bwd(
        cuda, 64, 64, torch.bfloat16, causal, window, s=s, h=25, hk=5)
    want = flash_attn_bwd.flash_attention_bwd_plain(
        q, k, v, do, causal=causal, window=window)
    assert max(_window_errs(got, want)) <= BWD_TOL[torch.bfloat16]
    again = flash_attn_bwd.flash_attention_bwd(q, k, v, out, do, lse,
                                               causal=causal, window=window)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


# G2's dK and dV by rows against the kernels' own algorithm in plain torch
# (tests/attention_rows.py: P and dS rounded to bf16 where the kernels
# round them), a bound tight enough to see one (head, query tile) item
# left out of a key tile's walk, which can stay under the windowed bound
# (2e-2 of the gradient's largest element) and the unwindowed row bound
# (0.1): the test asserts both sides of it.
RECORD_ROW_TOL = 1e-2


def test_flash_attention_bwd_d64_planted_faults(cuda):
    """The checks must tell G2's kernels from a row record one tile off
    and from a skipped item: the first item of a walk, one inside it, and
    the last item of each consumer of key tile 0's walk."""
    kw = dict(causal=True, window=1024)
    (q, k, v, do, out, lse), got = _window_bwd(
        cuda, 64, 64, torch.bfloat16, True, 1024, s=1100, h=25, hk=5)
    rec = flash_attn_bwd.row_records_plain(out, do, lse)
    own = bwd_from_records(q, k, v, do, rec, bf16=True, **kw)
    assert max(row_errs(got[1:], own[1:])) <= RECORD_ROW_TOL
    assert max(_window_errs(got, own)) <= BWD_TOL[torch.bfloat16]
    for shift in (1, -1):           # one 64-row tile of records
        off = bwd_from_records(q, k, v, do, torch.roll(rec, shift, dims=2),
                               bf16=True, **kw)
        assert max(_window_errs(got, off)) > BWD_TOL[torch.bfloat16], shift
    for item in ((20, 0, 0), (4, 15, 0), (9, 14, 2), (24, 15, 0),
                 (24, 16, 0)):
        skipped = bwd_from_records(q, k, v, do, rec, bf16=True, skip=item,
                                   **kw)
        assert max(row_errs(got[1:], skipped[1:])) > RECORD_ROW_TOL, item

# The SSM and hybrid smoke configs under autograd on the card, the scan and
# attention kernels both ways against the plain scan and chunked attention
# swapped in: the loss to 1e-5 (float32) and 2e-3 (bf16) relative, each
# gradient leaf within 3e-3 (float32) and 0.1 (bf16, chip_smoke.py's
# full-width bound) of its largest element.
SSM_SMOKE_TOL = {"float32": (1e-5, 3e-3), "bfloat16": (2e-3, 0.1)}


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "hymba_1_5b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_smoke_gradients_on_card_match_plain(cuda, arch, dtype,
                                                 monkeypatch):
    import dataclasses

    from repro_torch import configs
    from repro_torch.data import DataConfig, batch_for_model
    from repro_torch.models import init_params, layers, loss_fn
    cfg = dataclasses.replace(configs.get_smoke(arch), compute_dtype=dtype)
    params = init_params(cfg, prng.PRNGKey(0, device=cuda))
    leaves = [t.requires_grad_(True) for _, t in layers.tree_items(params)]
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in batch_for_model(
        cfg, DataConfig(seed=0, seq_len=64, global_batch=2,
                        vocab_size=cfg.vocab_size), 0).items()}

    def run():
        loss, _ = loss_fn(params, cfg, batch)
        return loss.item(), torch.autograd.grad(loss, leaves)

    counts = (ssm_scan.LAUNCHES, ssm_scan_bwd.LAUNCHES, flash_attn.LAUNCHES,
              flash_attn_bwd.LAUNCHES)
    got_loss, got = run()
    attn = cfg.n_layers if cfg.family == "hybrid" else 0
    # Remat runs each layer's forward twice, its backward once.
    assert tuple(now - was for now, was in zip(
        (ssm_scan.LAUNCHES, ssm_scan_bwd.LAUNCHES, flash_attn.LAUNCHES,
         flash_attn_bwd.LAUNCHES), counts)) == (2 * cfg.n_layers,
                                                cfg.n_layers, 2 * attn, attn)
    import functools

    from repro_torch.models import ssm as ssm_model
    monkeypatch.setattr(attention, "flash_attention",
                        attention.chunked_attention)
    monkeypatch.setattr(ssm_model, "ssm_scan",
                        functools.partial(ssm_model.ssm_scan, plain=True))
    plain = (ssm_scan.LAUNCHES, ssm_scan_bwd.LAUNCHES)
    want_loss, want = run()
    assert (ssm_scan.LAUNCHES, ssm_scan_bwd.LAUNCHES) == plain
    loss_tol, grad_tol = SSM_SMOKE_TOL[dtype]
    assert abs(got_loss - want_loss) <= loss_tol * abs(want_loss)
    for g, w in zip(got, want):
        assert w.abs().max() > 0
        assert _scaled_err(g, w) <= grad_tol
