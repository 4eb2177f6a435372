"""chip_smoke.py's account of the attention and scan kernels' resources,
and the work that the attention, FFT-stage and scan bounds count.

``fa_resources`` reads ``nvcc -Xptxas -v``'s log of
``csrc/flash_attn.cu`` on the card and fails the run if an instantiation
of the wgmma or the float32 FMA kernel spills or a launch would take more
shared memory than a block may have; here it reads logs written in
ptxas's format.  ``repro_torch.timing.attention_work`` and
``fft_stage_work`` give the bytes and operations of the bounds that
``chip_smoke.py`` and ``examples/kernel_times.py`` print.
"""
import importlib.util
from pathlib import Path

import pytest
import torch
from attention_rows import wgmma_smem

from repro_torch import timing
from repro_torch.kernels import flash_attn, flash_attn_bwd, ops, ssm_scan

WGMMA_SMEM = {(64, 64): 132096, (80, 80): 197632, (128, 128): 197632,
              (192, 192): 197632, (192, 128): 214016}
FMA_SMEM = {(d, dv): (2 * (d + 4) + dv + 4) * 64 * 4 + 64 * 68 * 4
            for d, dv in flash_attn.PAIRS}


def _name(kernel, d, dv):
    return f"{kernel} d{d}" + ("" if dv == d else f" dv{dv}")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _entry(mangled: str, spill: int = 0, regs: int = 168) -> str:
    return (f"ptxas info    : Compiling entry function '{mangled}' for "
            f"'sm_90a'\n"
            f"ptxas info    : Function properties for {mangled}\n"
            f"    {spill} bytes stack frame, {spill} bytes spill stores, "
            f"{spill} bytes spill loads\n"
            f"ptxas info    : Used {regs} registers, used 1 barriers, "
            f"80 bytes smem\n")


def _log(spills=None, skip=()) -> str:
    """A ptxas log of every attention kernel in csrc/flash_attn.cu, with
    ``spills`` bytes in the kernels it names and none of those in
    ``skip``."""
    spills = spills or {}
    prefix = "_ZN46_GLOBAL__N__72ef4e4e_13_flash_attn_cu_db5e4e7b"
    names = ([f"15fa_wgmma_kernelILi{d}ELi{dv}EEEv14CUtensorMap_st"
              for d, dv in WGMMA_SMEM]
             + [f"13fa_mma_kernelILi{d}EEEvPK13__nv_bfloat16" for d in
                (16, 32)]
             + ["13fa_fma_kernelI13__nv_bfloat16Li8ELi8EEEvPKT_",
                "13fa_fma_kernelI13__nv_bfloat16Li40ELi40EEEvPKT_",
                "13fa_fma_kernelI13__nv_bfloat16Li24ELi16EEEvPKT_"]
             + [f"13fa_fma_kernelIfLi{d}ELi{dv}EEEvPKT_" for d, dv in
                flash_attn.PAIRS])
    return "".join(_entry(prefix + n, spills.get(n, 0)) for n in names
                   if n not in skip)


class _Lib:
    def __init__(self, wgmma_smem, fma_smem):
        self.flash_attn_wgmma_smem = lambda d, dv: wgmma_smem.get((d, dv),
                                                                  0)
        self.flash_attn_fma_smem = lambda d, dv: fma_smem.get((d, dv), 0)


class _Build:
    def __init__(self, log, lib):
        self.log, self.lib = log, lib

    def compiler_log(self, name):
        assert name == "flash_attn"
        return self.log

    def load(self, name, signatures):
        assert name == "flash_attn" and "flash_attn_fma_smem" in signatures
        return self.lib


def test_fa_resources_names_every_wgmma_width_and_fma_width():
    smoke = _chip_smoke()
    res = smoke.fa_resources(_Build(_log(), _Lib(WGMMA_SMEM, FMA_SMEM)),
                             flash_attn)
    assert set(res) == ({_name("fa_wgmma_kernel", *p) for p in WGMMA_SMEM}
                        | {_name("fa_fma_kernel", *p)
                           for p in flash_attn.PAIRS})
    assert res["fa_wgmma_kernel d192"]["dynamic_smem_bytes"] == 197632
    assert res["fa_wgmma_kernel d192 dv128"]["dynamic_smem_bytes"] == 214016
    assert res["fa_fma_kernel d80"] == {
        "stack_bytes": 0, "spill_store_bytes": 0, "spill_load_bytes": 0,
        "registers": 168, "barriers": 1, "static_smem_bytes": 80,
        "dynamic_smem_bytes": FMA_SMEM[(80, 80)]}
    assert res["fa_fma_kernel d24 dv16"]["dynamic_smem_bytes"] \
        == FMA_SMEM[(24, 16)]


@pytest.mark.parametrize("kernel", [
    "15fa_wgmma_kernelILi192ELi192EEEv14CUtensorMap_st",
    "15fa_wgmma_kernelILi192ELi128EEEv14CUtensorMap_st",
    "13fa_fma_kernelIfLi80ELi80EEEvPKT_",
    "13fa_fma_kernelIfLi24ELi16EEEvPKT_",
    "13fa_fma_kernelI13__nv_bfloat16Li8ELi8EEEvPKT_",
    "13fa_fma_kernelI13__nv_bfloat16Li40ELi40EEEvPKT_",
    "13fa_fma_kernelI13__nv_bfloat16Li24ELi16EEEvPKT_"])
def test_fa_resources_fails_a_spill(kernel):
    """A spill in any instantiation of the two kernels fails the run, the
    bf16 FMA kernel at D 8, 40 and (24, 16) included (it has no row of its
    own)."""
    smoke = _chip_smoke()
    build = _Build(_log({kernel: 16}), _Lib(WGMMA_SMEM, FMA_SMEM))
    with pytest.raises(AssertionError, match="spill"):
        smoke.fa_resources(build, flash_attn)


def test_fa_resources_ignores_the_mma_kernel_and_fails_a_missing_one():
    smoke = _chip_smoke()
    mma = "13fa_mma_kernelILi16EEEvPK13__nv_bfloat16"
    smoke.fa_resources(_Build(_log({mma: 8}), _Lib(WGMMA_SMEM, FMA_SMEM)),
                       flash_attn)
    gone = _log(skip=("15fa_wgmma_kernelILi80ELi80EEEv14CUtensorMap_st",))
    with pytest.raises(AssertionError):
        smoke.fa_resources(_Build(gone, _Lib(WGMMA_SMEM, FMA_SMEM)),
                           flash_attn)


def test_fa_resources_fails_shared_memory_past_a_blocks_limit():
    """A ring of two 128-row stages at D 192 (240 KB) would not fit the
    227 KB a block may have."""
    smoke = _chip_smoke()
    too_big = {**WGMMA_SMEM, (192, 192): 128 * 192 * 2 * 5 + 1024}
    with pytest.raises(AssertionError, match="shared"):
        smoke.fa_resources(_Build(_log(), _Lib(too_big, FMA_SMEM)),
                           flash_attn)


@pytest.mark.parametrize("s,t", [(1, 1), (7, 7), (5, 9), (9, 5), (64, 200)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dv", [None, 80, 48])
def test_attention_work_counts_the_pairs_the_mask_keeps(s, t, causal, dv):
    """QK^T and PV: 2 (D + Dv) operations a kept pair; q and k of width
    D, v and the output of Dv."""
    kept = torch.ones(s, t, dtype=torch.bool)
    if causal:
        kept = torch.arange(s)[:, None] >= torch.arange(t)[None, :]
    b, h, hk, d = 2, 6, 2, 80
    bytes_moved, flops = timing.attention_work(b, h, hk, s, t, d, causal, 2,
                                               dv=dv)
    w = d if dv is None else dv
    assert flops == 2.0 * b * h * (d + w) * kept.sum().item()
    assert bytes_moved == 2 * (b * h * s * (d + w) + b * hk * t * (d + w))


@pytest.mark.parametrize("n", [16, 64, 4 ** 8])
def test_fft_stage_work_reads_the_stage_twiddles(n):
    rows = 3
    wr, wi = ops._stage_twiddles(n, 0, torch.device("cpu"))
    bytes_moved, flops = timing.fft_stage_work(rows, n)
    assert bytes_moved == 4 * rows * n * 4 + (wr.numel() + wi.numel()) * 4
    assert flops == rows * (n // 4) * 34.0


# Every (lanes, n) csrc/ssm_scan.cu instantiates, and its dynamic shared
# memory: three stages of 16 steps of dt and x (128 / lanes channels)
# and of B and C (n each).
SCAN_PAIRS = [(lanes, n) for n in ssm_scan.STATES
              for lanes in ssm_scan.lane_counts(n)]
SCAN_SMEM = {(lanes, n): 3 * 4 * (2 * 16 * (128 // lanes) + 2 * 16 * n)
             for lanes, n in SCAN_PAIRS}


def _scan_name(lanes, n):
    return (f"15ssm_scan_kernelILi{lanes}ELi{n}EEEvPKfS2_S2_S2_S2_S2_S2_"
            f"PfS3_iii")


def _scan_log(spills=None, skip=()) -> str:
    """A ptxas log of ``csrc/ssm_scan.cu``'s instantiations."""
    spills = spills or {}
    prefix = "_ZN44_GLOBAL__N__b4ec31e4_11_ssm_scan_cu_5890e9f0"
    names = [_scan_name(lanes, n) for lanes, n in SCAN_PAIRS]
    return "".join(_entry(prefix + n, spills.get(n, 0), regs=78)
                   for n in names if n not in skip)


class _ScanLib:
    def ssm_scan_smem(self, lanes, n):
        return SCAN_SMEM.get((lanes, n), 0)


class _ScanBuild:
    def __init__(self, log):
        self.log = log

    def compiler_log(self, name):
        assert name == "ssm_scan"
        return self.log

    def load(self, name, signatures):
        assert name == "ssm_scan" and "ssm_scan_smem" in signatures
        return _ScanLib()


def test_scan_resources_names_every_state_width():
    """Every lane count at every state width: n 8 at 1, 2 and 4 lanes, n
    16 also at 8 (2 states a lane or more)."""
    smoke = _chip_smoke()
    res = smoke.scan_resources(_ScanBuild(_scan_log()), ssm_scan)
    assert set(res) == {f"ssm_scan_kernel l{lanes} n{n}"
                        for lanes, n in SCAN_PAIRS}
    assert sorted(SCAN_PAIRS) == [(1, 8), (1, 16), (2, 8), (2, 16), (4, 8),
                                  (4, 16), (8, 16)]
    assert res["ssm_scan_kernel l2 n16"]["registers"] == 78
    assert res["ssm_scan_kernel l4 n8"]["spill_store_bytes"] == 0
    assert res["ssm_scan_kernel l2 n16"]["dynamic_smem_bytes"] == 30720


@pytest.mark.parametrize("n", [8, 16])
def test_scan_resources_fails_a_spill_or_a_missing_width(n):
    smoke = _chip_smoke()
    for lanes in ssm_scan.lane_counts(n):
        name = _scan_name(lanes, n)
        with pytest.raises(AssertionError, match="spill"):
            smoke.scan_resources(_ScanBuild(_scan_log({name: 8})),
                                 ssm_scan)
        with pytest.raises(AssertionError, match="spill"):
            smoke.scan_resources(_ScanBuild(_scan_log(skip=(name,))),
                                 ssm_scan)


def test_scan_resources_fails_a_pair_the_library_lacks(monkeypatch):
    """A (lanes, n) that ptxas compiled but the library reports no shared
    memory for (its dispatch lacks it) fails the run too."""
    smoke = _chip_smoke()
    monkeypatch.setitem(SCAN_SMEM, (8, 16), 0)
    with pytest.raises(AssertionError, match="spill"):
        smoke.scan_resources(_ScanBuild(_scan_log()), ssm_scan)


@pytest.mark.parametrize("s,t,causal,window", [
    (2048, 2048, True, 1024), (2048, 2048, True, 1), (1100, 1100, False, 64),
    (300, 200, True, 0), (200, 300, False, 0), (64, 64, True, 100)])
def test_attention_work_counts_the_pairs_a_window_keeps(s, t, causal, window):
    """Under a sliding window the bound's operations count each (query,
    key) pair the mask keeps, against the mask itself."""
    lag = (torch.arange(s)[:, None] - torch.arange(t)[None, :])
    keep = torch.ones(s, t, dtype=torch.bool)
    if causal:
        keep &= lag >= 0
    if window:
        keep &= lag < window
    byts, ops_ = timing.attention_work(2, 4, 2, s, t, 64, causal, 2,
                                       window=window)
    assert ops_ == 2.0 * 2 * 4 * 128 * keep.sum().item()
    assert byts == 2 * (2 * 4 * s * 128 + 2 * 2 * t * 128)


def test_scan_bound_counts_its_bytes_and_exponentials():
    """Falcon-Mamba-7B's prefill scan: 0.81 GB and 1.07e9 exponentials,
    bound by the MUFU at 16 a clock an SM."""
    byts, exps = timing.scan_work(4, 2048, 8192, 16)
    assert exps == 4 * 2048 * 8192 * 16
    assert byts == 4 * (3 * 4 * 2048 * 8192 + 2 * 4 * 2048 * 16
                        + 8192 * 16 + 8192 + 2 * 4 * 8192 * 16)
    b = timing.scan_bound(4, 2048, 8192, 16)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == exps / timing.MUFU_S * 1e3


# The backward kernels of csrc/flash_attn_bwd.cu that a (D, Dv) pair
# launches: the wgmma pair (templated on D and Dv) in bf16 at the pairs of
# flash_attn_bwd.WGMMA_DIMS, (192, 128) among them, the mma.sync pair
# (templated likewise) at the other pairs of multiples of 16, the FMA pair
# (templated likewise) in float32 at every pair and in bf16 at D 8 and 40
# and at (24, 16); and the wgmma kernels' dynamic shared memory at (64,
# 64), (128, 128) and (192, 128) (which 0: dK/dV, 1: dQ), from the
# source's constants.
BWD_SMEM = {(d, dv, which): wgmma_smem(d, dv)[which]
            for d, dv in ((64, 64), (128, 128), (192, 128)) for which in (0, 1)}


def _bwd_names():
    """The mangled names (less the namespace prefix) of the backward
    kernels that csrc/flash_attn_bwd.cu instantiates."""
    names = []
    for d, dv in flash_attn.PAIRS:
        for kernel in ("bwd_dkdv", "bwd_dq"):
            wg, mma, fma = (f"{kernel}_{k}" for k in ("wgmma", "mma", "fma"))
            if (d, dv) in flash_attn_bwd.WGMMA_DIMS:
                names.append(f"{len(wg)}{wg}ILi{d}ELi{dv}EEEv14CUtensorMap"
                             f"_st")
            elif d % 16 == 0 and dv % 16 == 0:
                names.append(f"{len(mma)}{mma}ILi{d}ELi{dv}EEEvPK13"
                             f"__nv_bfloat16")
            else:
                names.append(f"{len(fma)}{fma}I13__nv_bfloat16Li{d}ELi{dv}"
                             f"EEEvPKT_")
            names.append(f"{len(fma)}{fma}IfLi{d}ELi{dv}EEEvPKT_")
    return names


def _bwd_log(spills=None, skip=()) -> str:
    spills = spills or {}
    prefix = "_ZN50_GLOBAL__N__54cd42d8_17_flash_attn_bwd_cu_e61ae919"
    return "".join(_entry(prefix + n, spills.get(n, 0)) for n in _bwd_names()
                   if not any(k in n for k in skip))


class _BwdBuild:
    def __init__(self, log, smem=None):
        self.log, self.smem = log, smem or BWD_SMEM

    def compiler_log(self, name):
        assert name == "flash_attn_bwd"
        return self.log

    def load(self, name, signatures):
        assert name == "flash_attn_bwd"
        assert "flash_attn_bwd_wgmma_smem" in signatures
        smem = self.smem
        return type("Lib", (), {"flash_attn_bwd_wgmma_smem": staticmethod(
            lambda d, dv, which: smem.get((d, dv, which), 0))})


def _wgmma(kernel, d):
    """The wgmma kernel's mangled name at D (or the pair (D, Dv))."""
    d, dv = d if isinstance(d, tuple) else (d, d)
    return next(n for n in _bwd_names()
                if f"{kernel}_wgmmaILi{d}ELi{dv}E" in n)


def test_bwd_resources_reads_every_launched_kernel():
    """The six wgmma kernels (DeepSeek-V3's (192, 128) among them) with
    their shared memory, the mma.sync pair only at the pairs that still
    launch it, the FMA pair at every pair in float32 and in bf16 at D 8
    and 40 and at (24, 16)."""
    smoke = _chip_smoke()
    res = smoke.bwd_resources(_BwdBuild(_bwd_log()), flash_attn,
                              flash_attn_bwd)
    assert {n for n in res if "wgmma" in n} == {
        f"{k}_wgmma {t}" for k in ("bwd_dkdv", "bwd_dq")
        for t in ("d64", "d128", "d192 dv128")}
    assert {n for n in res if "_mma" in n} == {
        f"{k}_mma d{d}" for k in ("bwd_dkdv", "bwd_dq")
        for d in (16, 32, 80, 192)}
    assert {n for n in res if "_fma bf16" in n} == {
        f"{k}_fma bf16 {t}" for k in ("bwd_dkdv", "bwd_dq")
        for t in ("d8", "d40", "d24 dv16")}
    assert len([n for n in res if "_fma f32" in n]) == 2 * len(
        flash_attn.PAIRS)
    assert res["bwd_dkdv_wgmma d128"]["dynamic_smem_bytes"] == 133632
    assert res["bwd_dq_wgmma d64"]["dynamic_smem_bytes"] == 82944
    assert res["bwd_dkdv_wgmma d64"]["dynamic_smem_bytes"] == 68096
    assert res["bwd_dkdv_wgmma d192 dv128"]["dynamic_smem_bytes"] == 231424
    assert res["bwd_dq_wgmma d192 dv128"]["dynamic_smem_bytes"] == 205824
    assert all(u.get("registers") for u in res.values())


@pytest.mark.parametrize("kernel,d", [
    ("bwd_dkdv", 64), ("bwd_dkdv", 128), ("bwd_dq", 64), ("bwd_dq", 128),
    pytest.param("bwd_dkdv", (192, 128), id="bwd_dkdv-192-128"),
    pytest.param("bwd_dq", (192, 128), id="bwd_dq-192-128")])
def test_bwd_resources_fails_a_wgmma_spill(kernel, d):
    """A spill in any wgmma kernel fails the run, DeepSeek-V3's (192, 128)
    pair's included."""
    smoke = _chip_smoke()
    build = _BwdBuild(_bwd_log({_wgmma(kernel, d): 8}))
    with pytest.raises(AssertionError, match="spill"):
        smoke.bwd_resources(build, flash_attn, flash_attn_bwd)


def test_bwd_resources_records_the_older_kernels_spills():
    """A spill in the mma.sync or (D, D) FMA kernels costs time, not
    correctness: recorded, the run goes on."""
    smoke = _chip_smoke()
    dq192 = next(n for n in _bwd_names() if "bwd_dq_mmaILi192ELi192E" in n)
    res = smoke.bwd_resources(_BwdBuild(_bwd_log({dq192: 8})), flash_attn,
                              flash_attn_bwd)
    assert res["bwd_dq_mma d192"]["spill_store_bytes"] == 8


@pytest.mark.parametrize("fragment,name", [
    ("bwd_dq_mmaILi80ELi80E", "bwd_dq_mma d80"),
    ("bwd_dkdv_fmaIfLi40ELi40E", "bwd_dkdv_fma f32 d40"),
    ("bwd_dq_fmaI13__nv_bfloat16Li8ELi8E", "bwd_dq_fma bf16 d8")])
def test_bwd_resources_records_the_mma_pairs_spills(fragment, name):
    """A spill of the mma.sync kernels that still launch (hubert-xlarge's
    D 80) is recorded, as are the (D, D) FMA kernels'."""
    smoke = _chip_smoke()
    mangled = next(n for n in _bwd_names() if fragment in n)
    res = smoke.bwd_resources(_BwdBuild(_bwd_log({mangled: 16})),
                              flash_attn, flash_attn_bwd)
    assert res[name]["spill_store_bytes"] == 16


@pytest.mark.parametrize("fragment", [
    "bwd_dkdv_fmaIfLi192ELi128E", "bwd_dq_fmaIfLi24ELi16E",
    "bwd_dkdv_fmaI13__nv_bfloat16Li24ELi16E"])
def test_bwd_resources_fails_a_spill_of_a_pairs_fma_kernel(fragment):
    """The FMA kernels at MLA's pairs spill nothing on the card; a spill
    there fails the run, as one in a wgmma kernel does."""
    smoke = _chip_smoke()
    mangled = next(n for n in _bwd_names() if fragment in n)
    with pytest.raises(AssertionError, match="spill"):
        smoke.bwd_resources(_BwdBuild(_bwd_log({mangled: 8})), flash_attn,
                            flash_attn_bwd)


@pytest.mark.parametrize("shape,bytes_,ops_", [
    ((1, 32, 8, 2048, 128, 128), 84148224.0, 85941288960.0),
    ((1, 128, 128, 2048, 192, 128), 672137216.0, 446894702592.0)])
def test_attention_bwd_work_counts_five_products(shape, bytes_, ops_):
    """The backward's bound: q, k, v, out, dO read and dq, dk, dv written
    once in bf16, lse read once; 2 (3 D + 2 Dv) operations a kept pair a
    head.  DeepSeek-V3's training attention: 4.47e11 operations, 0.452 ms
    at the bf16 tensor rate."""
    b, h, hk, s, d, dv = shape
    assert timing.attention_bwd_work(b, h, hk, s, s, d, True, 2, dv=dv) \
        == (bytes_, ops_)
    pairs = s * (s + 1) / 2
    assert ops_ == 2.0 * b * h * (3 * d + 2 * dv) * pairs
    if d == 192:
        assert abs(timing.bound(bytes_, ops_, "bfloat16")[0] - 0.4519) \
            < 1e-4


def test_bwd_resources_fails_a_missing_wgmma_kernel_or_too_much_smem():
    smoke = _chip_smoke()
    with pytest.raises(AssertionError):
        smoke.bwd_resources(_BwdBuild(_bwd_log(skip=("bwd_dq_wgmmaILi64E",))),
                            flash_attn, flash_attn_bwd)
    too_big = {**BWD_SMEM, (128, 128, 0): 232448}
    with pytest.raises(AssertionError, match="shared"):
        smoke.bwd_resources(_BwdBuild(_bwd_log(), too_big), flash_attn,
                            flash_attn_bwd)
