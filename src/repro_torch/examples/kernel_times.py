"""Device and eager times of the ``matmul``, ``axpy``, ``dct``,
``fft4_stage``, ``powf``, ``flash_attention`` and ``ssm_scan`` kernels
and the dot product's tree kernels, each beside one PyTorch call
for the same function in the same mode (where there is one) and the
least time the card could take.

    python src/repro_torch/examples/kernel_times.py [--src DIR] [--label L]
        [--only PART,...]

``--src`` puts another checkout's ``src`` first on the import path, so
that one run on one card can time two versions of the kernels in turns
(for example a parent commit unpacked under ``build/``).  Prints one JSON
line per measurement:

* ``matmul`` at the 5G beamforming shape (32, 64, 57344), float32 and
  bf16, against ``torch.matmul`` with TF32 off (output in the input
  dtype);
* ``axpy`` over 64 Mi elements, float32 and bf16, against
  ``torch.add(y, x, alpha=a)``;
* the 5G slot's device work (``ops.fft4`` over (896, 4096), then two
  ``ops.matmul`` (32, 64) @ (64, 57344)) on resident float32 inputs, in
  device time and eagerly, beside the bound of its bytes;
* ``dct`` at (2, 4096), (64, 4096), (256, 4096) and (4096, 4096), float32,
  against ``torch.matmul`` with TF32 off;
* ``combine_partials`` (one tree level, 2048 -> 64) against
  ``view(-1, 32).sum(1)``; ``combine_tree`` (every level, 2048 -> 1 at
  radix 2 and 32) where the version has it, against ``sum()``;
* ``ops.dotp`` over 64 Mi float32 elements at radix 0, 2 and 32 against
  ``torch.dot``;
* ``fft4_stage`` where a path still launches it: the lead stage of
  ``ops.fft4`` over (64, 65536), and the whole ``ops.fft4`` there (that
  stage, then one fused launch), each against ``torch.fft.fft`` and the
  digit-reversal gather over the same rows;
* ``powf`` at the straggler model's 8192 bases and at 2^24, against
  ``torch.pow`` (which rounds otherwise), with its bound: the larger of
  its bytes and, where the version has ``powf.fp64_work``, its FP64-pipe
  instructions and 64-bit conversions read from the built library;
* ``flash_attention`` at Qwen3-4B's serving prefill (bf16, (4, 32 heads
  reading 8, 2048, 128), causal), at the full-width attention of
  nemotron-4-340b (bf16, (1, 96 heads reading 8, 1024, 192), causal) and
  hubert-xlarge
  ((2, 16, 1024, 80), bidirectional, bf16 and float32), against
  ``F.scaled_dot_product_attention(enable_gqa=True)``;
* the ``mla`` part: ``flash_attention`` at DeepSeek-V3's prefill
  attention ((D, Dv) = (192, 128), (4, 128, 2048), causal, bf16) and at
  its smoke config's ((24, 16), (2, 4, 64), bf16 and float32), against
  the same SDPA call (the scale D ** -0.5 on both sides, MLA's);
* the ``scan`` part: ``ssm_scan`` at Falcon-Mamba-7B's and Hymba-1.5B's
  prefill scans (B, S, d_inner, n) = (4, 2048, 8192, 16) and (4, 2048,
  3200, 16), beside ``timing.scan_bound`` (no PyTorch call computes the
  scan): this tree's kernel at its planned lane count and at every lane
  count it instantiates, and the card's SM clock and power while it runs; with ``--src``, the other checkout's kernel and
  this tree's in turns (other, this, this, other) on the same inputs,
  and the other's lane counts too where it has them.

``ms``/``library_ms`` are device time (a CUDA graph of 20 calls cycling
through copies that together exceed twice the 50 MB L2, timed as one
replay); ``eager_ms``/``library_eager_ms`` the same calls issued one by
one from Python, the host's launch cost included.  Bounds use the H100
SXM data sheet: 3.35 TB/s, 67 TFLOP/s float32 and 989 TFLOP/s bf16
(``powf``'s FP64 rates: ``timing.fp64_bound``).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
DCT_SHAPES = ((2, 4096), (64, 4096), (256, 4096), (4096, 4096))
MM_SHAPE = (32, 64, 57344)
SLOT_ROWS = (896, 4096)   # 64 antennas x 14 symbols, 4096 sub-carriers
AXPY_N = 1 << 26
FFT_LONG = (64, 4 ** 8)   # rows above the fused kernel's 16384 points
# powf: the straggler model's bases a call at (8, 1024), and a large block.
POWF_SIZES = (8192, 1 << 24)
# (config, (B, H, Hk, S, D), causal, dtype): Qwen3-4B's serving prefill
# and the configs' full-width attention at head widths 192 and 80.
ATTN_SHAPES = (("qwen3-4b", (4, 32, 8, 2048, 128), True, "bfloat16"),
               ("nemotron-4-340b", (1, 96, 8, 1024, 192), True, "bfloat16"),
               ("hubert-xlarge", (2, 16, 16, 1024, 80), False, "bfloat16"),
               ("hubert-xlarge", (2, 16, 16, 1024, 80), False, "float32"))
# (B, H, Hk, S, D, Dv): a value width of its own (multi-head latent
# attention).
MLA_SHAPES = (("deepseek-v3-671b", (4, 128, 128, 2048, 192, 128), True,
               "bfloat16"),
              ("deepseek-v3-671b smoke", (2, 4, 4, 64, 24, 16), True,
               "bfloat16"),
              ("deepseek-v3-671b smoke", (2, 4, 4, 64, 24, 16), True,
               "float32"))
# (config, (B, S, d_inner, n)): the SSM and hybrid prefill scans.
SCAN_SHAPES = (("falcon-mamba-7b", (4, 2048, 8192, 16)),
               ("hymba-1.5b", (4, 2048, 3200, 16)))


def own_timing():
    """This checkout's :mod:`repro_torch.timing`, loaded by its path, so
    that ``--src`` changes the kernels timed and not the clock."""
    path = Path(__file__).resolve().parents[1] / "timing.py"
    spec = importlib.util.spec_from_file_location("kernel_times_timing",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def own_scan():
    """This checkout's ``kernels/ssm_scan.py`` (and the ``_build`` it
    imports, which builds into this checkout's ``build/``), loaded by
    path as a package of its own, so that ``--src`` can time another
    checkout's scan in turns with this one in one process."""
    name = "kernel_times_own_kernels"
    if name not in sys.modules:
        pkg = types.ModuleType(name)
        pkg.__path__ = [str(Path(__file__).resolve().parents[1] / "kernels")]
        sys.modules[name] = pkg
    return importlib.import_module(f"{name}.ssm_scan")


def clocks_during(torch, fn, inputs, seconds: float = 2.0) -> dict:
    """The card's SM clock (MHz) and power draw (W), medians of what
    ``nvidia-smi`` reads every 50 ms while ``fn`` runs back to back over
    ``inputs`` for ``seconds``."""
    for args in inputs:
        fn(*args)
    torch.cuda.synchronize()
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "50"],
        stdout=subprocess.PIPE, text=True)
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        for args in inputs:
            fn(*args)
        torch.cuda.synchronize()
    smi.terminate()
    rows = [line.split(",") for line in smi.communicate()[0].splitlines()
            if line.count(",") == 1]
    return {"sm_clock_mhz": statistics.median(float(r[0]) for r in rows),
            "power_w": statistics.median(float(r[1]) for r in rows),
            "clock_samples": len(rows)}


def time_matmul(torch, timing, kernels, emit, gen) -> None:
    m, k, n = MM_SHAPE
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        x = torch.randn(m, k, device=gen.device, generator=gen).to(dtype)
        w = torch.randn(k, n, device=gen.device, generator=gen).to(dtype)
        b, by = timing.bound(*timing.matmul_work(m, k, n, x.element_size()),
                             name)
        # A stream of the same bytes: torch.add of two (m, n) operands in
        # x's dtype into a float32 (m, n) output reads and writes what the
        # product does, less x.
        u, v = (torch.randn(m, n, device=gen.device, generator=gen).to(dtype)
                for _ in range(2))
        stream = torch.empty(m, n, device=gen.device)
        emit({"name": "matmul", "shape": [m, k, n], "dtype": name,
              "max_abs_diff_vs_library": (kernels.matmul.matmul(x, w)
                                          - torch.matmul(x, w).float()
                                          ).abs().max().item(),
              **timing.in_turns(kernels.matmul.matmul, torch.matmul,
                                timing.cold_copies(x, w)),
              "library": "torch.matmul, TF32 off", "bound_ms": b,
              "bound_by": by,
              "same_bytes_add_ms": timing.graph_ms(
                  lambda a, c: torch.add(a, c, out=stream),
                  timing.cold_copies(u, v))})


def time_axpy(torch, timing, kernels, emit, gen) -> None:
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        x = torch.randn(AXPY_N, device=gen.device, generator=gen).to(dtype)
        y = torch.randn(AXPY_N, device=gen.device, generator=gen).to(dtype)
        b, by = timing.bound(3.0 * AXPY_N * x.element_size(), 2.0 * AXPY_N,
                             name)
        emit({"name": "axpy", "n": AXPY_N, "dtype": name,
              **timing.in_turns(kernels.axpy.axpy,
                                lambda a, u, v: torch.add(v, u, alpha=a),
                                [(1.7,) + xy for xy in
                                 timing.cold_copies(x, y)]),
              "library": "torch.add(y, x, alpha=a)", "bound_ms": b,
              "bound_by": by})


def time_slot(torch, timing, kernels, emit, gen) -> None:
    (rows, n_sc), (n_beams, n_rx) = SLOT_ROWS, MM_SHAPE[:2]
    planes = [torch.randn(rows, n_sc, device=gen.device, generator=gen)
              for _ in range(2)]
    coef = torch.randn(n_beams, n_rx, device=gen.device, generator=gen)
    mm = kernels.matmul.matmul

    def slot(re, im, c):
        fr, fi = kernels.ops.fft4(re, im)
        return mm(c, fr.reshape(n_rx, -1)), mm(c, fi.reshape(n_rx, -1))

    b, by = timing.bound(*timing.slot_work(rows, n_sc, n_beams, n_rx),
                         "float32")
    args = timing.cold_copies(*planes, coef)
    emit({"name": "fiveg slot", "rows": [rows, n_sc], "beams": n_beams,
          "ms": timing.graph_ms(slot, args),
          "eager_ms": timing.cuda_ms(slot, args), "bound_ms": b,
          "bound_by": by})


def time_dct(torch, timing, kernels, emit, gen) -> None:
    dct = kernels.dct
    for t, n in DCT_SHAPES:
        x = torch.randn(t, n, device=gen.device, generator=gen)
        bt = kernels.ops.dct_basis_t(n, gen.device)
        got, lib = dct.dct(x, bt), torch.matmul(x, bt)
        b, by = timing.bound(4.0 * (2 * t * n + n * n), 2.0 * t * n * n,
                             "float32")
        emit({"name": "dct", "shape": [t, n],
              "max_abs_diff_vs_library": (got - lib).abs().max().item(),
              **timing.in_turns(dct.dct, torch.matmul,
                                timing.cold_copies(x, bt)),
              "library": "torch.matmul, TF32 off",
              "bound_ms": b, "bound_by": by})


def time_dotp(torch, timing, kernels, emit, gen) -> None:
    dotp, ops = kernels.dotp, kernels.ops
    x = torch.randn(1 << 26, device=gen.device, generator=gen)
    y = torch.randn(1 << 26, device=gen.device, generator=gen)
    parts = dotp.dotp_partials(x, y)
    pcopies = timing.cold_copies(parts)
    b, by = timing.bound(4.0 * (parts.numel() + parts.numel() // 32),
                         parts.numel(), "float32")
    emit({"name": "combine_partials", "n": parts.numel(), "radix": 32,
          **timing.in_turns(lambda p: dotp.combine_partials(p, 32),
                            lambda p: p.view(-1, 32).sum(dim=1), pcopies),
          "library": "view(-1, 32).sum(dim=1)", "bound_ms": b,
          "bound_by": by})
    if hasattr(dotp, "combine_tree"):
        for r in (2, 32):
            b, by = timing.bound(4.0 * (parts.numel() + 1), parts.numel(),
                                 "float32")
            emit({"name": "combine_tree", "n": parts.numel(), "radix": r,
                  "levels": ops.dotp_levels(x.numel(), r),
                  **timing.in_turns(lambda p, r=r: dotp.combine_tree(p, r),
                                    lambda p: p.sum(), pcopies),
                  "library": "sum()", "bound_ms": b, "bound_by": by})
    xy = timing.cold_copies(x, y)
    b, by = timing.bound(8.0 * x.numel(), 2.0 * x.numel(), "float32")
    for r in (0, 2, 32):
        emit({"name": "ops.dotp", "n": x.numel(), "radix": r,
              "levels": ops.dotp_levels(x.numel(), r),
              **timing.in_turns(lambda u, v, r=r: ops.dotp(u, v, radix=r),
                                torch.dot, xy),
              "library": "torch.dot", "bound_ms": b, "bound_by": by})


def time_fft_long(torch, timing, kernels, emit, gen) -> None:
    fft4, ops = kernels.fft4, kernels.ops
    rows, n = FFT_LONG
    re, im = (torch.randn(rows, n, device=gen.device, generator=gen)
              for _ in range(2))
    lead = fft4.fft4_plan(n)[0]
    wr, wi = ops._stage_twiddles(n, 0, gen.device)
    idx = kernels.ref.digit_reverse_indices(n, device=gen.device)

    def stage(x_re, x_im):
        return fft4.fft4_stage(x_re, x_im, wr, wi)

    def library(x_re, x_im):
        y = torch.fft.fft(torch.complex(x_re, x_im))[:, idx]
        return y.real, y.imag

    args = timing.cold_copies(re, im)
    b, by = timing.bound(*timing.fft_stage_work(rows, n), "float32")
    emit({"name": "fft4_stage", "shape": [rows, n],
          "unit": f"stage 0 of {fft4.log4(n)}, the lead stage of ops.fft4 "
                  f"({lead} stage launch, then one fused launch)",
          **timing.in_turns(stage, library, args),
          "library": "torch.fft.fft + digit-reversal gather, the whole "
                     "transform", "bound_ms": b, "bound_by": by})
    b, by = timing.bound(*timing.fft_work(rows, n), "float32")
    emit({"name": "ops.fft4", "shape": [rows, n],
          **timing.in_turns(ops.fft4, library, args),
          "library": "torch.fft.fft + digit-reversal gather",
          "bound_ms": b, "bound_by": by})


def time_powf(torch, timing, kernels, emit, gen) -> None:
    powf = kernels.powf
    y = -1.0 / 1.5
    # Bases of the Pareto tail at 1024 PEs: c - u * d, u in [0, 0.99).
    c = ((1 << 18) / 1024 * 3.0) ** -1.5
    work = powf.fp64_work() if hasattr(powf, "fp64_work") else None
    for n in POWF_SIZES:
        x = c * (1.0 - 0.99 * torch.rand(n, device=gen.device,
                                         generator=gen))
        got = powf.powf(x, y).view(torch.int32).cpu()
        want = powf.powf_plain(x, y).view(torch.int32).cpu()
        rec = {"name": "powf", "n": n,
               "bases_off_c_library": int((got != want).sum().item()),
               **timing.in_turns(powf.powf, torch.pow,
                                 [(t, y) for (t,) in timing.cold_copies(x)]),
               "library": "torch.pow (not the C library's rounding)"}
        if work is None:
            b, by = timing.bound(8.0 * n, 0.0, "float32")
            rec.update(bound_ms=b, bound_by=by)
        else:
            rec.update(fp64_per_base=work[0], conversions_per_base=work[1],
                       **timing.fp64_bound(8.0 * n, work[0] * n,
                                           work[1] * n))
        emit(rec)


def time_attention(torch, timing, kernels, emit, gen,
                   shapes=ATTN_SHAPES) -> None:
    fa = kernels.flash_attn
    for config, (b, h, hk, s, d, *dv), causal, name in shapes:
        dv = dv[0] if dv else d
        dtype = getattr(torch, name)
        q = torch.randn(b, h, s, d, device=gen.device, generator=gen)
        k = torch.randn(b, hk, s, d, device=gen.device, generator=gen)
        v = torch.randn(b, hk, s, dv, device=gen.device, generator=gen)
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)

        def kernel(q_, k_, v_, c=causal):
            return fa.flash_attention(q_, k_, v_, causal=c)

        def library(q_, k_, v_, c=causal):
            return torch.nn.functional.scaled_dot_product_attention(
                q_, k_, v_, is_causal=c, enable_gqa=True)

        want = fa.flash_attention_plain(q, k, v, causal=causal)
        work = timing.attention_work(b, h, hk, s, s, d, causal,
                                     q.element_size(),
                                     **({"dv": dv} if dv != d else {}))
        bnd, by = timing.bound(*work, name)
        emit({"name": "flash_attention", "config": config,
              "shape": [b, h, hk, s, d] + ([dv] if dv != d else []),
              "dtype": name, "causal": causal,
              "max_abs_err_vs_plain": (kernel(q, k, v).float()
                                       - want.float()).abs().max().item(),
              **timing.in_turns(kernel, library,
                                timing.cold_copies(q, k, v)),
              "library": "F.scaled_dot_product_attention(enable_gqa=True)",
              "bound_ms": bnd, "bound_by": by})


def time_mla(torch, timing, kernels, emit, gen) -> None:
    time_attention(torch, timing, kernels, emit, gen, shapes=MLA_SHAPES)


def time_scan(torch, timing, kernels, emit, gen) -> None:
    scan, own = kernels.ssm_scan, own_scan()
    other = Path(scan.__file__).resolve() != Path(own.__file__).resolve()
    for config, (b, s, di, n) in SCAN_SHAPES:
        dt = torch.nn.functional.softplus(
            torch.randn(b, s, di, device=gen.device, generator=gen) - 2.0)
        x = torch.randn(b, s, di, device=gen.device, generator=gen)
        bm, cm = (torch.randn(b, s, n, device=gen.device, generator=gen)
                  for _ in range(2))
        a = -torch.arange(1, n + 1, device=gen.device,
                          dtype=torch.float32).expand(di, n).contiguous()
        d = torch.randn(di, device=gen.device, generator=gen)
        h0 = torch.randn(b, di, n, device=gen.device, generator=gen)
        args = (dt, x, bm, cm, a, d, h0)
        inputs = timing.cold_copies(*args)
        plan = own.scan_plan(b, di, n)
        base = {"name": "ssm_scan", "config": config, "shape": [b, s, di, n],
                "plan": {"lanes": plan.lanes, "channels": plan.channels,
                         "blocks": plan.blocks,
                         "warps_per_scheduler": plan.warps_per_scheduler},
                **timing.scan_bound(b, s, di, n)}
        if other:
            wy, wh = scan.ssm_scan(*args)
            y, h = own.ssm_scan(*args)
            g = [timing.graph_ms(f, inputs) for f in
                 (scan.ssm_scan, own.ssm_scan, own.ssm_scan, scan.ssm_scan)]
            emit(dict(base, timing="graph", ms=(g[1] + g[2]) / 2,
                      runs_ms=[g[1], g[2]], other_ms=(g[0] + g[3]) / 2,
                      other_runs_ms=[g[0], g[3]], other=str(scan.__file__),
                      eager_ms=timing.cuda_ms(own.ssm_scan, inputs),
                      other_eager_ms=timing.cuda_ms(scan.ssm_scan, inputs),
                      max_abs_diff_vs_other=max(
                          (y - wy).abs().max().item(),
                          (h - wh).abs().max().item()),
                      bound_share=base["bound_ms"] * 2 / (g[1] + g[2])))
            del y, h, wy, wh
        versions = [("this", own)] + ([("other", scan)] if other and hasattr(
            scan, "lane_counts") else [])
        for version, mod in versions:
            planned = mod.scan_plan(b, di, n).lanes
            for lanes in mod.lane_counts(n):
                def run(*t, mod=mod, lanes=lanes):
                    return mod.launch(*t, lanes)
                ms = timing.graph_ms(run, inputs)
                emit(dict(base, timing="graph", version=version, lanes=lanes,
                          planned=lanes == planned, ms=ms,
                          eager_ms=timing.cuda_ms(run, inputs),
                          warps_per_scheduler=mod.plan_for(
                              b, di, lanes).warps_per_scheduler,
                          bound_share=base["bound_ms"] / ms))
        clocks = clocks_during(torch, own.ssm_scan, inputs)
        emit(dict(base, timing="clocks", **clocks,
                  mufu_bound_ms_at_clock=base["mufu_bound_ms"] * 1980.0
                  / clocks["sm_clock_mhz"]))
        del args, inputs
        torch.cuda.empty_cache()


PARTS = {"matmul": time_matmul, "axpy": time_axpy, "slot": time_slot,
         "dct": time_dct, "dotp": time_dotp, "fft": time_fft_long,
         "powf": time_powf, "attention": time_attention, "mla": time_mla,
         "scan": time_scan}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--src", help="import repro_torch from DIR")
    parser.add_argument("--label", default="this tree")
    parser.add_argument("--only", default=",".join(PARTS),
                        help="comma-separated parts to time, of "
                             + ", ".join(PARTS))
    args = parser.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve() if args.src
                           else ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import (axpy, dct, dotp, fft4, flash_attn,
                                     matmul, ops, powf, ref, ssm_scan)
    kernels = types.SimpleNamespace(axpy=axpy, dct=dct, dotp=dotp, fft4=fft4,
                                    flash_attn=flash_attn, matmul=matmul,
                                    ops=ops, powf=powf, ref=ref,
                                    ssm_scan=ssm_scan)
    timing = own_timing()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=torch.device("cuda")).manual_seed(16)
    common = {"label": args.label, "package": dotp.__file__, "card": smi}

    def emit(rec):
        print(json.dumps(dict(common, **rec)), flush=True)

    for name in args.only.split(","):
        PARTS[name](torch, timing, kernels, emit, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
