"""Device and eager times of the ``matmul``, ``axpy``, ``dct``,
``fft4_stage``, ``powf``, ``flash_attention``, ``flash_attention_bwd``,
``ssm_scan`` and ``ssm_scan_bwd`` kernels and the dot product's tree
kernels, each beside
one PyTorch call for the same function in the same mode (where there is
one) and the least time the card could take.

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
  ((2, 16, 1024, 80), bidirectional, bf16 and float32), at D 64
  (Hymba-1.5B's heads without its window) and at Qwen3-4B's training
  forward ((1, 32 heads reading 8, 2048, 128), bf16, causal, writing the
  rows' log-sum-exp for the backward), against
  ``F.scaled_dot_product_attention(enable_gqa=True)`` (which writes no
  log-sum-exp);
* the ``mla`` part: ``flash_attention`` at DeepSeek-V3's prefill
  attention ((D, Dv) = (192, 128), (4, 128, 2048), causal, bf16) and at
  its smoke config's ((24, 16), (2, 4, 64), bf16 and float32), against
  the same SDPA call (the scale D ** -0.5 on both sides, MLA's);
* the ``window`` part: ``flash_attention`` at Hymba-1.5B's prefill
  attention ((4, 25 heads reading 5, 2048, 64), bf16, causal, window
  1024) against SDPA on an (S, S) boolean mask;
* each attention record beside its bound (``bound_ms``) and the MUFU's
  (``mufu_bound_ms``: one ex2 a kept pair at 16 a clock an SM), with the
  wgmma kernel's plan; with ``--src``, the other checkout's kernel and
  this tree's in turns (other, this, this, other) on the same inputs
  (``this_ms``, ``other_ms``) and whether they give the same bits;
* the ``scan`` part: ``ssm_scan`` at Falcon-Mamba-7B's and Hymba-1.5B's
  prefill scans (B, S, d_inner, n) = (4, 2048, 8192, 16) and (4, 2048,
  3200, 16), beside ``timing.scan_bound`` (no PyTorch call computes the
  scan): this tree's kernel at its planned lane count and at every lane
  count it instantiates, and the card's SM clock and power while it runs; with ``--src``, the other checkout's kernel and
  this tree's in turns (other, this, this, other) on the same inputs,
  and the other's lane counts too where it has them.
* the ``attention_bwd`` part: ``flash_attention_bwd`` at Qwen3-4B's
  training attention ((1, 32 heads reading 8, 2048, 128), bf16, causal),
  DeepSeek-V3's ((1, 128 heads, 2048, (D, Dv) = (192, 128)), MLA's
  scale) and Hymba-1.5B's under its window ((1, 25 heads reading 5,
  2048, 64), window 1024) in device time and eagerly, SDPA's backward
  alone (on the (S, S) boolean mask under the window) and this tree's
  kernels in turns, eagerly (kernel, SDPA, SDPA, kernel; SDPA's backend
  named), the plain version and the bound of the backward's five
  products; with ``--src``, the other checkout's kernels and this tree's
  in turns (a tree without the window says so) and whether dq, dk and dv
  equal the other's bit for bit (``same_bits_as_other``); each call's
  device time split into the pre-pass, dK/dV and dQ kernels (``split``,
  and ``other_split`` for the other checkout's) from ``torch.profiler``'s
  kernel names, with the pre-pass's share of its byte bound
  (``prepass_bound_share``).
* the ``scan_bwd`` part: ``ssm_scan_bwd`` at Falcon-Mamba-7B's and
  Hymba-1.5B's training micro-batches ((1, 2048, 8192, 16) and (1, 2048,
  3200, 16)) at every chunk length (``CHUNK_STEPS``; the planned one
  marked), in device time and eagerly, beside
  ``timing.scan_bwd_bound`` and the plain version (no PyTorch call
  computes the scan's gradient), and the forward kernel with and without
  its checkpoints in turns; with ``--src``, the other checkout's backward
  and this tree's at their own plans in turns, whether their bits agree,
  each call split into its kernels (pre-pass, walk, sums) from
  ``torch.profiler``, and the other checkout's forward in turns with this
  tree's (a tree without the backward says so).

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
# (config, (B, H, Hk, S, D), causal, dtype[, window, lse]): Qwen3-4B's
# serving prefill, the configs' full-width attention at head widths 192
# and 80, D 64 (Hymba-1.5B's heads without its window) and Qwen3-4B's
# training forward, which also writes the rows' log-sum-exp.
ATTN_SHAPES = (("qwen3-4b", (4, 32, 8, 2048, 128), True, "bfloat16"),
               ("nemotron-4-340b", (1, 96, 8, 1024, 192), True, "bfloat16"),
               ("hubert-xlarge", (2, 16, 16, 1024, 80), False, "bfloat16"),
               ("hubert-xlarge", (2, 16, 16, 1024, 80), False, "float32"),
               ("hymba-1.5b, no window", (4, 25, 5, 2048, 64), True,
                "bfloat16"),
               ("qwen3-4b training, lse", (1, 32, 8, 2048, 128), True,
                "bfloat16", 0, True))
# (B, H, Hk, S, D, Dv): a value width of its own (multi-head latent
# attention).
MLA_SHAPES = (("deepseek-v3-671b", (4, 128, 128, 2048, 192, 128), True,
               "bfloat16"),
              ("deepseek-v3-671b smoke", (2, 4, 4, 64, 24, 16), True,
               "bfloat16"),
              ("deepseek-v3-671b smoke", (2, 4, 4, 64, 24, 16), True,
               "float32"))
# (config, (B, H, Hk, S, D), causal, dtype, window): the hybrid family's
# prefill attention under its sliding window.
WINDOW_SHAPES = (("hymba-1.5b", (4, 25, 5, 2048, 64), True, "bfloat16",
                  1024),)
# (config, (B, S, d_inner, n)): the SSM and hybrid prefill scans.
SCAN_SHAPES = (("falcon-mamba-7b", (4, 2048, 8192, 16)),
               ("hymba-1.5b", (4, 2048, 3200, 16)))
# (config, (B, H, Hk, S, D[, Dv]), window): the training attention's
# backward, one micro-batch, bf16, causal.
BWD_SHAPES = (("qwen3-4b", (1, 32, 8, 2048, 128), 0),
              ("deepseek-v3-671b", (1, 128, 128, 2048, 192, 128), 0),
              ("hymba-1.5b", (1, 25, 5, 2048, 64), 1024))
# (config, (B, S, d_inner, n)): the SSM and hybrid training scans, one
# micro-batch.
SCAN_BWD_SHAPES = (("falcon-mamba-7b", (1, 2048, 8192, 16)),
                   ("hymba-1.5b", (1, 2048, 3200, 16)))


def own_timing():
    """This checkout's :mod:`repro_torch.timing`, loaded by its path, so
    that ``--src`` changes the kernels timed and not the clock."""
    path = Path(__file__).resolve().parents[1] / "timing.py"
    spec = importlib.util.spec_from_file_location("kernel_times_timing",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def own_kernel(name: str):
    """This checkout's ``kernels/<name>.py`` (and the ``_build`` it
    imports, which builds into this checkout's ``build/``), loaded by
    path under a package of its own standing for ``repro_torch``, so that
    ``--src`` can time another checkout's kernel in turns with this one
    in one process."""
    pkg_name = "kernel_times_own"
    if pkg_name not in sys.modules:
        pkg = types.ModuleType(pkg_name)
        pkg.__path__ = [str(Path(__file__).resolve().parents[1])]
        sys.modules[pkg_name] = pkg
    return importlib.import_module(f"{pkg_name}.kernels.{name}")


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
    """``flash_attention`` at ``shapes`` beside SDPA (on a boolean mask
    under a window) in turns, the bound and the MUFU's bound (one ex2 a
    kept pair); with ``--src``, the other checkout's kernel and this
    tree's in turns (other, this, this, other) on the same inputs, and
    whether the two give the same bits (out, and lse where a shape writes
    it)."""
    fa, own = kernels.flash_attn, own_kernel("flash_attn")
    other = Path(fa.__file__).resolve() != Path(own.__file__).resolve()
    for config, (b, h, hk, s, d, *dv), causal, name, *opts in shapes:
        dv = dv[0] if dv else d
        window, with_lse = (list(opts) + [0, False])[:2]
        dtype = getattr(torch, name)
        q = torch.randn(b, h, s, d, device=gen.device, generator=gen)
        k = torch.randn(b, hk, s, d, device=gen.device, generator=gen)
        v = torch.randn(b, hk, s, dv, device=gen.device, generator=gen)
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        lag = (torch.arange(s, device=gen.device)[:, None]
               - torch.arange(s, device=gen.device)[None, :])
        mask = ((lag >= 0) & (lag < window)) if window else None
        lse = (torch.empty(b, h, s, device=gen.device) if with_lse
               else None)

        def kernel(q_, k_, v_, c=causal, mod=own):
            return mod.flash_attention(q_, k_, v_, causal=c, window=window,
                                       lse=lse)

        def library(q_, k_, v_, c=causal):
            if mask is not None:
                return torch.nn.functional.scaled_dot_product_attention(
                    q_, k_, v_, attn_mask=mask, enable_gqa=True)
            return torch.nn.functional.scaled_dot_product_attention(
                q_, k_, v_, is_causal=c, enable_gqa=True)

        got = kernel(q, k, v)
        got_lse = None if lse is None else lse.clone()
        want = own.flash_attention_plain(q, k, v, causal=causal,
                                         window=window)
        work = timing.attention_work(b, h, hk, s, s, d, causal,
                                     q.element_size(), window=window,
                                     **({"dv": dv} if dv != d else {}))
        bnd, by = timing.bound(*work, name)
        inputs = timing.cold_copies(q, k, v)
        rec = {"name": "flash_attention", "config": config,
               "shape": [b, h, hk, s, d] + ([dv] if dv != d else []),
               "dtype": name, "causal": causal, "window": window,
               "lse": bool(with_lse),
               "max_abs_err_vs_plain": (got.float() - want.float()).abs()
               .max().item(),
               "deterministic": torch.equal(got, kernel(q, k, v))
               and (lse is None or torch.equal(got_lse, lse)),
               **timing.in_turns(kernel, library, inputs),
               "library": "F.scaled_dot_product_attention(enable_gqa=True"
                          + (", attn_mask=(S, S) bool)" if window else ")"),
               "bound_ms": bnd, "bound_by": by,
               "mufu_bound_ms": work[1] / (2.0 * (d + dv)) / timing.MUFU_S
               * 1e3}
        if own.WGMMA_TILES.get((d, dv)) and name == "bfloat16":
            plan = own.fwd_plan(b, h, s, s, d, dv, causal, window,
                                own.sm_count(torch.cuda.current_device()))
            rec["plan"] = {"rows": plan.rows, "keys": plan.keys,
                           "order": plan.order, "grid": plan.grid,
                           "rounds": plan.rounds}
        if other:
            def theirs(q_, k_, v_, c=causal):
                return fa.flash_attention(q_, k_, v_, causal=c, lse=lse,
                                          **({"window": window} if window
                                             else {}))
            g = [timing.graph_ms(f, inputs)
                 for f in (theirs, kernel, kernel, theirs)]
            rec.update(this_ms=(g[1] + g[2]) / 2, this_runs_ms=[g[1], g[2]],
                       other_ms=(g[0] + g[3]) / 2, other_runs_ms=[g[0], g[3]],
                       other=str(fa.__file__),
                       speedup_vs_other=(g[0] + g[3]) / (g[1] + g[2]),
                       same_bits_as_other=torch.equal(got, theirs(q, k, v))
                       and (lse is None or torch.equal(got_lse, lse)))
        rec["bound_share"] = bnd / rec["ms"]
        emit(rec)
        del q, k, v, got, want, inputs, lse, got_lse
        torch.cuda.empty_cache()


def time_mla(torch, timing, kernels, emit, gen) -> None:
    time_attention(torch, timing, kernels, emit, gen, shapes=MLA_SHAPES)


def time_window(torch, timing, kernels, emit, gen) -> None:
    time_attention(torch, timing, kernels, emit, gen, shapes=WINDOW_SHAPES)


def time_scan(torch, timing, kernels, emit, gen) -> None:
    scan, own = kernels.ssm_scan, own_kernel("ssm_scan")
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


# The backward's kernels by the fragment of their names that the
# profiler shows: the pre-pass, dK/dV and dQ.
BWD_KERNELS = (("prepass", "bwd_delta"), ("dkdv", "bwd_dkdv"),
               ("dq", "bwd_dq"))
# The scan's backward likewise: the chunks' pre-pass, the reverse walk
# and the partial sums.
SCAN_BWD_KERNELS = (("prepass", "scan_bwd_prepass"),
                    ("walk", "ssm_scan_bwd_kernel"), ("sums", "scan_bwd_sum"))


def bwd_split(torch, fn, inputs, parts=BWD_KERNELS) -> dict:
    """One call of ``fn`` (a backward) split into its kernels' device
    time (ms a call, from ``torch.profiler``'s kernel names: ``parts``,
    attention's by default) over one traced pass through ``inputs`` after
    a warm one; ``other_kernels_ms`` is whatever else the card ran.  Four
    one-element fills lead the traced pass: a later trace in one process
    drops its first kernels (seen on the H100: a second shape's split
    lacked its first kernel, and once its first two), and the fills are
    what it drops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for args in inputs:
        fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            torch.zeros(1, device="cuda")
        for args in inputs:
            fn(*args)
        torch.cuda.synchronize()
    split = {f"{part}_ms": 0.0 for part, _ in parts}
    split["other_kernels_ms"] = 0.0
    names = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        part = next((p for p, frag in parts if frag in e.key),
                    "other_kernels")
        split[f"{part}_ms"] += e.self_device_time_total / 1e3 / len(inputs)
        names[e.key[:80]] = e.count
    return dict(split, kernels_traced=names)


def time_attention_bwd(torch, timing, kernels, emit, gen) -> None:
    """The backward at the training attentions of :data:`BWD_SHAPES`
    (under the window where one has it):
    this tree's kernels (the pre-pass, dK/dV and dQ of one call) in device
    time and eagerly, with ``--src`` the other checkout's in turns (other,
    this, this, other); SDPA's backward alone (``autograd.grad`` through
    ``scaled_dot_product_attention(enable_gqa=True)``) and this tree's
    kernels in turns, eagerly (the backward cannot be captured in a
    graph: autograd runs it on the forward's stream); the plain version;
    the bound of the backward's five products; the errors against the
    plain version; the SM clock and power while it runs."""
    fa, bwd = own_kernel("flash_attn"), own_kernel("flash_attn_bwd")
    other = kernels.flash_attn_bwd
    if Path(other.__file__).resolve() == Path(bwd.__file__).resolve():
        other = None
    for config, (b, h, hk, s, d, *dv), window in BWD_SHAPES:
        dv = dv[0] if dv else d
        kw = dict(causal=True, window=window) if window else dict(causal=True)
        q = (0.5 * torch.randn(b, h, s, d, device=gen.device, generator=gen)
             ).bfloat16()
        k = (0.5 * torch.randn(b, hk, s, d, device=gen.device, generator=gen)
             ).bfloat16()
        v = torch.randn(b, hk, s, dv, device=gen.device, generator=gen
                        ).bfloat16()
        do = torch.randn(b, h, s, dv, device=gen.device, generator=gen
                         ).bfloat16()
        lse = torch.empty(b, h, s, device=gen.device)
        out = fa.flash_attention(q, k, v, lse=lse, **kw)
        inputs = timing.cold_copies(q, k, v, out, do, lse)

        def kernel(*a, mod=bwd, kw=kw):
            return mod.flash_attention_bwd(*a, **kw)

        def theirs_bwd(*a, kw=kw):
            return other.flash_attention_bwd(*a, **kw)

        got = kernel(q, k, v, out, do, lse)
        again = kernel(q, k, v, out, do, lse)
        want = bwd.flash_attention_bwd_plain(q, k, v, do, **kw)
        qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
        mask = None
        if window:
            lag = (torch.arange(s, device=q.device)[:, None]
                   - torch.arange(s, device=q.device)[None, :])
            mask = (lag >= 0) & (lag < window)
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, is_causal=mask is None,
            enable_gqa=True)

        def library(do_):
            return torch.autograd.grad(lib_out, (qs, ks, vs), do_,
                                       retain_graph=True)

        bnd, by = timing.bound(*timing.attention_bwd_work(
            b, h, hk, s, s, d, True, 2, dv=dv, window=window), "bfloat16")
        rec = {"name": "flash_attention_bwd", "config": config,
               "shape": [b, h, hk, s, d] + ([dv] if dv != d else []),
               "dtype": "bfloat16", "causal": True, "window": window,
               "library_backend": timing.sdpa_backend(q, k, v, mask is None,
                                                      mask),
               "scaled_err_vs_plain": [
                   ((g.float() - w.float()).abs().max()
                    / w.float().abs().max()).item()
                   for g, w in zip(got, want)],
               "deterministic": all(torch.equal(x, y)
                                    for x, y in zip(got, again)),
               "bound_ms": bnd, "bound_by": by}
        del again, want
        theirs = other
        if other is not None:
            try:
                their = theirs_bwd(q, k, v, out, do, lse)
                rec["same_bits_as_other"] = all(
                    torch.equal(x, y) for x, y in zip(got, their))
                del their
            except ValueError as err:   # a tree without this pair or window
                rec["other_refuses"] = str(err)
                theirs = None
        del got
        if theirs is not None:
            g = [timing.graph_ms(f, inputs)
                 for f in (theirs_bwd, kernel, kernel, theirs_bwd)]
            rec.update(ms=(g[1] + g[2]) / 2, runs_ms=[g[1], g[2]],
                       other_ms=(g[0] + g[3]) / 2, other_runs_ms=[g[0], g[3]],
                       other=str(other.__file__),
                       other_eager_ms=timing.cuda_ms(theirs_bwd, inputs))
        else:
            rec.update(ms=timing.graph_ms(kernel, inputs))
        lib_inputs = timing.cold_copies(do)
        turns = [timing.cuda_ms(kernel, inputs),
                 timing.cuda_ms(library, lib_inputs),
                 timing.cuda_ms(library, lib_inputs),
                 timing.cuda_ms(kernel, inputs)]
        rec.update(timing="graph", eager_ms=(turns[0] + turns[3]) / 2,
                   eager_runs_ms=[turns[0], turns[3]],
                   library_eager_ms=(turns[1] + turns[2]) / 2,
                   library_eager_runs_ms=[turns[1], turns[2]],
                   library="torch.autograd.grad of F.scaled_dot_product_"
                           "attention(" + ("attn_mask=the (S, S) causal "
                                           "window" if window else
                                           "is_causal=True")
                           + ", enable_gqa=True), the backward alone, "
                           "eagerly",
                   plain_ms=timing.cuda_ms(
                       lambda *a: bwd.flash_attention_bwd_plain(*a, **kw),
                       [(q, k, v, do)], iters=3, warmup=1),
                   **clocks_during(torch, kernel, inputs))
        pre_ms = timing.attention_bwd_prepass_bytes(
            b, h, s, dv, 2) / timing.PEAK_BYTES_S * 1e3
        rec.update(bound_share=bnd / rec["ms"],
                   ratio_to_library_eager=rec["eager_ms"]
                   / rec["library_eager_ms"],
                   split=bwd_split(torch, kernel, inputs),
                   prepass_bound_ms=pre_ms)
        rec["prepass_bound_share"] = (pre_ms / rec["split"]["prepass_ms"]
                                      if rec["split"]["prepass_ms"] else None)
        if theirs is not None:
            rec["other_split"] = bwd_split(torch, theirs_bwd, inputs)
            rec["other_prepass_bound_share"] = (
                pre_ms / rec["other_split"]["prepass_ms"]
                if rec["other_split"]["prepass_ms"] else None)
        emit(rec)
        del inputs, lib_inputs, lib_out
        torch.cuda.empty_cache()


def time_scan_bwd(torch, timing, kernels, emit, gen) -> None:
    """The scan's backward at :data:`SCAN_BWD_SHAPES`: this tree's kernels
    (the pre-pass over the sequence chunks, the reverse walk and the
    partial sums of one call) from the forward's checkpoints at every
    chunk length the plan picks from, in device time and eagerly, beside the
    bound, the plain version and its errors against it; with ``--src``
    the other checkout's backward and this tree's at their own plans in
    turns (other, this, this, other), each call split into its kernels
    (``torch.profiler``); then the forward with and without its
    checkpoints in turns, and with ``--src`` the other checkout's forward
    in turns with this tree's."""
    scan, own = kernels.ssm_scan, own_kernel("ssm_scan")
    bwd = own_kernel("ssm_scan_bwd")
    other = Path(scan.__file__).resolve() != Path(own.__file__).resolve()
    theirs = getattr(kernels, "ssm_scan_bwd", None) if other else None
    for config, (b, s, di, n) in SCAN_BWD_SHAPES:
        dt = torch.nn.functional.softplus(
            torch.randn(b, s, di, device=gen.device, generator=gen) - 2.0)
        x = torch.randn(b, s, di, device=gen.device, generator=gen)
        bm, cm = (torch.randn(b, s, n, device=gen.device, generator=gen)
                  for _ in range(2))
        a = -torch.arange(1, n + 1, device=gen.device,
                          dtype=torch.float32).expand(di, n).contiguous()
        d = torch.randn(di, device=gen.device, generator=gen)
        h0 = torch.randn(b, di, n, device=gen.device, generator=gen)
        dy = torch.randn(b, s, di, device=gen.device, generator=gen)
        args = (dt, x, bm, cm, a, d, h0)
        ckpt = torch.empty(b, bwd.checkpoints(s), di, n, device=gen.device)
        own.ssm_scan(*args, ckpt=ckpt)
        plan = bwd.bwd_plan(b, s, di, n)
        want = bwd.ssm_scan_bwd_plain(*args, dy)
        base = {"name": "ssm_scan_bwd", "config": config,
                "shape": [b, s, di, n], "dtype": "float32",
                "plan": {k: list(v) if isinstance(v, tuple) else v
                         for k, v in vars(plan).items()},
                "library_ms": None,
                "library": "none: no PyTorch call computes the selective "
                           "scan's gradient",
                **timing.scan_bwd_bound(b, s, di, n)}
        inputs = [(*args, dy)]
        for chunk in bwd.CHUNK_STEPS:
            def run(*t, chunk=chunk):
                return bwd.ssm_scan_bwd(*t, ckpt=ckpt, chunk=chunk)
            got = run(*inputs[0])
            ms = timing.graph_ms(run, inputs)
            emit(dict(base, timing="graph", lanes=plan.lanes, chunk=chunk,
                      planned=chunk == plan.chunk, ms=ms,
                      eager_ms=timing.cuda_ms(run, inputs),
                      scaled_err_vs_plain=[
                          ((g - w).abs().max() / w.abs().max()).item()
                          for g, w in zip(got, want)],
                      bound_share=base["bound_ms"] / ms))
            del got
        emit(dict(base, timing="eager", what="plain version",
                  plain_ms=timing.cuda_ms(bwd.ssm_scan_bwd_plain, inputs,
                                          iters=2, warmup=1)))
        if theirs is not None:
            def this_bwd(*t):
                return bwd.ssm_scan_bwd(*t, ckpt=ckpt)

            def other_bwd(*t):
                return theirs.ssm_scan_bwd(*t, ckpt=ckpt)
            mine, their = this_bwd(*inputs[0]), other_bwd(*inputs[0])
            g = [timing.graph_ms(f, inputs)
                 for f in (other_bwd, this_bwd, this_bwd, other_bwd)]
            emit(dict(base, timing="graph", what="backward in turns",
                      ms=(g[1] + g[2]) / 2, runs_ms=[g[1], g[2]],
                      other_ms=(g[0] + g[3]) / 2, other_runs_ms=[g[0], g[3]],
                      eager_ms=timing.cuda_ms(this_bwd, inputs),
                      other_eager_ms=timing.cuda_ms(other_bwd, inputs),
                      other=str(theirs.__file__),
                      other_scaled_err_vs_plain=[
                          ((g_ - w).abs().max() / w.abs().max()).item()
                          for g_, w in zip(their, want)],
                      same_bits=all(torch.equal(p, q)
                                    for p, q in zip(mine, their)),
                      bound_share=base["bound_ms"] * 2 / (g[1] + g[2]),
                      split=bwd_split(torch, this_bwd, inputs,
                                      SCAN_BWD_KERNELS),
                      other_split=bwd_split(torch, other_bwd, inputs,
                                            SCAN_BWD_KERNELS)))
            del mine, their
        fwd = {"this, checkpoints": lambda *t: own.ssm_scan(*t, ckpt=ckpt),
               "this": own.ssm_scan}
        if other:
            fwd["other"] = scan.ssm_scan
        order = list(fwd) + list(fwd)[::-1]
        runs = [timing.graph_ms(fwd[k], [args]) for k in order]
        emit(dict(base, timing="graph", what="forward in turns",
                  forward_ms={k: [r for o, r in zip(order, runs) if o == k]
                              for k in fwd},
                  other=str(scan.__file__) if other else None,
                  other_has_backward=theirs is not None))
        del args, inputs, ckpt, want
        torch.cuda.empty_cache()


PARTS = {"matmul": time_matmul, "axpy": time_axpy, "slot": time_slot,
         "dct": time_dct, "dotp": time_dotp, "fft": time_fft_long,
         "powf": time_powf, "attention": time_attention, "mla": time_mla,
         "window": time_window, "scan": time_scan,
         "attention_bwd": time_attention_bwd, "scan_bwd": time_scan_bwd}


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
                                     flash_attn_bwd, matmul, ops, powf, ref,
                                     ssm_scan)
    kernels = types.SimpleNamespace(axpy=axpy, dct=dct, dotp=dotp, fft4=fft4,
                                    flash_attn=flash_attn,
                                    flash_attn_bwd=flash_attn_bwd,
                                    matmul=matmul, ops=ops, powf=powf,
                                    ref=ref, ssm_scan=ssm_scan)
    try:                        # a tree without the scan's backward
        from repro_torch.kernels import ssm_scan_bwd
        kernels.ssm_scan_bwd = ssm_scan_bwd
    except ImportError:
        pass
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
