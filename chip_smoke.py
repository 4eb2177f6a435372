#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path on the card and checks every result; each
phase prints one JSON line:

1. ``info``: the card (name and power limit from ``nvidia-smi``), the
   torch and CUDA versions, and the time to build the CUDA kernels from
   ``src/repro_torch/csrc``.
2. ``kernel``: every kernel against its plain PyTorch version on the
   card, at the test shapes and the main path's shapes, with its time,
   the plain version's time, one PyTorch library call's time and the
   least time the card could take (its bound).
3. ``fiveg_pipeline``: one 5G NR slot (64 antennas x 4096 sub-carriers
   x 14 symbols) through the FFT stage and matmul kernels, checked
   against numpy; the launch counts of this run.
4. ``fig4a``: the Fig. 4a sweep at N = 1024 (10 radices x 4 delays x
   1024 trials), its first 16 trials bit for bit against the port's
   ``simulate_reference`` on the CPU and the JAX reference values.
5. ``fig7``: the Fig. 7 grid of ``benchmarks/fig7_5g_app.py`` against
   the JAX reference values, with the wall time per ``simulate_app``,
   and claim C4 (paper: 1.6x at fine-grained sync, <= 6.2 % sync).

Then the kernels' summary line and, last, the device line.  Any failed
check raises: the script exits non-zero and prints no result.  It needs
the rest of the checkout (``src/repro_torch``) and a CUDA device.
"""
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bandwidth,
# float32 outside the tensor cores, bf16 in the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {"float32": 67e12, "bfloat16": 989e12}
L2_BYTES = 50e6

MODES = ("central", "tree", "partial", "hw")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, inputs, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` on the device: CUDA events
    around ``iters`` back-to-back calls after ``warmup`` calls, cycling
    through the argument tuples of ``inputs`` (see :func:`cold_copies`)."""
    for i in range(warmup):
        fn(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cold_copies(*tensors) -> list:
    """Enough copies of the argument tuple that cycling through them
    streams more than twice the H100's 50 MB L2 cache, so each timed
    call reads its inputs from device memory, as the bound assumes."""
    size = sum(t.numel() * t.element_size() for t in tensors)
    count = min(8, max(1, math.ceil(2 * L2_BYTES / size)))
    return [tensors] + [tuple(t.clone() for t in tensors)
                        for _ in range(count - 1)]


def bound(bytes_moved: float, flops: float, dtype: str) -> tuple:
    t_bytes = bytes_moved / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_info(torch, build):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    paths = build.build(["fft4_stage", "matmul"])
    build_s = time.perf_counter() - t0
    emit({"phase": "info", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "build_s": build_s,
          "libraries": [p.name for p in paths.values()]})


def phase_kernels(torch, ops, fft4, matmul, ref) -> dict:
    """Each kernel against its plain version on the same inputs; returns
    the main-path measurements for the summary line."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    summary = {}

    # fft4_stage: every stage of the chain, kernel and plain on the same
    # input.  The two differ only in FMA contraction and operation order
    # inside a butterfly: a few float32 ulps of the largest output.
    for n in (16, 256, 4096):
        for rows in (3, 896):
            re = torch.randn(rows, n, device=dev, generator=gen)
            im = torch.randn(rows, n, device=dev, generator=gen)
            err = 0.0
            scale = 0.0
            stages = int(round(math.log(n, 4)))
            x_re, x_im = re, im
            for s in range(stages):
                wr, wi = ops._stage_twiddles(n, s, dev)
                kr, ki = fft4.fft4_stage(x_re, x_im, wr, wi)
                pr, pi = fft4.fft4_stage_plain(x_re, x_im, wr, wi)
                err = max(err, (kr - pr).abs().max().item(),
                          (ki - pi).abs().max().item())
                scale = max(scale, pr.abs().max().item(),
                            pi.abs().max().item())
                x_re, x_im = pr, pi
            tol = 1e-5 * scale
            if not err <= tol:
                raise AssertionError(
                    f"fft4_stage ({rows}, {n}): max abs err {err} > {tol}")
            rec = {"phase": "kernel", "name": "fft4_stage",
                   "shape": [rows, n], "stages": stages,
                   "max_abs_err": err, "tol": tol}
            if (rows, n) == (896, 4096):
                rec.update(_time_fft(torch, ops, fft4, ref, re, im, stages))
                summary["fft4_stage"] = rec
            emit(rec)

    # matmul: the reference's test shapes in both dtypes and the 5G
    # beamforming shape.  Tolerance: the reference's float32 test bound
    # (rtol 1e-4, atol 1e-4 sqrt(K)); bf16 inputs convert to float32
    # exactly in both, so only the summation order differs.
    shapes = ((8, 16, 8), (100, 60, 72), (256, 512, 128), (129, 257, 65),
              (32, 64, 57344))
    for m, k, n in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(m, k, device=dev, generator=gen).to(dtype)
            w = torch.randn(k, n, device=dev, generator=gen).to(dtype)
            got = matmul.matmul(x, w)
            want = matmul.matmul_plain(x, w)
            err = (got - want).abs().max().item()
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                       rtol=1e-4, atol=1e-4 * k ** 0.5)
            if got.dtype != torch.float32:
                raise AssertionError(f"matmul returned {got.dtype}")
            name = str(dtype).split(".")[1]
            rec = {"phase": "kernel", "name": "matmul", "shape": [m, k, n],
                   "dtype": name, "max_abs_err": err,
                   "tol": {"rtol": 1e-4, "atol": 1e-4 * k ** 0.5}}
            itemsize = x.element_size()
            b_ms, b_by = bound((m * k + k * n) * itemsize + m * n * 4,
                               2.0 * m * n * k, name)
            args = cold_copies(x, w)
            rec.update({
                "ms": cuda_ms(torch, matmul.matmul, args),
                "plain_ms": cuda_ms(torch, matmul.matmul_plain, args,
                                    iters=5),
                "library_ms": cuda_ms(torch, torch.matmul, args),
                "library": "torch.matmul (output in the input dtype)",
                "bound_ms": b_ms, "bound_by": b_by})
            if (m, k, n) == (32, 64, 57344) and dtype == torch.float32:
                summary["matmul"] = rec
            emit(rec)
    return summary


def _time_fft(torch, ops, fft4, ref, re, im, stages) -> dict:
    """Times of the whole ``ops.fft4`` chain at the 5G shape: the kernel
    chain, the plain chain, and torch.fft plus the digit-reversal gather
    that gives the same output order."""
    rows, n = re.shape
    idx = ref.digit_reverse_indices(n, device=re.device)
    twiddles = [ops._stage_twiddles(n, s, re.device) for s in range(stages)]

    def chain(stage_fn, x_re, x_im):
        for wr, wi in twiddles:
            x_re, x_im = stage_fn(x_re, x_im, wr, wi)
        return x_re, x_im

    def library(x_re, x_im):
        y = torch.fft.fft(torch.complex(x_re, x_im))[:, idx]
        return y.real, y.imag

    # The least traffic of the whole transform: both planes read once and
    # written once, twiddles read once.  The stage chain as written moves
    # `stages` times the plane traffic; fusing the stages of a row in
    # shared memory would close that gap.
    bytes_moved = 4 * rows * n * 4 + sum(
        2 * wr.numel() * 4 for wr, _ in twiddles)
    flops = stages * rows * (n // 4) * 34
    b_ms, b_by = bound(bytes_moved, flops, "float32")
    lr, li = library(re, im)
    kr, ki = chain(fft4.fft4_stage, re, im)
    args = cold_copies(re, im)
    return {"unit": f"ops.fft4 over ({rows}, {n}): {stages} stage launches",
            "ms": cuda_ms(torch, lambda *a: chain(fft4.fft4_stage, *a),
                          args),
            "plain_ms": cuda_ms(torch,
                                lambda *a: chain(fft4.fft4_stage_plain, *a),
                                args),
            "library_ms": cuda_ms(torch, library, args),
            "library": "torch.fft.fft + digit-reversal gather",
            "library_max_abs_diff": max((kr - lr).abs().max().item(),
                                        (ki - li).abs().max().item()),
            "stage_bound_ms": bound(4 * rows * n * 4, 0.0, "float32")[0],
            "bound_ms": b_ms, "bound_by": b_by}


def phase_pipeline(torch, pipeline, fft4, matmul) -> dict:
    fft4.LAUNCHES = 0
    matmul.LAUNCHES = 0
    t0 = time.perf_counter()
    out = pipeline.execute(device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fft4_stage": fft4.LAUNCHES, "matmul": matmul.LAUNCHES}
    errs = pipeline.check(out)
    if launches != {"fft4_stage": 6, "matmul": 2}:
        raise AssertionError(f"main path launches {launches}, expected "
                             f"6 fft4_stage and 2 matmul")
    emit({"phase": "fiveg_pipeline", "rows": list(out["re"].shape),
          "beams": list(out["beams_r"].shape), "wall_s": wall,
          "launches": launches, "max_abs_err": errs,
          "tol": {"fft": [pipeline.FFT_RTOL, pipeline.FFT_ATOL],
                  "matmul_rtol": pipeline.MM_RTOL,
                  "matmul_atol": pipeline.MM_ATOL_PER_SQRT_K
                  * out["coef"].shape[1] ** 0.5}})
    return launches


def phase_fig4a(torch, barrier, barrier_sim, prng, sweep, ref_values):
    ref = ref_values["fig4a"]

    def grid():
        t0 = time.perf_counter()
        res = sweep.sweep_barrier(prng.PRNGKey(ref["key"]),
                                  delays=ref["delays"], n_pes=ref["n_pes"],
                                  n_trials=1024, trial_chunk=256,
                                  device="cuda")
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    # The first run pays the process's first use of every torch kernel on
    # the path; the second is the steady state.
    res, first_wall = grid()
    res, wall = grid()
    spans = res.span_cycles.cpu()
    if spans.shape != (10, 4, 1024) or not torch.isfinite(spans).all():
        raise AssertionError(f"bad Fig. 4a spans {spans.shape}")
    want = torch.tensor(ref["span_cycles"], dtype=torch.float32)
    if not torch.equal(spans[:, :, :ref["n_trials"]], want):
        raise AssertionError("Fig. 4a prefix differs from the reference")
    # The same 16 trials through the port's seed loop on the CPU.
    key = prng.PRNGKey(ref["key"], device="cpu")
    for ri, r in enumerate(ref["radices"]):
        sched = barrier.kary_tree(r, n_pes=ref["n_pes"])
        for di, d in enumerate(ref["delays"]):
            arr = barrier_sim.uniform_arrivals(key, d, ref["n_pes"],
                                               ref["n_trials"], device="cpu")
            cpu = barrier_sim.simulate_reference(arr, sched, device="cpu")
            if not torch.equal(spans[ri, di, :ref["n_trials"]],
                               cpu.span_cycles):
                raise AssertionError(
                    f"Fig. 4a radix {r} delay {d}: card != CPU reference")
    mean = res.mean_span.cpu()
    best = sweep.best_radix_per_delay(res).cpu().tolist()
    radices = ref["radices"]
    # C1/C2: the central counter is worst at zero scatter and best at
    # 2048 cycles; mid radices win at zero scatter.
    central = radices.index(1024)
    if not (mean[central, 0] == mean[:, 0].max() and best[0] in (16, 32)
            and mean[central, 3] == mean[:, 3].min()):
        raise AssertionError(f"C1/C2 do not hold: best radix {best}")
    emit({"phase": "fig4a", "grid": list(spans.shape), "wall_s": wall,
          "first_wall_s": first_wall, "prefix_bit_exact": True, "best_radix_per_delay": best,
          "mean_span": [[round(v, 3) for v in row]
                        for row in mean.tolist()]})


def phase_fig7(torch, fiveg, prng, ref_values):
    ref = ref_values["fig7"]
    times = {m: [] for m in MODES}
    for row in ref["rows"]:
        app = fiveg.FiveGConfig(n_rx=row["n_rx"],
                                ffts_per_round=row["ffts_per_round"])
        got = {}
        for mode in MODES:
            t0 = time.perf_counter()
            res = fiveg.simulate_app(prng.PRNGKey(ref["key"]), app,
                                     sync=mode, radix=ref["radix"],
                                     device="cuda")
            torch.cuda.synchronize()
            times[mode].append(time.perf_counter() - t0)
            want = row[mode]
            if res.total_cycles.item() != np.float32(want["total_cycles"]):
                raise AssertionError(
                    f"Fig. 7 {row['n_rx']}/{row['ffts_per_round']} {mode}: "
                    f"total_cycles {res.total_cycles.item()} != "
                    f"{want['total_cycles']}")
            for c in ("sync_fraction", "sync_energy"):
                np.testing.assert_allclose(getattr(res, c).item(), want[c],
                                           rtol=1e-5)
            got[mode] = res.total_cycles.item()
        emit({"phase": "fig7", "n_rx": row["n_rx"],
              "ffts_per_round": row["ffts_per_round"],
              "total_cycles": got,
              "wall_s": {m: times[m][-1] for m in MODES}})

    # C4, as tests/test_barrier_sim.py::test_c4_5g_application holds it.
    key = prng.PRNGKey(0)
    fine = fiveg.compare_barriers(key, fiveg.FiveGConfig(n_rx=16,
                                                         ffts_per_round=1),
                                  radix=32, modes=MODES, device="cuda")
    coarse = fiveg.compare_barriers(key, fiveg.FiveGConfig(n_rx=64,
                                                           ffts_per_round=4),
                                    radix=32, modes=MODES, device="cuda")
    speedup = fine["speedup_partial"].item()
    speedup4 = coarse["speedup_partial"].item()
    frac = coarse["partial"].sync_fraction.item()
    serial = coarse["partial"].speedup_serial.item()
    if not (1.4 <= speedup <= 1.8 and frac <= 0.062 + 0.01
            and 1.0 < speedup4 < speedup and serial > 500):
        raise AssertionError(f"C4 fails: speedup {speedup}, {speedup4}; "
                             f"sync fraction {frac}; serial {serial}")
    emit({"phase": "fig7_c4", "speedup_partial_16x1": speedup,
          "speedup_partial_64x4": speedup4,
          "sync_fraction_partial_64x4": frac,
          "mean_wall_s_per_simulate_app": {
              m: sum(v) / len(v) for m, v in times.items()}})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    from repro_torch.core import barrier, barrier_sim, fiveg, prng, sweep
    from repro_torch.examples import fiveg_pipeline
    from repro_torch.kernels import _build, fft4, matmul, ops, ref

    ref_values = json.loads(
        (ROOT / "src" / "repro_torch" / "reference_values.json").read_text())
    phase_info(torch, _build)
    summary = phase_kernels(torch, ops, fft4, matmul, ref)
    launches = phase_pipeline(torch, fiveg_pipeline, fft4, matmul)
    phase_fig4a(torch, barrier, barrier_sim, prng, sweep, ref_values)
    phase_fig7(torch, fiveg, prng, ref_values)

    replaces = {"fft4_stage": "src/repro/kernels/fft4.py:58",
                "matmul": "src/repro/kernels/matmul.py:41"}
    sources = {"fft4_stage": "src/repro_torch/csrc/fft4_stage.cu",
               "matmul": "src/repro_torch/csrc/matmul.cu"}
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": sources[name],
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": summary[name]["max_abs_err"],
         "ms": summary[name]["ms"], "plain_ms": summary[name]["plain_ms"],
         "bound_ms": summary[name]["bound_ms"],
         "bound_by": summary[name]["bound_by"],
         "library_ms": summary[name]["library_ms"],
         "shape": summary[name]["shape"],
         "unit": summary[name].get("unit", "one launch")}
        for name in ("fft4_stage", "matmul")]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
