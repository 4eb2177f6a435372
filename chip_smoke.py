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
6. ``dotp_axpy``: the Fig. 5/6 benchmark kernels through ``ops.dotp``
   (central accumulator and k-ary trees of radix 2 to 1024) and
   ``ops.axpy`` at the Fig. 5 sizes and at 64 Mi elements, with the
   launch counts of that run; each kernel against its plain version and
   timed beside its bound and one PyTorch library call.
7. ``fig5``: every Fig. 5 kernel's arrival gap and median against the
   JAX reference values, and claim C5.
8. ``fig6``: the 7-radix x 15-kernel grid of
   ``benchmarks/fig6_kernel_colormap.py`` against the reference values.
9. ``tuner``: ``sweep_workloads`` over all 512 compositions x 15 kernels
   x 4 trials at N = 1024, the per-delay tuner on the same schedules,
   claim C6, and one placed ``tune_barrier``.
10. ``fig7_tuned``: the five tuner modes of the 5G app at (16, 1) and
    (64, 4) against the reference values.
11. ``normal``: ``prng.normal`` on the card against stored JAX draws,
    in ulps.

Each phase prints its wall time.  Then the kernels' summary line and,
last, the device line.  Any failed
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
TUNED_MODES = ("tuned", "tuned_partial", "placed", "workload", "pareto")
KERNELS = ("fft4_stage", "matmul", "dotp_central", "dotp_partials",
           "combine_partials", "axpy")
REPLACES = {"fft4_stage": "src/repro/kernels/fft4.py:58",
            "matmul": "src/repro/kernels/matmul.py:41",
            "dotp_central": "src/repro/kernels/dotp.py:40",
            "dotp_partials": "src/repro/kernels/dotp.py:64",
            "combine_partials": "src/repro/kernels/dotp.py:89",
            "axpy": "src/repro/kernels/axpy.py:27"}
SOURCES = {"fft4_stage": "src/repro_torch/csrc/fft4_stage.cu",
           "matmul": "src/repro_torch/csrc/matmul.cu",
           "dotp_central": "src/repro_torch/csrc/dotp.cu",
           "dotp_partials": "src/repro_torch/csrc/dotp.cu",
           "combine_partials": "src/repro_torch/csrc/dotp.cu",
           "axpy": "src/repro_torch/csrc/axpy.cu"}
# The dot product's path: the Fig. 5 input sizes and the 64 Mi-element
# case where the bandwidth bound means something; the central
# accumulator (radix 0) and the tree radices of the Fig. 6 sweep.
DOTP_SIZES = (1 << 18, 1 << 19, 1 << 20, 1 << 26)
DOTP_RADICES = (0, 2, 4, 16, 32, 1024)
AXPY_SIZES = (1 << 20, 1 << 26)


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
    paths = build.build(["fft4_stage", "matmul", "dotp", "axpy"])
    build_s = time.perf_counter() - t0
    emit({"phase": "info", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "build_s": build_s,
          "libraries": [p.name for p in paths.values()]})


def phase_kernels(torch, ops, fft4, matmul, ref) -> dict:
    """Each kernel against its plain version on the same inputs; returns
    the main-path measurements for the summary line."""
    t_phase = time.perf_counter()
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
    emit({"phase": "kernel", "wall_s": time.perf_counter() - t_phase})
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


DOTP_RTOL = 1e-5   # of one leaf's sum |x_i y_i|


def dotp_limits(ref, x, y) -> tuple:
    """The limits that float32 sums taken in another order must keep:
    each leaf's partial within ``DOTP_RTOL`` of that leaf's own
    sum |x_i y_i| (s_j), and a whole dot product within those limits
    combined as independent errors, ``DOTP_RTOL * sqrt(sum_j s_j^2)``.
    Returns ``(per-leaf limits, whole-sum limit)``."""
    leaf = DOTP_RTOL * ref.dotp_partials(x.abs(), y.abs())
    return leaf, leaf.square().sum().sqrt().item()


def check_leaves(got, plain, leaf_lim, what: str) -> tuple:
    """Every partial within its own leaf's limit; returns the max abs
    error and the largest share of a limit that an error used."""
    err = (got - plain).abs()
    share = (err / leaf_lim).nan_to_num(nan=0.0).max().item()
    if not share <= 1.0:
        bad = int((err > leaf_lim).nonzero()[0])
        raise AssertionError(f"{what}: leaf {bad} off by {err[bad].item()} "
                             f"> {leaf_lim[bad].item()}")
    return err.max().item(), share


def check_sum(got: float, plain: float, lim: float, what: str) -> float:
    err = abs(got - plain)
    if not err <= lim:
        raise AssertionError(f"{what}: {got} vs plain {plain} (limit {lim})")
    return err


def planted_leaf_fault(ref, x, y, parts, central) -> dict:
    """The checks must see a fault: the leaf of median |sum| zeroed in
    the partials, and its sum taken out of the central result, must
    each fail their check."""
    plain = ref.dotp_partials(x, y)
    leaf_lim, sum_lim = dotp_limits(ref, x, y)
    j = int(plain.abs().argsort()[plain.numel() // 2])
    bad = parts.clone()
    bad[j] = 0.0
    caught = {}
    for what, check in (
            ("dotp_partials", lambda: check_leaves(bad, plain, leaf_lim, "")),
            ("dotp_central", lambda: check_sum(
                central - parts[j].item(), plain.sum().item(), sum_lim, ""))):
        try:
            check()
            caught[what] = False
        except AssertionError:
            caught[what] = True
    if not all(caught.values()):
        raise AssertionError(f"a zeroed leaf {j} (sum {plain[j].item()}) "
                             f"passes the checks: {caught}")
    return {"leaf": j, "leaf_sum": plain[j].item(), "sum_limit": sum_lim,
            "caught": caught}


def phase_dotp_axpy(torch, ops, dotp, axpy, ref) -> tuple:
    """The Fig. 5/6 kernels' path: ``ops.dotp`` at every radix and
    ``ops.axpy`` at every size, with the launch counts of that run; then
    each kernel against its plain version, and the times.  Returns the
    summary records and the launch counts."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    big = max(DOTP_SIZES)
    x32 = torch.randn(big, device=dev, generator=gen)
    y32 = torch.randn(big, device=dev, generator=gen)
    xb, yb = x32.to(torch.bfloat16), y32.to(torch.bfloat16)

    # The path, counted: every call a user would make, nothing else.
    for k in dotp.LAUNCHES:
        dotp.LAUNCHES[k] = 0
    axpy.LAUNCHES = 0
    results = {}
    for n in DOTP_SIZES:
        for r in DOTP_RADICES:
            results[("dotp", n, r)] = ops.dotp(x32[:n], y32[:n], radix=r)
    for n in AXPY_SIZES:
        for name, (x, y) in (("float32", (x32, y32)),
                             ("bfloat16", (xb, yb))):
            results[("axpy", n, name)] = ops.axpy(1.7, x[:n], y[:n])
    torch.cuda.synchronize()
    launches = dict(dotp.LAUNCHES, axpy=axpy.LAUNCHES)
    trees = [(n, r) for n in DOTP_SIZES for r in DOTP_RADICES if r > 1]
    want = {"dotp_central": len(DOTP_SIZES), "dotp_partials": len(trees),
            "combine_partials": sum(ops.dotp_levels(n, r) for n, r in trees),
            "axpy": 2 * len(AXPY_SIZES)}
    if launches != want:
        raise AssertionError(f"dotp/axpy path launches {launches}, "
                             f"expected {want}")

    summary = {}
    # Results of the path against the plain versions.
    for n in DOTP_SIZES:
        x, y = x32[:n], y32[:n]
        plain = ref.dotp(x, y).item()
        tol = dotp_limits(ref, x, y)[1]
        errs = [check_sum(results[("dotp", n, r)].item(), plain, tol,
                          f"ops.dotp n={n} radix={r}") for r in DOTP_RADICES]
        emit({"phase": "dotp_axpy", "op": "ops.dotp", "n": n,
              "leaves": dotp.leaf_count(n),
              "launches_per_call": {r: 1 + ops.dotp_levels(n, r)
                                    for r in DOTP_RADICES},
              "max_abs_err": max(errs), "tol": tol})
    for n in AXPY_SIZES:
        for name, (x, y), tol in (("float32", (x32, y32), 1e-5),
                                  ("bfloat16", (xb, yb), 2e-2)):
            got = results[("axpy", n, name)]
            plain = ref.axpy(1.7, x[:n], y[:n])
            if got.dtype != x.dtype:
                raise AssertionError(f"axpy returned {got.dtype}")
            np.testing.assert_allclose(got.float().cpu().numpy(),
                                       plain.float().cpu().numpy(),
                                       rtol=tol, atol=tol)
            err = (got.float() - plain.float()).abs().max().item()
            rec = {"phase": "dotp_axpy", "name": "axpy", "n": n,
                   "dtype": name, "max_abs_err": err,
                   "tol": {"rtol": tol, "atol": tol}}
            args = [(1.7,) + xy for xy in cold_copies(x[:n], y[:n])]
            b_ms, b_by = bound(3 * n * x.element_size(), 2.0 * n, name)
            rec.update({
                "ms": cuda_ms(torch, axpy.axpy, args),
                "plain_ms": cuda_ms(torch, axpy.axpy_plain, args),
                "library_ms": cuda_ms(
                    torch, lambda a, u, v: torch.add(v, u, alpha=a), args),
                "library": "torch.add(y, x, alpha=a)",
                "bound_ms": b_ms, "bound_by": b_by})
            if (n, name) == (big, "float32"):
                summary["axpy"] = rec
            emit(rec)

    # The three dot-product kernels one at a time, bf16 leaves included.
    for n in (1 << 20, big):
        for name, (x, y) in (("float32", (x32[:n], y32[:n])),
                             ("bfloat16", (xb[:n], yb[:n]))):
            leaf_lim, tol = dotp_limits(ref, x, y)
            args = cold_copies(x, y)
            b_ms, b_by = bound(2 * n * x.element_size(), 2.0 * n, "float32")
            parts = dotp.dotp_partials(x, y)
            err, share = check_leaves(parts, dotp.dotp_partials_plain(x, y),
                                      leaf_lim, f"dotp_partials n={n} {name}")
            rec = {"phase": "dotp_axpy", "name": "dotp_partials", "n": n,
                   "dtype": name, "max_abs_err": err,
                   "tol": f"{DOTP_RTOL} * each leaf's sum |x_i y_i|",
                   "max_share_of_limit": share,
                   "ms": cuda_ms(torch, dotp.dotp_partials, args),
                   "plain_ms": cuda_ms(torch, dotp.dotp_partials_plain,
                                       args),
                   "library_ms": cuda_ms(
                       torch, lambda u, v: torch.einsum(
                           "ij,ij->i", u.view(-1, ref.DOTP_LEAF),
                           v.view(-1, ref.DOTP_LEAF)), args),
                   "library": "torch.einsum('ij,ij->i') over the leaves",
                   "bound_ms": b_ms, "bound_by": b_by}
            if (n, name) == (big, "float32"):
                summary["dotp_partials"] = rec
            emit(rec)
            central = dotp.dotp_central(x, y).item()
            err = check_sum(central, dotp.dotp_central_plain(x, y).item(),
                            tol, f"dotp_central n={n} {name}")
            if (n, name) == (big, "float32"):
                emit({"phase": "dotp_axpy", "n": n, "dtype": name,
                      "planted_fault": planted_leaf_fault(
                          ref, x, y, parts, central)})
            rec = {"phase": "dotp_axpy", "name": "dotp_central", "n": n,
                   "dtype": name, "max_abs_err": err, "tol": tol,
                   "ms": cuda_ms(torch, dotp.dotp_central, args),
                   "plain_ms": cuda_ms(torch, dotp.dotp_central_plain,
                                       args),
                   "library_ms": cuda_ms(torch, torch.dot, args),
                   "library": "torch.dot",
                   "bound_ms": b_ms, "bound_by": b_by}
            if (n, name) == (big, "float32"):
                summary["dotp_central"] = rec
            emit(rec)

    # One tree level at the 64 Mi leaf count, and every whole chain.
    parts = dotp.dotp_partials(x32, y32)
    for r in (2, 32, 1024):
        got = dotp.combine_partials(parts, r)
        want_c = dotp.combine_partials_plain(parts, r)
        # 1e-6 of each group's own sum |partial|.
        group_lim = 1e-6 * dotp.combine_partials_plain(parts.abs(), r)
        err, share = check_leaves(got, want_c, group_lim,
                                  f"combine_partials radix {r}")
        tol = "1e-6 * each group's sum |partial|"
        n_out = got.numel()
        b_ms, b_by = bound(4 * (parts.numel() + n_out), parts.numel(),
                           "float32")
        rec = {"phase": "dotp_axpy", "name": "combine_partials",
               "n": parts.numel(), "radix": r, "max_abs_err": err,
               "tol": tol, "max_share_of_limit": share,
               "ms": cuda_ms(torch, dotp.combine_partials, [(parts, r)]),
               "plain_ms": cuda_ms(torch, dotp.combine_partials_plain,
                                   [(parts, r)]),
               "library_ms": (cuda_ms(torch, lambda p, k: p.view(-1, k).sum(
                   dim=1), [(parts, r)])
                   if parts.numel() % r == 0 else None),
               "library": "tensor.view(-1, radix).sum(dim=1)",
               "bound_ms": b_ms, "bound_by": b_by}
        if r == 32:
            summary["combine_partials"] = rec
        emit(rec)

    def plain_chain(x, y, r):
        if r <= 1:
            return ref.dotp_central(x, y)
        p = ref.dotp_partials(x, y)
        while p.numel() > 1:
            p = ref.combine_partials(p, r)
        return p[0]

    for n in (1 << 20, big):
        args = cold_copies(x32[:n], y32[:n])
        emit({"phase": "dotp_axpy", "op": "ops.dotp chain", "n": n,
              "ms": {r: cuda_ms(torch, lambda u, v: ops.dotp(u, v, radix=r),
                                args) for r in DOTP_RADICES},
              "plain_ms": {r: cuda_ms(torch, lambda u, v: plain_chain(
                  u, v, r), args) for r in DOTP_RADICES},
              "library_ms": cuda_ms(torch, torch.dot, args),
              "bound_ms": bound(8 * n, 2.0 * n, "float32")[0]})
    emit({"phase": "dotp_axpy", "launches": launches,
          "wall_s": time.perf_counter() - t_phase})
    return summary, launches


def phase_fig5(torch, prng, workloads, ref_values) -> None:
    t0 = time.perf_counter()
    ref = ref_values["fig5"]
    key = prng.PRNGKey(ref["key"])
    gaps = {}
    for kernel, dims in workloads.benchmark_suite().items():
        for label, fn in dims.items():
            name = f"{kernel}_{label}"
            arr = fn(key)
            if arr.shape != (1024,) or not torch.isfinite(arr).all():
                raise AssertionError(f"Fig. 5 {name}: bad arrivals")
            gap = workloads.cdf_first_last_gap(arr).item()
            p50 = torch.quantile(arr - arr.min(), 0.5).item()
            want = ref["kernels"][name]
            if gap != want["gap"]:
                raise AssertionError(f"Fig. 5 {name}: gap {gap} != "
                                     f"{want['gap']}")
            np.testing.assert_allclose(p50, want["p50"], rtol=1e-6)
            gaps[name] = gap
    # C5, as tests/test_barrier_sim.py::test_kernel_cdf_shapes holds it.
    suite = workloads.benchmark_suite()
    pick = {k: gaps[f"{k}_{max(dims)}"] for k, dims in suite.items()}
    if not (pick["axpy"] < pick["dotp"] and pick["dotp"] > 900
            and pick["conv2d"] > pick["axpy"]):
        raise AssertionError(f"C5 does not hold: {pick}")
    emit({"phase": "fig5", "gap": gaps, "c5": pick, "bit_exact": True,
          "wall_s": time.perf_counter() - t0})


def phase_fig6(torch, barrier, prng, sweep, workloads, ref_values) -> None:
    t0 = time.perf_counter()
    ref = ref_values["fig6"]
    key = prng.PRNGKey(ref["key"])
    suite = workloads.benchmark_suite()
    arrivals = torch.stack([fn(key) for dims in suite.values()
                            for fn in dims.values()])[:, None, :]
    res = sweep.sweep_arrivals(
        arrivals, [barrier.kary_tree(r) for r in ref["radices"]],
        kernels=ref["kernels"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    totals = res.exit_time[:, :, 0].cpu()
    if not torch.equal(totals, torch.tensor(ref["exit_time"],
                                            dtype=torch.float32)):
        raise AssertionError("Fig. 6 exit times differ from the reference")
    resid = res.mean_residency[:, :, 0].cpu()
    np.testing.assert_allclose(resid.numpy(), ref["mean_residency"],
                               rtol=1e-6)
    best = totals.argmin(dim=0).tolist()
    radix = [ref["radices"][i] for i in best]
    frac = [(resid[i, j] / totals[i, j]).item() for j, i in enumerate(best)]
    speedup = [(totals[:, j].max() / totals[i, j]).item()
               for j, i in enumerate(best)]
    if radix != ref["best_radix"]:
        raise AssertionError(f"Fig. 6 best radix {radix}")
    np.testing.assert_allclose(frac, ref["fraction"], rtol=1e-5)
    np.testing.assert_allclose(speedup, ref["speedup"], rtol=1e-6)
    emit({"phase": "fig6", "grid": list(res.exit_time.shape),
          "best_radix": dict(zip(ref["kernels"], radix)),
          "speedup": dict(zip(ref["kernels"], speedup)), "wall_s": wall})


def phase_tuner(torch, placement, prng, sweep, tuning, ref_values) -> None:
    ref = ref_values["tuner"]
    key = prng.PRNGKey(ref["key"])
    schedules = tuning.all_schedules(ref["n_pes"])
    t0 = time.perf_counter()
    wres = tuning.sweep_workloads(key, n_pes=ref["n_pes"],
                                  n_trials=ref["n_trials"],
                                  schedules=schedules)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lanes = math.prod(wres.span_cycles.shape) * ref["n_pes"]
    if (wres.span_cycles.shape != (ref["n_schedules"], len(ref["kernels"]),
                                   ref["n_trials"])
            or not torch.isfinite(wres.span_cycles).all()):
        raise AssertionError(f"bad tuner grid {wres.span_cycles.shape}")
    points = tuning.best_per_kernel(wres)
    for p, want in zip(points, ref["workload"]):
        got = (p.kernel, p.schedule.name, p.uniform_schedule.name)
        if got != (want["kernel"], want["schedule"],
                   want["uniform_schedule"]):
            raise AssertionError(f"tuner winner {got} != {want}")
        np.testing.assert_allclose([p.mean_span, p.uniform_span],
                                   [want["mean_span"], want["uniform_span"]],
                                   rtol=1e-6)
    dres = tuning.tune_barrier(key, ref["n_pes"], delays=ref["delays"],
                               n_trials=ref["n_trials"], schedules=schedules)
    per_delay = tuning.best_per_delay(dres)
    if [p.schedule.name for p in per_delay] != [
            w["schedule"] for w in ref["per_delay"]]:
        raise AssertionError("per-delay tuner winners differ")
    # C6: each kernel's workload winner matches or beats every per-delay
    # winner, evaluated on that kernel's own arrivals.
    spans = wres.mean_span.cpu().numpy()
    for j, p in enumerate(points):
        for w in {q.schedule for q in per_delay}:
            if not p.mean_span <= spans[wres.schedules.index(w), j]:
                raise AssertionError(f"C6 fails for {p.kernel} vs {w.name}")
    t1 = time.perf_counter()
    pres = tuning.tune_barrier(key, ref["n_pes"], delays=ref["delays"],
                               n_trials=ref["n_trials"], prune="hierarchy",
                               placements=placement.STRATEGIES)
    torch.cuda.synchronize()
    placed_wall = time.perf_counter() - t1
    winners = list(sweep.best_schedule_per_delay(pres))
    if (len(pres.schedules) != ref["placed"]["n_points"]
            or winners != ref["placed"]["winners"]):
        raise AssertionError(f"placed tuner winners {winners}")
    np.testing.assert_allclose(pres.mean_span.min(dim=0).values.tolist(),
                               ref["placed"]["mean_span"], rtol=1e-6)
    emit({"phase": "tuner", "grid": list(wres.span_cycles.shape),
          "pe_lanes": lanes,
          "winners": {p.kernel: p.schedule.name for p in points},
          "per_delay": [p.schedule.name for p in per_delay],
          "placed_winners": winners, "c6": True,
          "sweep_workloads_wall_s": wall, "placed_wall_s": placed_wall,
          "wall_s": time.perf_counter() - t0})


def phase_fig7_tuned(torch, fiveg, prng, ref_values) -> None:
    ref = ref_values["fig7_tuned"]
    for row in ref["rows"]:
        app = fiveg.FiveGConfig(n_rx=row["n_rx"],
                                ffts_per_round=row["ffts_per_round"])
        walls, got = {}, {}
        for mode in TUNED_MODES:
            t0 = time.perf_counter()
            res = fiveg.simulate_app(prng.PRNGKey(ref["key"]), app,
                                     sync=mode, device="cuda")
            torch.cuda.synchronize()
            walls[mode] = time.perf_counter() - t0
            want = row[mode]
            names = (res.stage_schedule, res.global_schedule)
            if names != (want["stage_schedule"], want["global_schedule"]):
                raise AssertionError(f"Fig. 7 {mode}: schedules {names}")
            if res.total_cycles.item() != np.float32(want["total_cycles"]):
                raise AssertionError(
                    f"Fig. 7 {row['n_rx']}/{row['ffts_per_round']} {mode}: "
                    f"total_cycles {res.total_cycles.item()} != "
                    f"{want['total_cycles']}")
            for c in ("sync_fraction", "sync_energy"):
                np.testing.assert_allclose(getattr(res, c).item(), want[c],
                                           rtol=1e-5)
            got[mode] = {"total_cycles": res.total_cycles.item(),
                         "stage": names[0], "global": names[1]}
        emit({"phase": "fig7_tuned", "n_rx": row["n_rx"],
              "ffts_per_round": row["ffts_per_round"], "modes": got,
              "wall_s": walls})


def phase_normal(torch, prng, ref_values) -> None:
    t0 = time.perf_counter()
    ref = ref_values["normal_sample"]
    want = torch.tensor(ref["values"], dtype=torch.float32)
    got = prng.normal(prng.PRNGKey(ref["key"]), want.shape).cpu()
    ulps = (got.view(torch.int32).long()
            - want.view(torch.int32).long()).abs()
    emit({"phase": "normal", "n": want.numel(),
          "max_ulp_gap": ulps.max().item(),
          "draws_off": int((ulps > 0).sum().item()),
          "wall_s": time.perf_counter() - t0})
    if ulps.max().item() != 0:
        raise AssertionError("prng.normal on the card differs from the "
                             "JAX draws")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    from repro_torch.core import (barrier, barrier_sim, fiveg, placement,
                                  prng, sweep, tuning, workloads)
    from repro_torch.examples import fiveg_pipeline
    from repro_torch.kernels import _build, axpy, dotp, fft4, matmul, ops, ref

    ref_values = json.loads(
        (ROOT / "src" / "repro_torch" / "reference_values.json").read_text())
    phase_info(torch, _build)
    summary = phase_kernels(torch, ops, fft4, matmul, ref)
    launches = phase_pipeline(torch, fiveg_pipeline, fft4, matmul)
    phase_fig4a(torch, barrier, barrier_sim, prng, sweep, ref_values)
    phase_fig7(torch, fiveg, prng, ref_values)
    more, more_launches = phase_dotp_axpy(torch, ops, dotp, axpy, ref)
    summary.update(more)
    launches.update(more_launches)
    phase_fig5(torch, prng, workloads, ref_values)
    phase_fig6(torch, barrier, prng, sweep, workloads, ref_values)
    phase_tuner(torch, placement, prng, sweep, tuning, ref_values)
    phase_fig7_tuned(torch, fiveg, prng, ref_values)
    phase_normal(torch, prng, ref_values)

    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": summary[name]["max_abs_err"],
         "ms": summary[name]["ms"], "plain_ms": summary[name]["plain_ms"],
         "bound_ms": summary[name]["bound_ms"],
         "bound_by": summary[name]["bound_by"],
         "library_ms": summary[name]["library_ms"],
         "shape": summary[name].get("shape", summary[name].get("n")),
         "unit": summary[name].get("unit", "one launch")}
        for name in KERNELS]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
