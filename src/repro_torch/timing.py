"""Timing on the card and the least time it could take: the helpers that
``chip_smoke.py``, ``examples/kernel_times.py`` and the benchmark drivers
share.

Device time is a CUDA graph of calls timed as one replay
(:func:`graph_ms`), so the host's launch cost drops out; eager time
(:func:`cuda_ms`) is the same calls issued one by one from Python.  The
bound (:func:`bound`) uses the H100 SXM data sheet's peaks.  The
drivers' simulations are timed whole on the host's clock
(:func:`wall_us`).
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bandwidth,
# float32 outside the tensor cores, bf16 in the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {"float32": 67e12, "bfloat16": 989e12,
                "float64": 34e12}   # float64 outside the tensor cores
L2_BYTES = 50e6
# H100 SXM double precision outside the tensor cores, in instructions: 64
# a clock per SM on the FP64 pipe (a fused multiply-add counts once), 16
# a clock per SM for conversions to or from 64-bit types (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute
# capability 9.0), at the 1.98 GHz boost clock.
FP64_INSTR_S = 132 * 64 * 1.98e9
F64_CONVERSIONS_S = 132 * 16 * 1.98e9
# H100 SXM special-function unit (MUFU) results, such as the ex2 of an
# exponential: 16 a clock per SM (the same guide's table), at the 1.98
# GHz boost clock.
MUFU_S = 132 * 16 * 1.98e9


def cuda_ms(fn, inputs, iters: int = 20, warmup: int = 3) -> float:
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


def wall_us(fn, device, *, iters: int = 3, warmup: int = 1) -> tuple:
    """Host wall microseconds of ``fn()``, the device drained after each
    call: ``(result, steady_us, first_us)``, the mean of ``iters`` calls
    after ``warmup`` more calls, and the first call alone (which also
    pays the table caches and torch's first use of each operation)."""
    def drain():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    result = fn()
    drain()
    first_us = (time.perf_counter() - t0) * 1e6
    for _ in range(warmup):
        fn()
        drain()
    t0 = time.perf_counter()
    for _ in range(iters):
        result = fn()
        drain()
    return result, (time.perf_counter() - t0) * 1e6 / iters, first_us


def cold_copies(*tensors) -> list:
    """Enough copies of the argument tuple that cycling through them
    streams more than twice the H100's 50 MB L2 cache, so each timed
    call reads its inputs from device memory, as the bound assumes."""
    size = sum(t.numel() * t.element_size() for t in tensors)
    count = min(8, max(1, math.ceil(2 * L2_BYTES / size)))
    return [tensors] + [tuple(t.clone() for t in tensors)
                        for _ in range(count - 1)]


def graph_ms(fn, inputs, iters: int = 20) -> float:
    """Mean device milliseconds per call of ``fn``: ``iters`` calls
    cycling through ``inputs``, captured once in a CUDA graph and timed
    as one replay, so the host's launch cost between calls drops out."""
    for args in inputs:                  # warm caches and lazy set-up
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*inputs[i % len(inputs)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(fn, library, inputs) -> dict:
    """``fn`` and ``library`` on the same inputs in device time
    (:func:`graph_ms` in turns: fn, library, library, fn; each mean of
    two) and eagerly (:func:`cuda_ms`): the fields of a graph-timed
    kernel record."""
    g = [graph_ms(f, inputs) for f in (fn, library, library, fn)]
    return {"timing": "graph", "ms": (g[0] + g[3]) / 2,
            "library_ms": (g[1] + g[2]) / 2, "runs_ms": [g[0], g[3]],
            "library_runs_ms": [g[1], g[2]],
            "eager_ms": cuda_ms(fn, inputs),
            "library_eager_ms": cuda_ms(library, inputs)}


def bound(bytes_moved: float, flops: float, dtype: str) -> tuple:
    """The least milliseconds the card could take to move ``bytes_moved``
    and do ``flops`` operations of ``dtype``, and which of the two sets
    it: ``(ms, "bytes" | "operations")``."""
    t_bytes = bytes_moved / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fp64_bound(bytes_moved: float, fp64: float, conversions: float) -> dict:
    """The bound of an FP64 kernel: the bytes over the memory rate, the
    FP64-pipe instructions plus the 64-bit conversions over their
    rates, and the larger of the two (``bound_ms``, ``bound_by``)."""
    t_bytes = bytes_moved / PEAK_BYTES_S * 1e3
    t_ops = (fp64 / FP64_INSTR_S + conversions / F64_CONVERSIONS_S) * 1e3
    return {"bytes_bound_ms": t_bytes, "fp64_bound_ms": t_ops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def matmul_work(m: int, k: int, n: int, itemsize: int) -> tuple:
    """Bytes and operations of ``x (m, k) @ w (k, n)``: both inputs read
    once in their dtype, the float32 output written once."""
    return (m * k + k * n) * itemsize + m * n * 4, 2.0 * m * n * k


def fft_work(rows: int, n: int) -> tuple:
    """Bytes and operations of ``ops.fft4`` over (rows, n) float32 planes:
    both planes read and written once, the fused kernel's twiddles read
    once; 34 operations a radix-4 butterfly, n / 4 butterflies a stage
    and row."""
    return (4 * rows * n * 4 + 2 * (n - 1) * 4,
            round(math.log(n, 4)) * rows * (n // 4) * 34.0)


def slot_work(rows: int, n: int, n_beams: int, n_rx: int) -> tuple:
    """Bytes and operations of one 5G slot: the FFT over (rows, n) and
    the two float32 products (n_beams, n_rx) @ (n_rx, rows * n / n_rx)."""
    fft_b, fft_f = fft_work(rows, n)
    mm_b, mm_f = matmul_work(n_beams, n_rx, rows * n // n_rx, 4)
    return fft_b + 2 * mm_b, fft_f + 2 * mm_f


def attention_work(b: int, h: int, hk: int, s: int, t: int, d: int,
                   causal: bool, itemsize: int, dv: int = None,
                   window: int = 0) -> tuple:
    """Bytes and operations of attention over q (b, h, s, d), k (b, hk,
    t, d) and v (b, hk, t, dv) (``dv`` defaults to ``d``): q, k and v
    read once and the (b, h, s, dv) output written once in their dtype;
    2 d operations (QK^T) and 2 dv (PV) for each (query, key) pair the
    mask keeps (causal: key t' <= query s'; a sliding ``window > 0``:
    s' - t' < window)."""
    dv = d if dv is None else dv
    rows = np.arange(s, dtype=np.int64)
    hi = np.minimum(rows, t - 1) if causal else np.full(s, t - 1)
    lo = np.maximum(rows - window + 1, 0) if window > 0 else 0
    pairs = float(np.maximum(hi - lo + 1, 0).sum())
    return (itemsize * (b * h * s * (d + dv) + b * hk * t * (d + dv)),
            2.0 * b * h * (d + dv) * pairs)


def attention_bwd_work(b: int, h: int, hk: int, s: int, t: int, d: int,
                       causal: bool, itemsize: int, dv: int = None,
                       window: int = 0) -> tuple:
    """Bytes and operations of attention's backward over q (b, h, s, d),
    k (b, hk, t, d), v (b, hk, t, dv), the output and its gradient (b, h,
    s, dv) (``dv`` defaults to ``d``): q, k, v, out and dO read once and
    dq, dk, dv written once in their dtype, the float32 (b, h, s) lse read
    once; five products a pair the mask keeps (under a sliding ``window``
    too; S = QK^T and dQ, dK over d, dP = dO V^T and dV over dv): 2 (3 d +
    2 dv) operations."""
    dv = d if dv is None else dv
    _, fwd = attention_work(b, h, hk, s, t, d, causal, itemsize, dv=dv,
                            window=window)
    pairs = fwd / (2.0 * b * h * (d + dv))
    return (itemsize * (2 * b * h * s * (d + dv) + 2 * b * hk * t * (d + dv))
            + 4.0 * b * h * s, 2.0 * b * h * (3 * d + 2 * dv) * pairs)


def attention_bwd_prepass_bytes(b: int, h: int, s: int, dv: int,
                                itemsize: int) -> float:
    """Bytes of the backward's pre-pass over (b, h, s) rows: the output
    and its gradient (b, h, s, dv) read once in their dtype, the float32
    lse read once, and each row's record (lse times log2 e and delta, two
    float32) written once."""
    return itemsize * 2.0 * b * h * s * dv + 12.0 * b * h * s


def sdpa_backend(q, k, v, causal: bool, attn_mask=None) -> str:
    """The backend that ``F.scaled_dot_product_attention`` picks for these
    operands (``torch._fused_sdp_choice``, with ``attn_mask`` where the
    call passes one), by name."""
    from torch.nn.attention import SDPBackend
    choice = torch._fused_sdp_choice(q, k, v, attn_mask, 0.0, causal,
                                     enable_gqa=True)
    names = {int(b.value): b.name for b in SDPBackend.__members__.values()}
    return names.get(int(choice), f"unknown ({choice})")


def scan_work(b: int, s: int, di: int, n: int) -> tuple:
    """Bytes and exponentials of the selective scan over (b, s, di)
    float32 inputs with n states: dt and x read and y written once, B
    and C (b, s, n) read once, A (di, n) and D (di,) read once, the start
    and final states (b, di, n) read and written once; one exponential
    (a MUFU ex2) for each of the b s di n decays."""
    return (4.0 * (3 * b * s * di + 2 * b * s * n + di * n + di
                   + 2 * b * di * n),
            float(b) * s * di * n)


def scan_bound(b: int, s: int, di: int, n: int) -> dict:
    """The scan's bound: its bytes over the memory rate, its
    exponentials over the MUFU rate, and the larger of the two
    (``bound_ms``, ``bound_by``: ``"bytes"`` or ``"operations"``)."""
    return _mufu_bound(*scan_work(b, s, di, n))


def _mufu_bound(bytes_moved: float, exps: float) -> dict:
    t_bytes = bytes_moved / PEAK_BYTES_S * 1e3
    t_ops = exps / MUFU_S * 1e3
    return {"bytes_bound_ms": t_bytes, "mufu_bound_ms": t_ops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def scan_bwd_work(b: int, s: int, di: int, n: int) -> tuple:
    """Bytes and exponentials of the selective scan's gradient over (b, s,
    di) float32 inputs with n states: dt, x and dy read and d(dt), dx
    written once, B and C read and dB, dC written once (b, s, n), A and
    dA (di, n), D and dD (di,), h0 read and dh0 written (b, di, n) once
    (the final state's gradient absent, as in training); one exponential
    for each of the b s di n decays, as the forward (the kernel's
    recomputation of the states from its checkpoints is its own cost)."""
    return (4.0 * (5 * b * s * di + 4 * b * s * n + 2 * di * n + 2 * di
                   + 2 * b * di * n),
            float(b) * s * di * n)


def scan_bwd_bound(b: int, s: int, di: int, n: int) -> dict:
    """:func:`scan_bound` of :func:`scan_bwd_work`."""
    return _mufu_bound(*scan_bwd_work(b, s, di, n))


def fft_stage_work(rows: int, n: int) -> tuple:
    """Bytes and operations of the lead ``fft4_stage`` launch (stage 0)
    over (rows, n) float32 planes: both planes read and written once, the
    stage's two (3, n / 4) twiddle planes read once; n / 4 butterflies of
    34 operations a row."""
    return 4 * rows * n * 4 + 2 * 3 * (n // 4) * 4, rows * (n // 4) * 34.0
