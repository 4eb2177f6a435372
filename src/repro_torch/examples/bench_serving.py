"""Serving benchmark on an NVIDIA GPU: what the tuning-serving daemon
adds on top of the raw sweep, and what request coalescing buys back;
the port's counterpart of ``benchmarks/bench_serving.py``, with its
sizes (N = 1024, 8 requests of 4 trials, a 5 ms coalescing window) and
record keys.

* **Tail latency** — p50/p99 wall time of a tuning request served end to
  end through :class:`repro_torch.runtime.serving.TuningServer` (submit
  -> coalescing window -> batched dispatch -> response) against the raw
  unbatched :func:`repro_torch.core.sweep.sweep_arrivals` it wraps,
  interleaved, each window closed by a device synchronize.  Every
  request is a fresh trace, so each response is exact.  The reference's
  bar is p99 added latency <= 10 % over the raw sweep
  (``accept_added_p99_le_10pct``, reported as measured).
* **Batching efficiency** — the same number of requests submitted
  before the worker starts coalesce into one dispatch: requests per
  dispatch and the amortized latency.
* **Degraded floor** — how fast the closed-form fallback answers an
  already-expired deadline.

Traces are 300 x uniform draws under ``fold_in(PRNGKey(0), i)``, made on
the device before any timed window.  Walls are host seconds; numbers
are kept unrounded.

    PYTHONPATH=src python -m repro_torch.examples.bench_serving \
        [--device cpu] [--n 1024] [--out build/BENCH_torch_serving.json]
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import prng, sweep, tuning
from repro_torch.core.topology import DEFAULT, TeraPoolConfig
from repro_torch.examples.figure_rows import card, write_record
from repro_torch.runtime.serving import (BATCHED, DEGRADED, ServerConfig,
                                         ServerStats, TuneRequest,
                                         TuningServer, fallback_uniform)

KEY = 0
N = 1024
N_REQUESTS = 8
N_TRIALS = 4
BATCH_WINDOW = 0.005
OUT = Path("build") / "BENCH_torch_serving.json"


def _cfg(n: int) -> TeraPoolConfig:
    return DEFAULT if n == DEFAULT.n_pes else TeraPoolConfig(n_pes=n)


def _pct(xs, q) -> float:
    return float(np.percentile(np.asarray(xs), q))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _expect(resp, provenance: str) -> None:
    if resp.provenance != provenance:
        raise RuntimeError(f"expected a {provenance} response, got {resp}")


def measure(device="cuda", n: int = N) -> dict:
    """The benchmark's record (its keys are the reference file's)."""
    dev = resolve_device(device)
    cfg = _cfg(n)
    key = prng.PRNGKey(KEY, device=dev)
    prune = "none" if n <= 256 else "hierarchy"
    scheds = tuning.all_schedules(n, cfg, prune=prune)

    def server(**kw) -> TuningServer:
        kw.setdefault("batch_window", BATCH_WINDOW)
        return TuningServer(ServerConfig(default_n_trials=N_TRIALS, **kw),
                            start=False, device=dev)

    def trace(i: int) -> torch.Tensor:
        return 300.0 * prng.uniform(prng.fold_in(key, i), (N_TRIALS, n))

    def batch(traces) -> ServerStats:
        srv = server(batch_window=0.05, max_batch=N_REQUESTS)
        try:
            tickets = [srv.submit(TuneRequest(arrivals=t)) for t in traces]
            srv.start()
            for t in tickets:
                _expect(t.result(timeout=3600), BATCHED)
        finally:
            srv.close()
        return srv.stats

    # Every trace is drawn before any timed (or coalescing) window.
    raw_traces = [trace(100 + i) for i in range(N_REQUESTS)]
    seq_traces = [trace(200 + i) for i in range(N_REQUESTS)]
    batch_traces = [trace(300 + i) for i in range(N_REQUESTS)]
    _sync(dev)

    # Warm both dispatch shapes: the single request through the server
    # and the N_REQUESTS-kernel stack.
    sweep.sweep_arrivals(trace(0), scheds, cfg)
    sweep.sweep_arrivals(torch.stack([trace(1000 + i)
                                      for i in range(N_REQUESTS)]),
                         scheds, cfg)
    with server() as srv:
        _expect(srv.tune(TuneRequest(arrivals=trace(999)), timeout=3600),
                BATCHED)
    batch([trace(1100 + i) for i in range(N_REQUESTS)])
    _sync(dev)

    # Tail latency, raw against served, interleaved so host jitter lands
    # on both alike.
    raw_s, serve_s = [], []
    with server() as srv:
        for raw_trace, seq_trace in zip(raw_traces, seq_traces):
            t0 = time.perf_counter()
            sweep.sweep_arrivals(raw_trace, scheds, cfg)
            _sync(dev)
            raw_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            resp = srv.tune(TuneRequest(arrivals=seq_trace), timeout=3600)
            _sync(dev)
            serve_s.append(time.perf_counter() - t0)
            _expect(resp, BATCHED)
        seq_stats = srv.stats
    raw_med, raw_p99 = _pct(raw_s, 50), _pct(raw_s, 99)
    p50, p99 = _pct(serve_s, 50), _pct(serve_s, 99)
    added_p99 = 100.0 * (p99 - raw_p99) / raw_p99

    # Batching efficiency: the whole load queued before the worker starts.
    t0 = time.perf_counter()
    stats = batch(batch_traces)
    _sync(dev)
    batch_wall = time.perf_counter() - t0

    # Degradation floor: an expired deadline answers from the
    # closed-form model without touching the sweep.
    with server() as srv:
        t0 = time.perf_counter()
        resp = srv.tune(TuneRequest(arrivals=trace(400), deadline=0.0),
                        timeout=60)
        degraded_s = time.perf_counter() - t0
        _expect(resp, DEGRADED)
    fallback_uniform(n, cfg)

    return {
        "device": card(dev),
        "n_pes": n,
        "n_requests": N_REQUESTS,
        "n_schedules": len(scheds),
        "raw_sweep_us": raw_med * 1e6,
        "raw_p99_us": raw_p99 * 1e6,
        "serve_p50_us": p50 * 1e6,
        "serve_p99_us": p99 * 1e6,
        "added_p99_pct": added_p99,
        "accept_added_p99_le_10pct": bool(added_p99 <= 10.0),
        "batch_wall_us": batch_wall * 1e6,
        "batch_amortized_us": batch_wall / N_REQUESTS * 1e6,
        "batch_efficiency_req_per_dispatch": stats.batch_efficiency,
        "batch_speedup_vs_sequential": float(np.sum(serve_s)) / batch_wall,
        "degraded_floor_us": degraded_s * 1e6,
        "sequential_stats": {"batches": seq_stats.batches,
                             "exact": seq_stats.exact,
                             "cache_hits": seq_stats.cache_hits},
    }


def rows(record: dict) -> list:
    """The reference benchmark's rows ``(name, us, derived, first_us)``."""
    n = record["n_pes"]
    return [
        (f"serving_raw_N{n}", record["raw_sweep_us"],
         f"{record['n_schedules']}sched", 0.0),
        (f"serving_p99_N{n}", record["serve_p99_us"],
         f"added={record['added_p99_pct']:.1f}%", 0.0),
        (f"serving_batched_N{n}", record["batch_amortized_us"],
         f"eff={record['batch_efficiency_req_per_dispatch']:.1f}"
         f"req/dispatch", 0.0),
        (f"serving_degraded_N{n}", record["degraded_floor_us"],
         "tier=fallback", 0.0)]


def run(device="cuda") -> list:
    """Measure at the reference's sizes, write the record to
    :data:`OUT` and return the rows."""
    return rows(write_record(measure(device, N), OUT))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args(argv)
    record = write_record(measure(args.device, args.n), args.out)
    print(json.dumps({"serving": record}), flush=True)
    return record


if __name__ == "__main__":
    main()
