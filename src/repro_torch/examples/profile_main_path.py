"""Where the main path's time goes on the GPU: host wall time against
device busy time and kernel launches, for one Fig. 7 simulation per
sync mode, the Fig. 4a sweep, the 5G slot pipeline and the tuner's
workload sweep; and whether the profiler counts the hand-written
kernels' launches as their wrappers do.

    PYTHONPATH=src python -m repro_torch.examples.profile_main_path

Prints one JSON line per run.  ``wall_s`` is a synchronized host-clock
run without the profiler; ``device_busy_s`` and ``kernel_launches`` come
from a second run under ``torch.profiler`` (the sum of the kernels'
device time and their count); ``idle_share`` is ``1 - busy / wall``.
The ``launch_counts`` lines set, for one traced call each of the 5G
slot pipeline, the ``ops.dotp`` chain at three radices and ``ops.axpy``,
the wrappers' counters beside the profiler's count of each kernel, from
its aggregated table and from its raw event list.
"""
from __future__ import annotations

import json
import time

import torch
from torch.autograd import DeviceType

from repro_torch.core import fiveg, prng, sweep, tuning
from repro_torch.examples import fiveg_pipeline
from repro_torch.kernels import axpy, dotp, fft4, matmul, ops

# Profiler kernel name fragment -> wrapper counter of that kernel.
KERNEL_NAMES = {"fft4_stage_kernel": "fft4_stage", "mm_kernel": "matmul",
                "partials_kernel": "dotp_partials",
                "central_kernel": "dotp_central",
                "combine_kernel": "combine_partials",
                "axpy_kernel": "axpy"}


def _counters() -> dict:
    return dict(dotp.LAUNCHES, fft4_stage=fft4.LAUNCHES,
                matmul=matmul.LAUNCHES, axpy=axpy.LAUNCHES)


def launch_counts(fn) -> dict:
    """One warm call of ``fn``, then one traced call: the wrappers'
    launch counts of the traced call against the profiler's counts per
    kernel, from ``key_averages()`` and from ``events()``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    before = _counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    after = _counters()
    wrappers = {k: after[k] - before[k] for k in after
                if after[k] != before[k]}

    def by_kernel(pairs):
        out = {}
        for key, count in pairs:
            for frag, name in KERNEL_NAMES.items():
                if frag in key:
                    out[name] = out.get(name, 0) + count
        return out

    averages = [(e.key, e.count) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
    events = [(e.name, 1) for e in prof.events()
              if e.device_type == DeviceType.CUDA]
    return {"wrapper_launches": wrappers,
            "profiler_key_averages": by_kernel(averages),
            "profiler_events": by_kernel(events)}


def profile_run(fn) -> dict:
    """Warm ``fn`` up, time one run, then trace a second one."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]
    return {"wall_s": wall, "device_busy_s": busy,
            "idle_share": 1.0 - busy / wall,
            "kernel_launches": sum(e.count for e in kernels),
            "top_kernels": [[e.key[:70], e.count,
                             e.self_device_time_total / 1e3] for e in top]}


def main(device="cuda") -> None:
    print(json.dumps({"device": torch.cuda.get_device_name(0)}))
    app = fiveg.FiveGConfig(n_rx=16, ffts_per_round=1)
    barriers = app.rounds * app.n_stages + 2
    for mode in ("central", "tree", "partial", "hw"):
        rec = profile_run(lambda: fiveg.simulate_app(
            prng.PRNGKey(3, device=device), app, sync=mode, device=device))
        print(json.dumps({"run": f"simulate_app {mode} (16, 1)",
                          "barriers": barriers,
                          "launches_per_barrier":
                              rec["kernel_launches"] / barriers, **rec}))
    rec = profile_run(lambda: sweep.sweep_barrier(
        prng.PRNGKey(0, device=device), n_pes=1024, n_trials=1024,
        trial_chunk=256, device=device))
    print(json.dumps({"run": "sweep_barrier 10x4x1024 N=1024", **rec}))
    rec = profile_run(lambda: fiveg_pipeline.execute(device=device))
    print(json.dumps({"run": "fiveg_pipeline.execute (896x4096 slot)",
                      **rec}))
    rec = profile_run(lambda: tuning.sweep_workloads(
        prng.PRNGKey(0, device=device), n_trials=4))
    print(json.dumps({"run": "sweep_workloads 512x15x4 N=1024", **rec}))

    print(json.dumps({"run": "launch_counts fiveg_pipeline.execute",
                      **launch_counts(lambda: fiveg_pipeline.execute(
                          device=device))}))
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(1 << 26, device=device, generator=gen)
    y = torch.randn(1 << 26, device=device, generator=gen)
    for radix in (0, 2, 1024):
        print(json.dumps({"run": f"launch_counts ops.dotp 64Mi radix "
                                 f"{radix}",
                          "expected": 1 + ops.dotp_levels(x.numel(), radix),
                          **launch_counts(lambda: ops.dotp(x, y,
                                                           radix=radix))}))
    print(json.dumps({"run": "launch_counts ops.axpy 64Mi",
                      **launch_counts(lambda: ops.axpy(1.7, x, y))}))


if __name__ == "__main__":
    main()
