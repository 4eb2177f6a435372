"""Where the main path's time goes on the GPU: host wall time against
device busy time and kernel launches, for one Fig. 7 simulation per
sync mode, the Fig. 4a sweep and the 5G slot pipeline.

    PYTHONPATH=src python -m repro_torch.examples.profile_main_path

Prints one JSON line per run.  ``wall_s`` is a synchronized host-clock
run without the profiler; ``device_busy_s`` and ``kernel_launches`` come
from a second run under ``torch.profiler`` (the sum of the kernels'
device time and their count); ``idle_share`` is ``1 - busy / wall``.
"""
from __future__ import annotations

import json
import time

import torch
from torch.autograd import DeviceType

from repro_torch.core import fiveg, prng, sweep
from repro_torch.examples import fiveg_pipeline


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


if __name__ == "__main__":
    main()
