"""Where the main path's time goes on the GPU: host wall time against
device busy time and kernel launches, for one Fig. 7 simulation per
sync mode (and two under PE failures), the Fig. 4a sweep, the fault
degradation sweep, the 5G slot pipeline (with its numpy inputs made
inside, and its device work alone on resident inputs) and the tuner's
workload sweep;
whether the profiler counts the hand-written kernels' launches as their
wrappers do; and full-width Qwen3-4B serving: one prefill of 4 x 2048
tokens and 8 decode steps of batch 4.

    PYTHONPATH=src python -m repro_torch.examples.profile_main_path
    PYTHONPATH=src python -m repro_torch.examples.profile_main_path --only serve

Prints one JSON line per run.  ``wall_s`` is a synchronized host-clock
run without the profiler; ``device_busy_s`` and ``kernel_launches`` come
from a second run under ``torch.profiler`` (the sum of the kernels'
device time and their count); ``idle_share`` is ``1 - busy / wall``.
The ``launch_counts`` lines set, for one traced call each of the 5G
slot pipeline, the ``ops.dotp`` chain at three radices and ``ops.axpy``,
the wrappers' counters beside the profiler's count of each kernel, from
its aggregated table and from its raw event list.

``--only serve_mla`` profiles DeepSeek-V3 instead of Qwen3-4B, at its
published widths with its depth cut to 4 layers (3 dense, 1 MoE layer
of 256 experts: the 15.8 B parameters ``chip_smoke.py`` serves), the
same prefill and decode steps; ``--only serve_hybrid`` full-width
Hymba-1.5B (32 layers of window-1024 attention beside a Mamba block) and
``--only serve_ssm`` full-width Falcon-Mamba-7B (64 Mamba layers);
``--only serve_ssm,serve_hybrid`` profiles both in one process.

``--only train`` profiles the training step at full width (Qwen3-4B's
published widths, depth cut to 12 layers, 8 micro-batches of 2048
tokens, remat, AdamW, as ``chip_smoke.py`` trains it): one traced step's
device time by kind (the attention kernels forward and backward, GEMMs,
elementwise and reduction passes, the rest) with the step's busy and
idle share (against that traced step's own wall time,
``traced_wall_s``), and the optimizer update traced alone.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch
from torch.autograd import DeviceType

from repro_torch import configs, optim
from repro_torch.core import fiveg, prng, sweep, tuning
from repro_torch.data import DataConfig, batch_for_model
from repro_torch.examples import bench_faults, fiveg_pipeline, serve_lm
from repro_torch.kernels import (axpy, conv2d, dct, dotp, fft4, flash_attn,
                                 flash_attn_bwd, matmul, ops, powf, ssm_scan)
from repro_torch.launch import steps
from repro_torch.models import init_params
from repro_torch.models.layers import tree_map

# Profiler kernel name fragment -> wrapper counter of that kernel.
KERNEL_NAMES = {"fft4_stage_kernel": "fft4_stage",
                "fft4_fused_kernel": "fft4_fused", "mm_kernel": "matmul",
                "partials_kernel": "dotp_partials",
                "central_kernel": "dotp_central",
                "combine_kernel": "combine_partials",
                "combine_tree_kernel": "combine_tree",
                "axpy_kernel": "axpy", "dct_kernel": "dct",
                "conv2d_kernel": "conv2d", "powf_kernel": "powf",
                "fa_wgmma_kernel": "flash_attention",
                "fa_mma_kernel": "flash_attention",
                "fa_fma_kernel": "flash_attention",
                "ssm_scan_kernel": "ssm_scan"}


def _counters() -> dict:
    return dict(dotp.LAUNCHES, fft4_stage=fft4.LAUNCHES,
                fft4_fused=fft4.FUSED_LAUNCHES,
                matmul=matmul.LAUNCHES, axpy=axpy.LAUNCHES,
                dct=dct.LAUNCHES, conv2d=conv2d.LAUNCHES,
                powf=powf.LAUNCHES, flash_attention=flash_attn.LAUNCHES,
                ssm_scan=ssm_scan.LAUNCHES)


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
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    return {"wall_s": wall, "device_busy_s": busy,
            "idle_share": 1.0 - busy / wall,
            "kernel_launches": sum(e.count for e in kernels),
            "top_kernels": [[e.key[:70], e.count,
                             e.self_device_time_total / 1e3] for e in top]}


# The model each serve profile runs: full-width Qwen3-4B, DeepSeek-V3 at
# its published widths 4 layers deep, full-width Hymba-1.5B and
# Falcon-Mamba-7B.
SERVE_MODELS = {
    "serve": ("qwen3-4b", lambda: configs.get("qwen3_4b")),
    "serve_mla": ("deepseek-v3 4 layers", lambda: dataclasses.replace(
        configs.get("deepseek_v3_671b"), n_layers=4)),
    "serve_hybrid": ("hymba-1.5b", lambda: configs.get("hymba_1_5b")),
    "serve_ssm": ("falcon-mamba-7b", lambda: configs.get("falcon_mamba_7b")),
}


def profile_serve(device="cuda", n_steps: int = 8, which="serve") -> None:
    """One of :data:`SERVE_MODELS` (weights from the port's init): one
    prefill of 4 x 2048 tokens, then ``n_steps`` decode steps of batch
    4."""
    name, make_cfg = SERVE_MODELS[which]
    cfg = make_cfg()
    params = init_params(cfg, prng.PRNGKey(0, device=device))
    batch, length = 4, 2048
    prefill, _ = steps.build_prefill_step(cfg, batch=batch, seq_len=length,
                                          device=device)
    decode, _ = steps.build_decode_step(cfg, batch=batch, max_len=length,
                                        device=device)
    toks = torch.from_numpy(serve_lm.prompts(cfg, batch, length)).to(device)
    rec = profile_run(lambda: prefill(params, {"tokens": toks}))
    print(json.dumps({"run": f"prefill {name} 4x2048", **rec}))
    logits, caches = prefill(params, {"tokens": toks})
    tok = logits[:, -1].argmax(-1)[:, None]
    pos = torch.full((batch,), length - 32, dtype=torch.int32, device=device)

    def decode_steps():
        for i in range(n_steps):
            decode(params, caches, tok, pos + i)

    rec = profile_run(decode_steps)
    print(json.dumps({"run": f"decode {name} batch 4, {n_steps} steps",
                      "launches_per_step": rec["kernel_launches"] / n_steps,
                      "wall_s_per_step": rec["wall_s"] / n_steps, **rec}))
    print(json.dumps({"run": f"launch_counts prefill {name} 4x2048",
                      "expected": {
                          "flash_attention": 0 if cfg.family == "ssm"
                          else cfg.n_layers,
                          "ssm_scan": cfg.n_layers if cfg.has_ssm else 0},
                      **launch_counts(lambda: prefill(params,
                                                      {"tokens": toks}))}))


def profile_simulator(device="cuda") -> None:
    app = fiveg.FiveGConfig(n_rx=16, ffts_per_round=1)
    barriers = app.rounds * app.n_stages + 2
    for mode in ("central", "tree", "partial", "hw"):
        rec = profile_run(lambda: fiveg.simulate_app(
            prng.PRNGKey(3, device=device), app, sync=mode, device=device))
        print(json.dumps({"run": f"simulate_app {mode} (16, 1)",
                          "barriers": barriers,
                          "launches_per_barrier":
                              rec["kernel_launches"] / barriers, **rec}))
    faults = fiveg.FiveGFaults(fail_rate=0.02, timeout_cycles=2000.0,
                               quorum_frac=0.95, seed=3)
    for mode in ("central", "tree"):
        rec = profile_run(lambda: fiveg.simulate_app(
            prng.PRNGKey(3, device=device), app, sync=mode, faults=faults,
            device=device))
        print(json.dumps({"run": f"simulate_app {mode} (16, 1), 2 % of "
                                 f"PEs failed",
                          "barriers": barriers,
                          "launches_per_barrier":
                              rec["kernel_launches"] / barriers, **rec}))
    rec = profile_run(lambda: bench_faults.degradation_sweep(device=device))
    print(json.dumps({"run": "bench_faults.degradation_sweep 130x5x64 "
                             "N=1024", **rec}))
    rec = profile_run(lambda: sweep.sweep_barrier(
        prng.PRNGKey(0, device=device), n_pes=1024, n_trials=1024,
        trial_chunk=256, device=device))
    print(json.dumps({"run": "sweep_barrier 10x4x1024 N=1024", **rec}))
    rec = profile_run(lambda: fiveg_pipeline.execute(device=device))
    print(json.dumps({"run": "fiveg_pipeline.execute (896x4096 slot, "
                             "numpy input generation included)", **rec}))
    resident = [torch.from_numpy(a).to(device)
                for a in fiveg_pipeline.make_inputs()]
    rec = profile_run(lambda: fiveg_pipeline.slot(*resident))
    print(json.dumps({"run": "fiveg_pipeline.slot (896x4096, inputs on "
                             "the device)", **rec}))
    rec = profile_run(lambda: tuning.sweep_workloads(
        prng.PRNGKey(0, device=device), n_trials=4))
    print(json.dumps({"run": "sweep_workloads 512x15x4 N=1024", **rec}))

    print(json.dumps({"run": "launch_counts fiveg_pipeline.slot",
                      **launch_counts(lambda: fiveg_pipeline.slot(
                          *resident))}))
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(1 << 26, device=device, generator=gen)
    y = torch.randn(1 << 26, device=device, generator=gen)
    for radix in (0, 2, 1024):
        print(json.dumps({"run": f"launch_counts ops.dotp 64Mi radix "
                                 f"{radix}",
                          "expected": 1 if radix <= 1 else 2,
                          **launch_counts(lambda: ops.dotp(x, y,
                                                           radix=radix))}))
    print(json.dumps({"run": "launch_counts ops.axpy 64Mi",
                      **launch_counts(lambda: ops.axpy(1.7, x, y))}))


# Profiler kernel name fragments of each kind of device work in a
# training step (matched in order; anything else is "other").
KINDS = (("attention_forward", ("fa_wgmma_kernel", "fa_mma_kernel",
                                "fa_fma_kernel")),
         ("attention_backward", ("bwd_dkdv", "bwd_dq", "bwd_delta")),
         ("gemm", ("gemm", "nvjet", "cutlass", "xmma", "sm90_")),
         ("elementwise", ("elementwise", "vectorized", "reduce", "softmax",
                          "cat", "copy", "fill", "index", "gather",
                          "scatter", "norm")))


def _kind(name: str) -> str:
    low = name.lower()
    for kind, frags in KINDS:
        if any(f in low for f in frags):
            return kind
    return "other"


def _traced(fn) -> dict:
    """One warm call, then one traced call of ``fn``: its host wall
    seconds (synchronized) and the profiler's device seconds and launches
    by kind, with the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    kinds = {}
    for e in kernels:
        k = kinds.setdefault(_kind(e.key), {"device_s": 0.0, "launches": 0})
        k["device_s"] += e.self_device_time_total / 1e6
        k["launches"] += e.count
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    return {"traced_wall_s": wall, "by_kind": kinds,
            "top_kernels": [[e.key[:70], e.count,
                             e.self_device_time_total / 1e3] for e in top]}


def profile_train(device="cuda") -> None:
    """The full-width training step (module docstring)."""
    cfg = dataclasses.replace(configs.get("qwen3_4b"), n_layers=12)
    params = init_params(cfg, prng.PRNGKey(0, device=device))
    ocfg = optim.OptConfig.from_model(cfg)
    state = optim.init(params, ocfg)
    fn, _ = steps.build_train_step(cfg, opt_cfg=ocfg, device=device)
    dcfg = DataConfig(seed=0, seq_len=2048, global_batch=8,
                      vocab_size=cfg.vocab_size)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in batch_for_model(cfg, dcfg, 0).items()}
    fn(params, state, batch)                       # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flash_attn.LAUNCHES = flash_attn_bwd.LAUNCHES = 0
    fn(params, state, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": flash_attn.LAUNCHES,
                "flash_attention_bwd": flash_attn_bwd.LAUNCHES}
    traced = _traced(lambda: fn(params, state, batch))
    busy_s = sum(x["device_s"] for x in traced["by_kind"].values())

    grads = tree_map(lambda t: torch.full(t.shape, 1e-3, device=device),
                     params)
    nsq = optim.global_norm_sq(grads)
    update = _traced(lambda: optim.update(grads, state, params, ocfg,
                                          norm_sq=nsq))
    print(json.dumps({
        "run": "train step qwen3-4b 12 layers, 8 x 2048 tokens",
        "wall_s": wall, "launches": launches, "device_busy_s": busy_s,
        "idle_share": 1.0 - busy_s / traced["traced_wall_s"], **traced,
        "optimizer_update": update}))


PATHS = ("simulator", "train", *SERVE_MODELS)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", help="profile these paths, comma-separated, "
                                   f"of {', '.join(PATHS)} (default: the "
                                   "simulator and Qwen3-4B's serve)")
    args = ap.parse_args(argv)
    only = args.only.split(",") if args.only else ["simulator", "serve"]
    bad = [name for name in only if name not in PATHS]
    if bad:
        ap.error(f"--only: unknown paths {bad}, not of {PATHS}")
    print(json.dumps({"device": torch.cuda.get_device_name(0)}))
    for name in only:
        if name == "simulator":
            profile_simulator()
        elif name == "train":
            profile_train()
            torch.cuda.empty_cache()
        else:
            profile_serve(which=name)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
