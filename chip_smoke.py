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
   least time the card could take (its bound).  ``ops.fft4``'s fused
   kernel against the stage kernel's chain for rows of 16 to 16384
   points, and a 65536-point row (a stage launch, then the fused kernel)
   against ``torch.fft``; the fused kernel, the stage chain and
   ``torch.fft`` timed in turns at (896, 4096) on the same cold copies,
   in device time (CUDA graph replay) and eagerly, with each one's
   ratio to the library; the stage kernel's one launch on a path (stage
   0 of the 65536-point rows) timed in turns with ``torch.fft``.  ``matmul`` at shapes that reach every path of
   its kernel, the 5G shape timed in turns with ``torch.matmul`` in
   device time and eagerly, and its row, column and offset-view
   identities bit for bit.
3. ``fiveg_pipeline``: one 5G NR slot (64 antennas x 4096 sub-carriers
   x 14 symbols) through the fused FFT kernel and the matmul kernel,
   checked against numpy; the launch counts of this run (one fused FFT
   launch, two matmuls) and its wall time, numpy's input generation
   included; the slot's device work alone on resident inputs
   (``slot_ms`` in device time, ``slot_eager_ms`` eagerly), each
   kernel's share and the slot's bound; then ``ops.fft4`` over (64,
   65536), the stage kernel's own path, counted apart.
4. ``fig4a``: the Fig. 4a sweep at N = 1024 (10 radices x 4 delays x
   1024 trials), its first 16 trials bit for bit against the port's
   ``simulate_reference`` on the CPU and the JAX reference values.
5. ``fig7``: the Fig. 7 grid of ``benchmarks/fig7_5g_app.py`` through
   ``repro_torch.examples.fig7`` (central, tree, partial and hw at each
   point) against the JAX reference values, with the wall time of each
   point's ``compare_barriers``, and claim C4 (paper: 1.6x at
   fine-grained sync, <= 6.2 % sync).
6. ``dotp_axpy``: the Fig. 5/6 benchmark kernels through ``ops.dotp``
   (central accumulator and k-ary trees of radix 2 to 1024: the leaves,
   then every level in one ``combine_tree`` launch) and ``ops.axpy`` at
   the Fig. 5 sizes and at 64 Mi elements, and ``ops.dotp`` over 2 Gi
   bf16 elements, whose 65536 leaves pass the tree's shared-memory cap
   (one ``combine_partials`` level first), with the launch counts of that
   run; each kernel against its plain version, the fused tree against
   the chain of per-level launches bit for bit, and each timed beside its
   bound and one PyTorch library call, the tree kernels, the chain and
   ``axpy`` in device time (CUDA graph replay) and eagerly.
7. ``fig5``: every Fig. 5 kernel's arrival gap and median through
   ``repro_torch.examples.fig5`` against the JAX reference values, and
   claim C5.
8. ``fig6``: the 7-radix x 15-kernel grid of
   ``benchmarks/fig6_kernel_colormap.py`` through
   ``repro_torch.examples.fig6`` against the reference values.
9. ``tuner``: ``sweep_workloads`` over all 512 compositions x 15 kernels
   x 4 trials at N = 1024, the per-delay tuner on the same schedules,
   claim C6, and one placed ``tune_barrier``.
10. ``fig7_tuned``: the five tuner modes of the 5G app at (16, 1) and
    (64, 4) through ``repro_torch.examples.fig7`` against the reference
    values.  The fig5, fig6 and fig7 phases write the drivers' records,
    ``build/BENCH_torch_fig5.json`` ... ``fig7.json``.
11. ``normal``: ``prng.normal`` on the card against stored JAX draws,
    in ulps; and the original (non-partitionable) threefry stream's
    ``split``/``uniform``/``normal``/``bernoulli`` against stored JAX
    draws made with ``jax_threefry_partitionable`` off, bit for bit.
12. ``powf``: the ``powf`` kernel against the host's C library over every
    float32 base the Pareto straggler model can reach at 64, 256 and
    1024 PEs, and ``arrival_batch("straggler_pareto")`` at (8, 1024) on
    the card against stored JAX draws, bit for bit, with where its
    ``pow`` ran; the kernel timed in turns with ``torch.pow`` in device
    time (CUDA graph replay) at the model's 8192 bases and at
    ``POWF_CHUNK``, with the eager times beside, and its bound: the
    larger of its bytes and its FP64-pipe instructions and 64-bit
    conversions a base, read from the built library's SASS.
13. ``faults``: the degradation sweep of ``benchmarks/bench_faults.py``
    at N = 1024 (130 schedules x 5 PE failure rates x 64 trials) through
    ``repro_torch.examples.bench_faults``, bit for bit against the
    reference values; then the same sweep on the original threefry
    stream (``prng.threefry_partitionable(False)``), whose record must
    equal ``BENCH_faults.json``'s ``degradation`` section at its
    rounding.
14. ``fiveg_faults``: the 5G ``degradation_curve`` (central, tree, hw x 5
    rates) against the reference values; on the original stream, equal
    to ``BENCH_faults.json``'s ``fiveg`` section at its rounding.
15. ``fig4b``: Fig. 4b through ``repro_torch.examples.fig4`` (the best
    radix per delay of the 16-trial Fig. 4a sweep and its mean
    residency, against the reference values), and claim C3 on the draws
    of the reference's own test (radices 16/32/64/1024, 8 trials, delays
    256 and 2048): the residencies against the reference values, the SFR
    for < 10 % overhead inside (500, 4000) and (4000, 16000) cycles.
16. ``multicluster``: hierarchical stacks on 4-cluster machines of 2048
    and 4096 PEs bit for bit against the reference values (names,
    telescope widths, exit times, spans); then
    ``repro_torch.examples.bench_multicluster`` at 2048, 4096 and 16384
    PEs, its ``n_schedules``, ``hier_vs_flat`` and ``widths.sum_*``
    equal to ``BENCH_multicluster.json``, its sweep and width timings
    recorded fresh.
17. ``energy``: ``repro_torch.examples.bench_energy``'s three sections
    equal to ``BENCH_energy.json`` at its rounding: energy per barrier at
    64/256/1024 PEs and the Pareto front at 1024 (delay 0), and the 5G
    energy section on the original threefry stream.
18. ``figures``: the beyond-figure drivers
    ``repro_torch.examples.fig_placement``, ``fig_tuned_tree`` and
    ``fig_workload_tuned``, each row (name and derived value) equal to
    the reference values' section of the same name.
19. ``resilience``: ``resilient_sweep_schedules`` over the Fig. 4a grid
    (10 radices x 4 delays x 1024 trials at N = 1024, 8 chunks of 128)
    preempted before chunk 4 and resumed from its store, bit for bit the
    plain ``sweep_schedules`` in the same chunks; the same for
    ``resilient_sweep_arrivals`` over 2 x 1024 arrival vectors
    (preempted before chunk 5); then ``fiveg``'s tuned mode read twice
    through a schedule cache under ``build/resilience``, the second read
    a hit with the same cycles; the walls, the lookups' and the reports'
    ``ckpt_seconds``.
20. ``serving``: the tuning-serving daemon on the card at N = 1024
    (hierarchy-pruned compositions).  (a) The stored kernel requests
    (``dotp_1Mi``, ``fiveg_fft_stage``, ``straggler_pareto`` under
    ``cycles`` and ``pareto``), submitted from a client thread before the
    worker starts: one dispatch, each answer exact with the stored batch
    size, winner and mean span, its energy within rtol 1e-6, the arrival
    digests equal; the straggler draws launch ``powf`` on the client
    thread, and those launches join the ``powf`` row's count.  (b) 8
    fresh traces in one dispatch, every field bit for bit 8 single
    ``sweep_arrivals``.  (c) The ladder: a resubmission a cache hit, an
    expired deadline the stored closed-form pick per objective, a
    ``DeviceLoss`` mid-batch under a ``ResilienceConfig`` losing no
    request, the breaker tripping and a probe closing it.  (d) ``fiveg``'s
    client mode: ``simulate_app`` with ``sync="workload"`` and
    ``"pareto"`` at (16, 1) through the server, one dispatch each, equal
    to the inline run.  (e) ``repro_torch.examples.bench_serving``,
    ``bench_resilience`` and ``bench_core`` at the reference's sizes,
    their records printed and written to
    ``build/BENCH_torch_{serving,resilience,core}.json``: every
    sequential request exact, 8 requests a dispatch, the resumed sweep
    bit for bit the plain one, both cores' spans equal.
21. ``dct_conv2d``: ``ops.dct`` and ``ops.conv2d`` at the Fig. 5/6
    suite's sizes, with the launch counts of that run, each kernel
    against its plain version (``dct`` also in bf16 and f16, at (4096,
    4096) and a ragged (300, 1000)), the suite's rows of a (4096, 4096)
    call equal to the same rows alone, and the times of ``dct`` at the
    suite's three shapes and (4096, 4096) (device time and eager) and of
    ``conv2d`` at (256, 512, 512), beside their bounds and one PyTorch
    library call.
22. ``lm_serve``: the LM serving paths.  The flash-attention kernel
    against its plain version at the reference's test shapes, in bf16 at
    every head width of ``HEAD_DIMS``, in float32 at the configs' widths
    80 and 192, at its (D, Dv) pairs (192, 128) and (24, 16) (float32 and
    bf16, causal and full, the default scale and 0.37; bf16 with the
    planted faults; an unsupported pair must raise), at nemotron-4-340b's,
    hubert-xlarge's and DeepSeek-V3's full-width attention shapes (timed
    beside SDPA and the bound), and at the prefill's shape, where the
    model's strided (B, S, H, D) views must give the contiguous call's
    bits; its time there beside its bound and SDPA
    (``ratio_to_library``), and the registers and shared memory of the
    wgmma kernel (D 64-192 and (192, 128)) and the float32 FMA kernel
    (``nvcc -Xptxas -v``, setmaxnreg, the launch's dynamic shared memory;
    a spill, or more than the 227 KB a block may have, fails the run);
    the qwen3, moonshot and deepseek-v3 smoke configs on the card against
    the stored JAX values (their inits' leaf digests bit for bit, prefill
    and 4 decode steps); then full-width Qwen3-4B and DeepSeek-V3 (its
    published widths, 3 dense layers and 1 MoE layer of 256 experts)
    through ``repro_torch.examples.serve_lm``: 4 requests of 2016 prompt
    tokens and 32 new tokens each, one kernel launch a layer a prefill,
    the first token's logits held against the same prefill with the
    plain chunked attention.  Then the hybrid and SSM families: the
    attention kernel under a sliding window against its plain version
    (windows 1 to past S, causal and not, every kernel it reaches, with
    planted window faults) and at Hymba-1.5B's prefill shape, timed
    beside SDPA on an explicit (S, S) mask; the selective-scan kernel's
    resources at every lane count (a spill fails the run) and against
    its plain version at each of them, timed with its launch plan at
    Falcon-Mamba-7B's and Hymba-1.5B's prefill shapes; the
    falcon-mamba and hymba smoke serves and the hubert-xlarge (audio)
    and internvl2-76b (vision) smoke forwards against the stored JAX
    values (``lm_serve_ssm``); then full-width Hymba-1.5B (32 layers) and
    Falcon-Mamba-7B (64 layers) through ``serve_lm`` with the same
    traffic: each kernel launched once a layer that has its mixer a
    prefill, the logits held against the plain attention and scan.  The
    summary line's ``flash_attention`` entry is the Qwen3-4B path,
    ``flash_attention_mla`` the DeepSeek-V3 one (the same kernel at (192,
    128)), ``flash_attention_window`` the Hymba one (the same kernel
    under its window) and ``ssm_scan`` the Falcon-Mamba one.
23. ``lm_train``: the training paths of the dense, MoE, MLA, SSM and
    hybrid families.  The attention backward kernels against their plain
    version (autograd through the float32 reference) at the test shapes
    (ragged S and T, H / Hk 1 and 4, causal and full, float32 and bf16,
    every head width of ``HEAD_DIMS``, and the (D, Dv) pairs (192, 128)
    and (24, 16) at the default scale and 0.37), and under the sliding
    window (the forward's window checks' windows, shapes and kernels, and
    the (192, 128) ``wgmma`` kernels): dQ, dK and dV scaled by each
    gradient's largest element, the forward's row log-sum-exp against
    the plain ``logsumexp``, two runs bit for bit; a window over more
    query rows than keys and a pair outside ``flash_attn.PAIRS`` must
    raise before any launch; the kernels' registers and spills (a spill
    in a ``wgmma`` kernel or an FMA kernel at a pair, or a C75xx
    serialisation, fails the run); then Qwen3-4B's, DeepSeek-V3's and
    Hymba-1.5B's (under its window) training shapes, timed beside the
    plain version, SDPA's backward and the bound, and the forward kernel
    with and without the ``lse`` output in turns; each windowed bf16
    draw beside SDPA's backward on the same inputs, both against the
    float32 reference.  The scan's backward against its plain version
    (autograd through the chunked scan) at every lane count and chunk
    length, S below one chunk and ragged past several, the final state's
    gradient absent and present, and at both SSM models' training
    micro-batches at every chunk length the plan picks from (two runs
    bit for bit), timed beside its bound; a spill in any of its kernels
    fails the run.  The qwen3, deepseek-v3, falcon-mamba and
    hymba smoke configs' three micro-batched train steps on the card
    against the stored JAX values (``lm_train``, ``lm_train_moe``,
    ``lm_train_ssm``, ``lm_train_hybrid``: the init's digests, the
    metrics, the updated leaves' sums), float32 and bf16.  Then five
    models at full width: Qwen3-4B cut to 12 layers, DeepSeek-V3 to its 3
    dense layers and the ``mtp`` head (bf16 master weights, int8 first
    moment, factored second moment, bf16 gradient sums: its config's
    plan), Moonshot-v1-16B-A3B to 4 layers (its dense layer and 3 MoE
    layers of 64 experts), Falcon-Mamba-7B to 16 of 64 layers and
    Hymba-1.5B whole: for each, one micro-batch's loss and gradients
    through the kernels against the plain chunked attention and plain
    scan under autograd on the card (the kernel run's expert choices
    replayed in the plain run), then a warm-up and 3 timed steps of
    ``build_train_step`` (8 micro-batches of 2048 tokens, remat) with the
    step time, tokens per second, peak memory, the kernels' launches (the
    attention forward and the scan twice a layer and once for the ``mtp``
    block a micro-batch, each backward once) and the model-FLOPs share.
    Last, ``examples/train_lm.py`` at its default ``10m`` scale (head
    width 40) trains 40 steps through both kernels.  The summary line's
    ``flash_attention_bwd`` entry is this path at (D, D) (the Qwen3-4B
    and Moonshot runs' launches), ``flash_attention_bwd_mla`` the
    DeepSeek-V3 run at (192, 128), ``flash_attention_bwd_window`` the
    Hymba-1.5B run under its window and ``ssm_scan_bwd`` the
    Falcon-Mamba-7B and Hymba-1.5B runs' scan: 19 kernels.

Each phase prints its wall time.  Then the kernels' summary line and,
last, the device line.  Any failed
check raises: the script exits non-zero and prints no result.  It needs
the rest of the checkout (``src/repro_torch``) and a CUDA device.
"""
import dataclasses
import gc
import hashlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.timing import (attention_bwd_work, attention_work, bound,
                                cold_copies, cuda_ms, fft_stage_work,
                                fft_work, fp64_bound, graph_ms, in_turns,
                                matmul_work, scan_bound, scan_bwd_bound,
                                sdpa_backend, slot_work)


MODES = ("central", "tree", "partial", "hw")
TUNED_MODES = ("tuned", "tuned_partial", "placed", "workload", "pareto")
KERNELS = ("fft4_stage", "fft4_fused", "matmul", "dotp_central",
           "dotp_partials", "combine_partials", "combine_tree", "axpy",
           "dct", "conv2d", "powf", "flash_attention", "flash_attention_mla",
           "flash_attention_window", "ssm_scan", "flash_attention_bwd",
           "flash_attention_bwd_mla", "flash_attention_bwd_window",
           "ssm_scan_bwd")
REPLACES = {"fft4_stage": "src/repro/kernels/fft4.py:58",
            # The same Pallas kernel as src/repro/kernels/ops.py::fft4
            # chains it, every stage of a row in one launch.
            "fft4_fused": "src/repro/kernels/fft4.py:58",
            "matmul": "src/repro/kernels/matmul.py:41",
            "dotp_central": "src/repro/kernels/dotp.py:40",
            "dotp_partials": "src/repro/kernels/dotp.py:64",
            "combine_partials": "src/repro/kernels/dotp.py:89",
            # The same Pallas kernel as src/repro/kernels/ops.py::dotp
            # chains it, one launch a level: every level in one.
            "combine_tree": "src/repro/kernels/dotp.py:89",
            "axpy": "src/repro/kernels/axpy.py:27",
            "dct": "src/repro/kernels/dct.py:25",
            "conv2d": "src/repro/kernels/conv2d.py:32",
            # No Pallas kernel: XLA's call of the C library's powf in the
            # Pareto straggler model.
            "powf": "src/repro/core/workloads.py:311",
            "flash_attention": "src/repro/kernels/flash_attn.py:73",
            # The same Pallas kernel at MLA's (D, Dv) = (192, 128), which
            # the models' attention computes with a scale of its own
            # (src/repro/models/mla.py:145).
            "flash_attention_mla": "src/repro/kernels/flash_attn.py:73",
            # The same Pallas kernel under the models' sliding-window mask
            # (src/repro/models/attention.py:118-125), Hymba's.
            "flash_attention_window": "src/repro/kernels/flash_attn.py:73",
            # No Pallas kernel: the jnp selective scan (a chunked
            # lax.associative_scan) of the SSM family.
            "ssm_scan": "src/repro/models/ssm.py:69",
            # No Pallas kernel: JAX's autodiff of the model's jnp chunked
            # attention (the Pallas kernel has no backward).
            "flash_attention_bwd": "src/repro/models/attention.py:86",
            # The same gradient at MLA's (D, Dv) = (192, 128) and scale
            # (src/repro/models/mla.py:145).
            "flash_attention_bwd_mla": "src/repro/models/attention.py:86",
            # The same gradient under the models' sliding window (the
            # swa_fast path, src/repro/models/attention.py:110-124),
            # Hymba's.
            "flash_attention_bwd_window":
            "src/repro/models/attention.py:86",
            # No Pallas kernel: JAX's autodiff of the jnp selective scan.
            "ssm_scan_bwd": "src/repro/models/ssm.py:69"}
SOURCES = {"fft4_stage": "src/repro_torch/csrc/fft4_stage.cu",
           "fft4_fused": "src/repro_torch/csrc/fft4_stage.cu",
           "matmul": "src/repro_torch/csrc/matmul.cu",
           "dotp_central": "src/repro_torch/csrc/dotp.cu",
           "dotp_partials": "src/repro_torch/csrc/dotp.cu",
           "combine_partials": "src/repro_torch/csrc/dotp.cu",
           "combine_tree": "src/repro_torch/csrc/dotp.cu",
           "axpy": "src/repro_torch/csrc/axpy.cu",
           "dct": "src/repro_torch/csrc/dct.cu",
           "conv2d": "src/repro_torch/csrc/conv2d.cu",
           "powf": "src/repro_torch/csrc/powf.cu",
           "flash_attention": "src/repro_torch/csrc/flash_attn.cu",
           "flash_attention_mla": "src/repro_torch/csrc/flash_attn.cu",
           "flash_attention_window": "src/repro_torch/csrc/flash_attn.cu",
           "ssm_scan": "src/repro_torch/csrc/ssm_scan.cu",
           "flash_attention_bwd": "src/repro_torch/csrc/flash_attn_bwd.cu",
           "flash_attention_bwd_mla":
           "src/repro_torch/csrc/flash_attn_bwd.cu",
           "flash_attention_bwd_window":
           "src/repro_torch/csrc/flash_attn_bwd.cu",
           "ssm_scan_bwd": "src/repro_torch/csrc/ssm_scan_bwd.cu"}
# The dot product's path: the Fig. 5 input sizes and the 64 Mi-element
# case where the bandwidth bound means something; the central
# accumulator (radix 0) and the tree radices of the Fig. 6 sweep.
DOTP_SIZES = (1 << 18, 1 << 19, 1 << 20, 1 << 26)
DOTP_RADICES = (0, 2, 4, 16, 32, 1024)
# A bf16 dot product whose leaf count (65536) passes the tree kernel's
# cap: the path's one use of the per-level kernel.
DOTP_ABOVE_CAP = 1 << 31
AXPY_SIZES = (1 << 20, 1 << 26)
# The 5G beamforming product: 32 beams x 64 antennas against 64 x (14
# symbols x 4096 sub-carriers).
MM_5G = (32, 64, 57344)
# The Fig. 5/6 suite's DCT and Conv2D inputs, and the sizes they are
# timed at.
DCT_SIZES = ((2, 4096), (64, 4096), (256, 4096))
DCT_LARGE = (4096, 4096)
CONV_SIZES = ((1, 128, 128), (1, 256, 256), (1, 512, 512))
CONV_LARGE = (256, 512, 512)
# ops.fft4's fused kernel against the stage chain: row lengths up to
# L_MAX, and a row above it (one stage launch, then the fused kernel).
FFT_FUSED_SIZES = (16, 64, 256, 1024, 4096, 16384)
FFT_LONG = (64, 4 ** 8)
# The Pareto straggler model's draws on the card, and its work per PE.
STRAGGLER_KERNEL = "straggler_pareto"
POWF_CHUNK = 1 << 24
RESILIENCE_TRIALS = 1024   # the Fig. 4a grid's trials,
RESILIENCE_CHUNK = 128     # in 8 chunks
SERVING_TRACE_KEY = 11     # the serving phase's fresh arrival traces
SERVING_TIMEOUT_S = 120    # a daemon answer later than this fails the run
# The LM serving path: the reference's flash-attention test shapes (s, d),
# the prefill's attention shape (B, H, Hk, S, D), and the full-width run.
FA_TEST_SHAPES = ((64, 16), (128, 32), (256, 64))
FA_PATH_SHAPE = (4, 32, 8, 2048, 128)
# Full-width attention of the configs with head widths 192 and 80, and of
# DeepSeek-V3's MLA prefill ((D, Dv) = (128 + 64, 128)), (B, H, Hk, S, D or
# (D, Dv), causal, dtypes): nemotron-4-340b (96 heads reading 8), the
# hubert-xlarge encoder, and DeepSeek-V3's 128 heads at the full-width
# serve's 4 x 2048 tokens.
FA_CONFIG_SHAPES = {"nemotron-4-340b": (1, 96, 8, 1024, 192, True,
                                        ("bfloat16",)),
                    "hubert-xlarge": (2, 16, 16, 1024, 80, False,
                                      ("bfloat16", "float32")),
                    "deepseek-v3-671b": (4, 128, 128, 2048, (192, 128), True,
                                         ("bfloat16",))}
# The kernel's (D, Dv) pairs beyond D = Dv: DeepSeek-V3's MLA and its
# smoke config's (16 + 8, 16); each also with a scale other than
# D ** -0.5.
FA_PAIRS = ((192, 128), (24, 16))
FA_SCALE = 0.37
# Kernel against plain in float32 at the new widths: both sum float32
# products; 1e-4 leaves the exponentials' and the order's rounding a wide
# margin.
FA_F32_TOL = 1e-4
# Kernel against plain in bf16: p is rounded to bf16 before the PV
# product at a per-tile running max in the kernel and after the softmax
# in the plain version, and the output is rounded to bf16 (2^-8
# relative each): two bf16 ulps relative (1.6e-2) plus 1.6e-2 absolute
# for unit-scale v.
FA_BF16_TOL = 1.6e-2
# FA_BF16_TOL is loose where outputs are averages of hundreds of keys
# (about 0.1).  So bf16 is also held to float32 attention on the same bf16
# inputs, each query row's largest error over that row's largest output
# (row_scaled_err): the output's rounding and p's are 2^-9 relative each,
# and 2^-6 leaves them a factor of four.  Faults planted in the kernel's
# inputs and output (fa_planted_faults) must exceed it.
FA_BF16_ROW_TOL = 2.0 ** -6
# The shared memory a block may take on the H100 (227 KB).
SMEM_PER_BLOCK = 232448
LM_FULL = {"arch": "qwen3_4b", "batch": 4, "prompt_len": 2016, "tokens": 32}
# DeepSeek-V3 at its published widths, depth cut to 4 layers (its 3 leading
# dense layers and 1 MoE layer of 256 experts), set here so that the
# package has no such knob; the same traffic as LM_FULL.
LM_MLA = {"arch": "deepseek_v3_671b", "n_layers": 4, "batch": 4,
          "prompt_len": 2016, "tokens": 32}
# The serve path's tolerances against the JAX values (tests/
# test_torch_lm_serve.py): float32 end to end, and bf16; and the full-width
# kernel-against-plain logits gap, tests/test_arch_smoke.py's bf16 bound.
LM_F32_TOL, LM_BF16_ATOL, LM_FULL_GAP = 1e-4, 0.0625, 0.35
# MLA rounds to bf16 at more sites (tests/test_torch_lm_serve_mla.py).
LM_BF16_ATOL_BY_ARCH = {"deepseek_v3_671b": 0.125}
# The hybrid and SSM families at their published widths and full depth
# (Hymba-1.5B: 32 layers of window-1024 attention beside a Mamba block;
# Falcon-Mamba-7B: 64 Mamba layers), LM_FULL's traffic: the window cuts
# the second half of each 2048-token prompt.
LM_HYBRID = {"arch": "hymba_1_5b", "batch": 4, "prompt_len": 2016,
             "tokens": 32}
LM_SSM = {"arch": "falcon_mamba_7b", "batch": 4, "prompt_len": 2016,
          "tokens": 32}
# The window kernel's checks: windows from one key to past S at S = T =
# 1100 (every window's edge falls inside a query tile), 10 query heads on
# 2 KV heads (Hymba's grouping g = 5), each kernel the window reaches;
# then Hymba's prefill attention, (B, H, Hk, S, D) and its window.
FA_WINDOWS = (1, 7, 63, 64, 1000, 1024, 1100)
FA_WINDOW_KERNELS = ((8, "float32"), (8, "bfloat16"), (64, "float32"),
                     (16, "bfloat16"), (64, "bfloat16"), (128, "bfloat16"))
FA_WINDOW_SHAPE = (4, 25, 5, 2048, 64, 1024)
# The scan kernel against its plain version: S at, below and past the
# plain version's 256-step chunk; then Falcon-Mamba's and Hymba's prefill
# scans (B, S, d_inner, n).  Both sum float32 products over at most 16
# states a step in other orders, with exponentials an ulp or two apart,
# and the states decay: 1e-4.
SCAN_TEST_S = (1, 255, 256, 2048)
SCAN_SHAPES = {"falcon-mamba-7b": (4, 2048, 8192, 16),
               "hymba-1.5b": (4, 2048, 3200, 16)}
SCAN_TOL = 1e-4
# The scan's backward against its plain version (autograd through the
# chunked scan), each gradient to 1e-4 of its largest element
# (tests/test_torch_cuda.py's SCAN_BWD_TOL): S below one 16-step
# checkpoint interval, ragged past the plain version's chunk; 200
# channels over 2 batch rows at chunks of one tile and of every length
# the plan picks from (at 300 steps 19 chunks
# of 16, five of 64 with the last ragged, one of 512: S below a chunk);
# then the two models' training micro-batches (B, S, d_inner, n) at
# every chunk length.
SCAN_BWD_TEST_S = (15, 300)
SCAN_BWD_SHAPES = {"falcon-mamba-7b": (1, 2048, 8192, 16),
                   "hymba-1.5b": (1, 2048, 3200, 16)}
# The backward's 4-byte staging (rows off 16-byte boundaries): (B, S, n,
# chunk) over five chunks with the final state's gradient present, at an
# odd d_inner, and at (d_inner, operands at storage offset 1).
SCAN_BWD_SCALAR = {"shape": (2, 300, 16, 64),
                   "cases": ((33, False), (64, True), (33, True))}
SCAN_BWD_TOL = 1e-4
# The attention backward against its plain version (autograd through the
# float32 reference), row-scaled as row_scaled_err does for the forward:
# each row's largest error over the larger of that row's largest element
# and 2^-6 of the gradient's largest row (FA_BWD_ROW_FLOOR; a row whose
# gradient cancels, as query 0's under causal masking, is held at that
# floor).  float32 sums in other orders: 1e-4 (2.6e-5 seen); bf16 rounds
# P and dS to bf16 before their products and the gradients to bf16: 0.1
# (0.055 seen at the test shapes; at the training shape 0.043, SDPA's
# backward the same 0.043).  The forward's lse against the plain
# logsumexp: float32 (9.5e-7 seen).
FA_BWD_TOL = {"float32": 1e-4, "bfloat16": 0.1}
FA_BWD_ROW_FLOOR = 2.0 ** -6
# The pairs' bf16 check at scale 0.37 (five times MLA's 192 ** -0.5) is
# held to each gradient's largest element instead
# (tests/test_torch_cuda.py's BWD_TOL): so peaked a softmax leaves rows
# of dQ whose terms cancel, and dS rounded to bf16 before the dQ product
# (every bf16 kernel's design) moves such a row by up to 0.13 of itself
# at (192, 128) (seen), as the row metric counts it.  float32 at 0.37
# and bf16 at MLA's scale keep the row metric.
FA_BWD_SCALED_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
FA_LSE_TOL = 1e-5
# Its test shapes (H, Hk, S, T): ragged lengths, groups of 1 and 4, and S
# = 1000 (no multiple of the wgmma kernels' 64- and 128-row tiles); then
# Qwen3-4B's training attention (B, H, Hk, S, D), one micro-batch.
FA_BWD_SHAPES = ((2, 2, 77, 77), (8, 2, 300, 300), (4, 1, 130, 200),
                 (8, 2, 1000, 1000))
# The backward under the window at the forward's window checks (FA_WINDOWS
# at S = T = 1100, 10 heads on 2, each kernel of FA_WINDOW_KERNELS, causal
# and not) and at the (192, 128) wgmma kernels (700 rows, 8 heads), at
# the unwindowed backward's bounds: float32 by rows (FA_BWD_TOL), bf16 by
# each gradient's largest element (FA_BWD_SCALED_TOL, the card tests'
# bound), as at the pairs' scale 0.37: a window of a few dozen keys leaves
# rows of dQ whose terms cancel, which dS rounded to bf16 moves by up to
# 0.103 of themselves (D 64, window 64, PR 30 call 2); then Hymba-1.5B's
# training attention (B, H, Hk, S, D, window), one micro-batch.
FA_BWD_WINDOW_SHAPE = (1, 10, 2, 1100)
FA_BWD_WINDOW_PAIR = (1, 8, 8, 700, 192, 128)
FA_WINDOW_TRAIN_SHAPE = (1, 25, 5, 2048, 64, 1024)
# Hymba-1.5B's training shape is also checked causal and not, by each
# gradient's largest element beside SDPA, on draws of this seed.
FA_BWD_FULL_SEED = 32
FA_TRAIN_SHAPE = (1, 32, 8, 2048, 128)
# DeepSeek-V3's training attention (B, H, Hk, S, D, Dv): one micro-batch
# of 2048 tokens, 128 heads at MLA's (192, 128).
FA_MLA_TRAIN_SHAPE = (1, 128, 128, 2048, 192, 128)
# The training path at full width: Qwen3-4B's published widths with the
# depth cut to 12 of its 36 layers (4.41 B parameters need ~88 GB of
# weights, float32 master, moments and gradient accumulator; 12 layers
# 1.99 B, ~40 GB), its 8 micro-batches and remat, a global batch of 8 x
# 2048 tokens of the synthetic stream (seed 0), AdamW from the config.
LM_TRAIN = {"arch": "qwen3_4b", "n_layers": 12, "global_batch": 8,
            "seq_len": 2048, "timed_steps": 3}
# The MoE and MLA families at published widths, the same traffic and
# steps at each config's own defaults.  DeepSeek-V3 as its dense prefix:
# one of its MoE layers holds 256 x 3 x 7168 x 2048 = 11.3 B parameters,
# and at the config's plan (bf16 weights, a bf16 gradient sum and a
# micro-batch's bf16 gradients, an int8 first moment: 7 bytes a
# parameter) any depth that keeps one needs ~110 GB; its 3 dense layers
# and the mtp head are 4.29 B (~30 GB before activations).  MLA's (192,
# 128) attention runs at full width in all four blocks.
LM_TRAIN_MLA = {"arch": "deepseek_v3_671b", "n_layers": 3, "global_batch": 8,
                "seq_len": 2048, "timed_steps": 3}
# Moonshot-v1-16B-A3B (64 experts, top-6, 2 shared; MHA at D 128) cut to
# its dense layer and 3 MoE layers: 2.52 B parameters at the default
# float32 master and moments (~25 bytes a parameter in Qwen3-4B's run,
# ~59 GiB; 5 layers, 3.11 B, would need ~73 GiB of the card's 80).
LM_TRAIN_MOE = {"arch": "moonshot_v1_16b_a3b", "n_layers": 4,
                "global_batch": 8, "seq_len": 2048, "timed_steps": 3}
# The SSM and hybrid families, the same traffic and steps: Falcon-Mamba-7B
# at its published widths cut to 16 of its 64 layers (2.22 B parameters;
# all 64, 7.27 B, would need ~180 GB at the ~28 bytes a parameter of the
# default float32 master and moments), Hymba-1.5B whole (32 layers, 1.66
# B).
LM_TRAIN_SSM = {"arch": "falcon_mamba_7b", "n_layers": 16, "global_batch": 8,
                "seq_len": 2048, "timed_steps": 3}
LM_TRAIN_HYBRID = {"arch": "hymba_1_5b", "n_layers": 32, "global_batch": 8,
                   "seq_len": 2048, "timed_steps": 3}
# One micro-batch's loss and gradients through the kernels against the
# plain chunked attention under autograd on the card: both bf16, with p
# and the outputs rounded at other places.  Each gradient leaf's largest
# gap to 0.1 of its largest element (the CPU's bf16 port against XLA:
# 1.9e-2; 0.034 seen at Qwen3-4B) is the check that catches a wrong
# kernel: at the random init the loss (about 12) barely depends on
# attention.  The loss to 1e-3 (1.9e-4 seen).  The same bounds hold
# DeepSeek-V3's and Moonshot-v1-16B-A3B's runs, their expert choices
# replayed (_Routing).
LM_TRAIN_LOSS_GAP, LM_TRAIN_GRAD_GAP = 1e-3, 0.1
# The smoke train steps against the stored JAX values
# (tests/test_torch_lm_train_values.py's TOL): the metrics' relative gap,
# a leaf's sum gap over its sum of absolute values.
LM_TRAIN_TOL = {"float32": {"metrics": 1e-5, "leaf_sum": 1e-4},
                "bfloat16": {"metrics": 5e-3, "leaf_sum": 2e-3}}
# The deepseek-v3 smoke steps (``lm_train_moe``,
# tests/test_torch_lm_train_moe_values.py's TOL): the same, but float32's
# metrics to 5e-5: bf16 master weights and bf16 gradient sums turn an ulp
# of float32 into a flipped bf16 rounding (1.3e-5 seen here, 8.3e-6 on the
# CPU).  The MoE's gather backward adds with atomics on the card, so these
# runs are held to the bounds, not to bits.
LM_TRAIN_MOE_TOL = {"float32": {"metrics": 5e-5, "leaf_sum": 1e-4},
                    "bfloat16": {"metrics": 5e-3, "leaf_sum": 2e-3}}
# The falcon-mamba and hymba smoke steps (``lm_train_ssm``,
# ``lm_train_hybrid``; tests/test_torch_lm_train_ssm_values.py's TOL):
# LM_TRAIN_TOL, but a bf16 leaf's sum to 5e-3: the zero-initialised conv
# bias (256 elements) moves by 2 lr = 2e-3 for each element whose tiny
# gradient takes the other sign in bf16, 4e-3 of its sum of absolute
# values after three steps (2.5e-3 seen on the CPU).
LM_TRAIN_SSM_TOL = {"float32": {"metrics": 1e-5, "leaf_sum": 1e-4},
                    "bfloat16": {"metrics": 5e-3, "leaf_sum": 5e-3}}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def phase_info(torch, build):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    paths = build.build(["fft4_stage", "matmul", "dotp", "axpy", "dct",
                         "conv2d", "powf", "powf_host", "flash_attn",
                         "flash_attn_bwd", "ssm_scan", "ssm_scan_bwd"])
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
    # input.  The butterfly's products are __fmul_rn in the kernel, so
    # nothing is contracted into an FMA and both round every operation in
    # the same order: equal bits are required.
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
            if err != 0.0:
                raise AssertionError(
                    f"fft4_stage ({rows}, {n}): max abs err {err}, "
                    f"expected equal bits (largest output {scale})")
            rec = {"phase": "kernel", "name": "fft4_stage",
                   "shape": [rows, n], "stages": stages,
                   "max_abs_err": err, "tol": 0.0}
            if (rows, n) == (896, 4096):
                fft_times = _time_fft(torch, ops, fft4, ref, re, im, stages)
                rec.update(fft_times["fft4_stage"])
            emit(rec)

    # fft4_fused: ops.fft4, one fused launch for rows up to L_MAX, against
    # its plain version (the plain stage chain, fft4_fused_plain) and
    # against the stage kernel's chain, on the same input.  All run the
    # same butterfly on the same values, so equal bits are expected; the
    # check is 1e-5 of the largest output.
    for n in FFT_FUSED_SIZES:
        for rows in (3, 896):
            re = torch.randn(rows, n, device=dev, generator=gen)
            im = torch.randn(rows, n, device=dev, generator=gen)
            before = (fft4.LAUNCHES, fft4.FUSED_LAUNCHES)
            fr, fi = ops.fft4(re, im)
            launched = (fft4.LAUNCHES - before[0],
                        fft4.FUSED_LAUNCHES - before[1])
            pr, pi = fft4.fft4_fused_plain(re, im,
                                           *ops.fused_twiddles(n, dev))
            cr, ci = re, im
            for s in range(fft4.log4(n)):
                cr, ci = fft4.fft4_stage(cr, ci,
                                         *ops._stage_twiddles(n, s, dev))
            err = max((fr - pr).abs().max().item(),
                      (fi - pi).abs().max().item())
            err_chain = max((fr - cr).abs().max().item(),
                            (fi - ci).abs().max().item())
            tol = 1e-5 * max(pr.abs().max().item(), pi.abs().max().item())
            if launched != (0, 1) or not max(err, err_chain) <= tol:
                raise AssertionError(
                    f"ops.fft4 ({rows}, {n}): launches (stage, fused) "
                    f"{launched}, max abs err {err} (plain), {err_chain} "
                    f"(stage chain) > {tol}")
            rec = {"phase": "kernel", "name": "fft4_fused",
                   "shape": [rows, n], "launches": 1, "max_abs_err": err,
                   "bit_equal": bool(torch.equal(fr, pr)
                                     and torch.equal(fi, pi)),
                   "max_abs_err_vs_stage_chain": err_chain,
                   "bit_equal_to_stage_chain": bool(
                       torch.equal(fr, cr) and torch.equal(fi, ci)),
                   "tol": tol}
            if (rows, n) == (896, 4096):
                rec.update(fft_times["fft4_fused"])
                summary["fft4_fused"] = rec
            emit(rec)
    # A row above L_MAX: stage launches, then the fused kernel over the
    # sub-transforms; against the plain stage chain over whole rows at
    # 1e-5 of the largest output, and against torch.fft at
    # test_fft4_vs_numpy's tolerance.
    rows, n = FFT_LONG
    lead, length = fft4.fft4_plan(n)
    re = torch.randn(rows, n, device=dev, generator=gen)
    im = torch.randn(rows, n, device=dev, generator=gen)
    before = (fft4.LAUNCHES, fft4.FUSED_LAUNCHES)
    fr, fi = ops.fft4(re, im)
    launched = (fft4.LAUNCHES - before[0], fft4.FUSED_LAUNCHES - before[1])
    want = torch.fft.fft(torch.complex(re.double(), im.double()))[
        :, ref.digit_reverse_indices(n, device=dev)]
    if launched != (lead, 1):
        raise AssertionError(f"ops.fft4 ({rows}, {n}): launches {launched}, "
                             f"expected {(lead, 1)}")
    pr, pi = re, im
    for s in range(fft4.log4(n)):
        pr, pi = fft4.fft4_stage_plain(pr, pi,
                                       *ops._stage_twiddles(n, s, dev))
    err = max((fr - pr).abs().max().item(), (fi - pi).abs().max().item())
    tol = 1e-5 * max(pr.abs().max().item(), pi.abs().max().item())
    if not err <= tol:
        raise AssertionError(f"ops.fft4 ({rows}, {n}): max abs err {err} "
                             f"against the plain chain > {tol}")
    torch.testing.assert_close(fr.double(), want.real, rtol=1e-3, atol=2e-3)
    torch.testing.assert_close(fi.double(), want.imag, rtol=1e-3, atol=2e-3)
    emit({"phase": "kernel", "name": "fft4_fused", "shape": [rows, n],
          "plan": {"stage_launches": lead, "fused_length": length},
          "max_abs_err": err, "tol": tol,
          "bit_equal": bool(torch.equal(fr, pr) and torch.equal(fi, pi)),
          "max_abs_err_vs_torch_fft": max(
              (fr.double() - want.real).abs().max().item(),
              (fi.double() - want.imag).abs().max().item()),
          "tol_vs_torch_fft": {"rtol": 1e-3, "atol": 2e-3}})
    summary["fft4_stage"] = _lead_stage(torch, fft4, ops, ref, re, im)
    emit(summary["fft4_stage"])

    # matmul: the reference's test shapes, shapes that reach every path of
    # the kernel (one row; 31, 33 and 65 rows around its 32-row tile; K
    # past its four-stage ring and off its 16-k chunks; N off the float4
    # grid at the 5G width) and the 5G beamforming shape, in both dtypes.
    # Tolerance: the reference's float32 test bound (rtol 1e-4, atol 1e-4
    # sqrt(K)); bf16 inputs convert to float32 exactly in both, so only
    # the summation order differs.  The 5G shape is timed in turns with
    # torch.matmul in device time (TF32 off), the others eagerly.
    torch.backends.cuda.matmul.allow_tf32 = False
    shapes = ((8, 16, 8), (100, 60, 72), (256, 512, 128), (129, 257, 65),
              (1, 64, 57344), (31, 64, 4096), (33, 64, 1000),
              (65, 100, 4100), (32, 64, 57343), MM_5G)
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
            b_ms, b_by = bound(*matmul_work(m, k, n, x.element_size()), name)
            args = cold_copies(x, w)
            rec = {"phase": "kernel", "name": "matmul", "shape": [m, k, n],
                   "dtype": name, "max_abs_err": err,
                   "tol": {"rtol": 1e-4, "atol": 1e-4 * k ** 0.5},
                   "plain_ms": cuda_ms(matmul.matmul_plain, args, iters=5),
                   "library": "torch.matmul (output in the input dtype, "
                              "TF32 off)",
                   "bound_ms": b_ms, "bound_by": b_by}
            if (m, k, n) == MM_5G:
                rec.update(in_turns(matmul.matmul, torch.matmul, args))
                rec["ratio_to_library"] = rec["ms"] / rec["library_ms"]
                if dtype == torch.float32:
                    summary["matmul"] = rec
            else:
                rec.update(ms=cuda_ms(matmul.matmul, args),
                           library_ms=cuda_ms(torch.matmul, args))
            emit(rec)
    emit(matmul_layout_checks(torch, matmul, gen))
    emit({"phase": "kernel", "wall_s": time.perf_counter() - t_phase})
    return summary


def matmul_layout_checks(torch, matmul, gen) -> dict:
    """The one-fmaf-chain design's identities on the card, in float32:
    the first t rows of a call equal the call on x[:t] and its first c
    columns the call on w[:, :c], bit for bit, for t and c on both sides
    of the 32 x 128 block tile and of a warp's 32 columns, and off the
    float4 grid; and x as an offset row slice of a larger tensor, x off
    16-byte alignment, and w off it (the element-wise copy of w), give
    the aligned call's bits."""
    dev = gen.device
    m, k, n = 65, MM_5G[1], MM_5G[2]
    x = torch.randn(m, k, device=dev, generator=gen)
    w = torch.randn(k, n, device=dev, generator=gen)
    full = matmul.matmul(x, w)
    rows = {t: torch.equal(matmul.matmul(x[:t], w), full[:t])
            for t in (1, 31, 32, 33)}
    cols = {c: torch.equal(matmul.matmul(x, w[:, :c]), full[:, :c])
            for c in (5, 33, 127, 129, 1000, n - 1)}
    big = torch.randn(m + 7, k, device=dev, generator=gen)
    big[3:3 + m] = x
    flat_x = torch.empty(m * k + 1, device=dev)
    flat_x[1:].view(m, k).copy_(x)
    flat_w = torch.empty(k * n + 1, device=dev)
    flat_w[1:].view(k, n).copy_(w)
    views = {"x offset rows": torch.equal(matmul.matmul(big[3:3 + m], w),
                                          full),
             "x off 16 bytes": torch.equal(
                 matmul.matmul(flat_x[1:].view(m, k), w), full),
             "w off 16 bytes": torch.equal(
                 matmul.matmul(x, flat_w[1:].view(k, n)), full)}
    if not (all(rows.values()) and all(cols.values())
            and all(views.values())):
        raise AssertionError(f"matmul slices differ from the whole call: "
                             f"rows {rows}, columns {cols}, views {views}")
    return {"phase": "kernel", "name": "matmul", "shape": [m, k, n],
            "check": "rows, columns and offset views equal the whole "
                     "call bit for bit", "rows": list(rows),
            "columns": list(cols), "views": list(views)}


def _lead_stage(torch, fft4, ops, ref, re, im) -> dict:
    """The stage kernel where a path still launches it: stage 0 of
    ``ops.fft4`` over rows above ``fft4.L_MAX``, bit for bit its plain
    version, timed in turns with torch.fft over the same rows (no library
    call runs one stage, so the library entry is the whole transform)."""
    rows, n = re.shape
    wr, wi = ops._stage_twiddles(n, 0, re.device)
    kr, ki = fft4.fft4_stage(re, im, wr, wi)
    pr, pi = fft4.fft4_stage_plain(re, im, wr, wi)
    err = max((kr - pr).abs().max().item(), (ki - pi).abs().max().item())
    if err != 0.0:
        raise AssertionError(f"fft4_stage ({rows}, {n}), stage 0: max abs "
                             f"err {err}, expected equal bits")
    idx = ref.digit_reverse_indices(n, device=re.device)

    def stage(x_re, x_im):
        return fft4.fft4_stage(x_re, x_im, wr, wi)

    def library(x_re, x_im):
        y = torch.fft.fft(torch.complex(x_re, x_im))[:, idx]
        return y.real, y.imag

    args = cold_copies(re, im)
    b_ms, b_by = bound(*fft_stage_work(rows, n), "float32")
    rec = {"phase": "kernel", "name": "fft4_stage", "shape": [rows, n],
           "unit": f"stage 0 of {fft4.log4(n)}, the lead stage launch of "
                   f"ops.fft4 over ({rows}, {n})",
           "max_abs_err": err, "tol": 0.0,
           **in_turns(stage, library, args),
           "plain_ms": cuda_ms(lambda a, b: fft4.fft4_stage_plain(a, b, wr,
                                                                  wi),
                               args, iters=5),
           "library": "torch.fft.fft + digit-reversal gather over the same "
                      "rows: the whole transform",
           "bound_ms": b_ms, "bound_by": b_by}
    rec["ratio_to_library"] = rec["ms"] / rec["library_ms"]
    return rec


def _time_fft(torch, ops, fft4, ref, re, im, stages) -> dict:
    """Times of ``ops.fft4`` at the 5G shape, in this call, on the same
    cold copies: the fused kernel (one launch), the stage kernel's chain
    (one launch a stage), the plain chain, and torch.fft plus the
    digit-reversal gather that gives the same output order.  ``ms`` and
    ``library_ms`` are device time (``timing`` "graph": :func:`graph_ms`,
    each measured twice in turns and averaged); ``eager_ms`` and
    ``library_eager_ms`` the same calls issued one by one from Python
    (:func:`cuda_ms`, as every other kernel is timed), the host's launch
    cost included."""
    rows, n = re.shape
    idx = ref.digit_reverse_indices(n, device=re.device)
    twiddles = [ops._stage_twiddles(n, s, re.device) for s in range(stages)]

    def chain(stage_fn, x_re, x_im):
        for wr, wi in twiddles:
            x_re, x_im = stage_fn(x_re, x_im, wr, wi)
        return x_re, x_im

    def stage_chain(x_re, x_im):
        return chain(fft4.fft4_stage, x_re, x_im)

    def library(x_re, x_im):
        y = torch.fft.fft(torch.complex(x_re, x_im))[:, idx]
        return y.real, y.imag

    lr, li = library(re, im)
    kr, ki = ops.fft4(re, im)
    args = cold_copies(re, im)
    order = (("fused", ops.fft4), ("chain", stage_chain),
             ("library", library))
    runs = {name: [] for name, _ in order}
    for name, fn in order + order[::-1]:
        runs[name].append(graph_ms(fn, args))
    ms = {name: sum(v) / len(v) for name, v in runs.items()}
    eager = {name: cuda_ms(fn, args) for name, fn in order}
    plain_ms = cuda_ms(lambda *a: chain(fft4.fft4_stage_plain, *a),
                       args, iters=5)
    # The least traffic of the whole transform: both planes read once and
    # written once, the twiddles read once.  The stage chain moves
    # `stages` times the plane traffic.
    planes = 4 * rows * n * 4
    flops = fft_work(rows, n)[1]
    common = {"plain_ms": plain_ms, "library_ms": ms["library"],
              "library_runs_ms": runs["library"],
              "library_eager_ms": eager["library"],
              "library": "torch.fft.fft + digit-reversal gather",
              "library_max_abs_diff": max((kr - lr).abs().max().item(),
                                          (ki - li).abs().max().item()),
              "timing": "graph"}
    b_ms, b_by = bound(*fft_work(rows, n), "float32")
    fused = dict(common, unit=f"ops.fft4 over ({rows}, {n}): one fused "
                 f"launch", ms=ms["fused"], runs_ms=runs["fused"],
                 eager_ms=eager["fused"],
                 ratio_to_library=ms["fused"] / ms["library"],
                 ratio_to_stage_chain=ms["fused"] / ms["chain"],
                 bound_ms=b_ms, bound_by=b_by)
    b_ms, b_by = bound(planes + sum(2 * wr.numel() * 4
                                    for wr, _ in twiddles), flops, "float32")
    stage = dict(common, unit=f"the stage chain over ({rows}, {n}): "
                 f"{stages} stage launches", ms=ms["chain"],
                 runs_ms=runs["chain"], eager_ms=eager["chain"],
                 ratio_to_library=ms["chain"] / ms["library"],
                 stage_bound_ms=bound(planes, 0.0, "float32")[0],
                 bound_ms=b_ms, bound_by=b_by)
    return {"fft4_fused": fused, "fft4_stage": stage}


def _time_slot(torch, pipeline, ops, matmul, out) -> dict:
    """The slot's device work alone, on cold copies of its inputs already
    on the card: ``slot_ms`` one CUDA graph replay a slot
    (:func:`graph_ms`), ``slot_eager_ms`` the slot called from Python
    (:func:`cuda_ms`); each kernel's device time and share of
    ``slot_ms``; and the slot's bound, the FFT's bytes and operations
    plus both products'."""
    dev = torch.device("cuda")
    args = cold_copies(*(torch.from_numpy(out[key]).to(dev)
                         for key in ("re", "im", "coef")))
    slot_ms = graph_ms(pipeline.slot, args)
    slot_eager_ms = cuda_ms(pipeline.slot, args)
    fft_ms = graph_ms(lambda re, im, coef: ops.fft4(re, im), args)

    def products(fr, fi, coef):
        n_rx = coef.shape[1]
        return (matmul.matmul(coef, fr.reshape(n_rx, -1)),
                matmul.matmul(coef, fi.reshape(n_rx, -1)))

    spectra = [ops.fft4(re, im) + (coef,) for re, im, coef in args]
    mm_ms = graph_ms(products, spectra)
    (rows, n), (n_beams, n_rx) = out["re"].shape, out["coef"].shape
    b_ms, b_by = bound(*slot_work(rows, n, n_beams, n_rx), "float32")
    return {"slot_ms": slot_ms, "slot_eager_ms": slot_eager_ms,
            "kernel_ms": {"fft4_fused": fft_ms, "matmul (both)": mm_ms},
            "share_of_slot_ms": {"fft4_fused": fft_ms / slot_ms,
                                 "matmul (both)": mm_ms / slot_ms},
            "slot_bound_ms": b_ms, "slot_bound_by": b_by,
            "slot_bound_share": b_ms / slot_ms}


def phase_pipeline(torch, pipeline, fft4, matmul, ops) -> dict:
    """The 5G slot, counted: one fused FFT launch and two matmuls; then
    the stage kernel's own path, rows above the fused kernel's L_MAX,
    counted apart."""
    fft4.LAUNCHES = 0
    fft4.FUSED_LAUNCHES = 0
    matmul.LAUNCHES = 0
    t0 = time.perf_counter()
    out = pipeline.execute(device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fft4_fused": fft4.FUSED_LAUNCHES, "fft4_stage": fft4.LAUNCHES,
                "matmul": matmul.LAUNCHES}
    errs = pipeline.check(out)
    if launches != {"fft4_fused": 1, "fft4_stage": 0, "matmul": 2}:
        raise AssertionError(f"main path launches {launches}, expected "
                             f"1 fft4_fused and 2 matmul")
    emit({"phase": "fiveg_pipeline", "rows": list(out["re"].shape),
          "beams": list(out["beams_r"].shape), "wall_s": wall,
          "wall_s_covers": "numpy input generation, the copy to the "
                           "device and the slot",
          "launches": launches, "max_abs_err": errs,
          "tol": {"fft": [pipeline.FFT_RTOL, pipeline.FFT_ATOL],
                  "matmul_rtol": pipeline.MM_RTOL,
                  "matmul_atol": pipeline.MM_ATOL_PER_SQRT_K
                  * out["coef"].shape[1] ** 0.5},
          **_time_slot(torch, pipeline, ops, matmul, out)})

    rows, n = FFT_LONG
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(15)
    re = torch.randn(rows, n, device=dev, generator=gen)
    im = torch.randn(rows, n, device=dev, generator=gen)
    fft4.LAUNCHES = 0
    fft4.FUSED_LAUNCHES = 0
    ops.fft4(re, im)
    torch.cuda.synchronize()
    long_launches = {"fft4_stage": fft4.LAUNCHES,
                     "fft4_fused": fft4.FUSED_LAUNCHES}
    lead = fft4.fft4_plan(n)[0]
    if long_launches != {"fft4_stage": lead, "fft4_fused": 1}:
        raise AssertionError(f"ops.fft4 ({rows}, {n}) launches "
                             f"{long_launches}")
    emit({"phase": "fiveg_pipeline", "path": f"ops.fft4 over ({rows}, {n}), "
          f"above L_MAX", "launches": long_launches})
    launches["fft4_stage"] = long_launches["fft4_stage"]
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


def phase_fig7(torch, fiveg, fig7, prng, ref_values) -> list:
    """The Fig. 7 grid through ``repro_torch.examples.fig7`` (every mode
    of ``MODES`` at each point) against the reference values, then claim
    C4.  Returns the driver's grid rows."""
    ref = ref_values["fig7"]
    if ((ref["key"], ref["radix"]) != (fig7.KEY, fig7.RADIX)
            or [(r["n_rx"], r["ffts_per_round"]) for r in ref["rows"]]
            != list(fig7.GRID)):
        raise AssertionError("fig7 driver and reference values disagree "
                             "on the grid")
    t_phase = time.perf_counter()
    points = fig7.grid("cuda", modes=MODES)
    for p, row in zip(points, ref["rows"]):
        got = {}
        for mode in MODES:
            res, want = p["res"][mode], row[mode]
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
              "compare_barriers_s": {"steady": p["steady_us"] / 1e6,
                                     "first": p["first_us"] / 1e6,
                                     "modes": len(MODES)}})
    rows = fig7.grid_rows(points)
    emit({"phase": "fig7", "driver": "repro_torch.examples.fig7",
          "rows": len(rows), "wall_s": time.perf_counter() - t_phase})

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
          "sync_fraction_partial_64x4": frac})
    return rows


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


def levels_before_tree(leaves: int, radix: int, cap: int) -> int:
    """The per-level launches ``ops.dotp`` runs over ``leaves`` partials
    before their count fits the tree kernel's ``cap``."""
    pre = 0
    while leaves > cap:
        leaves, pre = -(-leaves // radix), pre + 1
    return pre


def chunked_partials(torch, ref, x, y, chunk: int = 1 << 27) -> tuple:
    """``ref.dotp_partials(x, y)`` and the leaves' limits of
    :func:`dotp_limits`, taken over leaf-aligned chunks of ``chunk``
    elements so that a 2 Gi-element product needs little memory."""
    parts, lims = [], []
    for i in range(0, x.numel(), chunk):
        u, v = x[i:i + chunk], y[i:i + chunk]
        parts.append(ref.dotp_partials(u, v))
        lims.append(dotp_limits(ref, u, v)[0])
    return torch.cat(parts), torch.cat(lims)


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
    ``ops.axpy`` at every size, and ``ops.dotp`` above the tree kernel's
    cap, with the launch counts of that run; then each kernel against its
    plain version, the fused tree against the per-level chain, and the
    times.  Returns the summary records and the launch counts."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    big = max(DOTP_SIZES)
    x32 = torch.randn(big, device=dev, generator=gen)
    y32 = torch.randn(big, device=dev, generator=gen)
    xb, yb = x32.to(torch.bfloat16), y32.to(torch.bfloat16)
    xh = torch.randn(DOTP_ABOVE_CAP, device=dev, generator=gen,
                     dtype=torch.bfloat16)
    yh = torch.randn(DOTP_ABOVE_CAP, device=dev, generator=gen,
                     dtype=torch.bfloat16)
    tree_radices = [r for r in DOTP_RADICES if r > 1]
    pre = {r: levels_before_tree(dotp.leaf_count(DOTP_ABOVE_CAP), r,
                                 dotp.TREE_MAX) for r in tree_radices}
    if min(pre.values()) < 1:
        raise AssertionError(f"{DOTP_ABOVE_CAP} elements do not pass the "
                             f"tree's cap of {dotp.TREE_MAX} leaves")

    # The path, counted: every call a user would make, nothing else.
    for k in dotp.LAUNCHES:
        dotp.LAUNCHES[k] = 0
    axpy.LAUNCHES = 0
    results = {}
    for n in DOTP_SIZES:
        for r in DOTP_RADICES:
            results[("dotp", n, r)] = ops.dotp(x32[:n], y32[:n], radix=r)
    for r in DOTP_RADICES:
        results[("dotp above cap", r)] = ops.dotp(xh, yh, radix=r)
    for n in AXPY_SIZES:
        for name, (x, y) in (("float32", (x32, y32)),
                             ("bfloat16", (xb, yb))):
            results[("axpy", n, name)] = ops.axpy(1.7, x[:n], y[:n])
    torch.cuda.synchronize()
    launches = dict(dotp.LAUNCHES, axpy=axpy.LAUNCHES)
    # A tree is two launches, leaves and levels; above the cap each
    # level run before the count fits is one more.
    trees = [(n, r) for n in DOTP_SIZES + (DOTP_ABOVE_CAP,)
             for r in tree_radices]
    want = {"dotp_central": len(DOTP_SIZES) + 1, "dotp_partials": len(trees),
            "combine_partials": sum(levels_before_tree(
                dotp.leaf_count(n), r, dotp.TREE_MAX) for n, r in trees),
            "combine_tree": len(trees), "axpy": 2 * len(AXPY_SIZES)}
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
              "levels": {r: ops.dotp_levels(n, r) for r in DOTP_RADICES},
              "launches_per_call": {r: 1 if r <= 1 else 2
                                    for r in DOTP_RADICES},
              "max_abs_err": max(errs), "tol": tol})
    # Above the cap: against the plain chain over the same leaves, the
    # leaves' limits taken over leaf-aligned chunks (bounded memory).
    plain_parts, leaf_lim = chunked_partials(torch, ref, xh, yh)
    tol = leaf_lim.square().sum().sqrt().item()
    errs = [check_sum(results[("dotp above cap", r)].item(),
                      (plain_parts.sum() if r <= 1 else
                       dotp.combine_tree_plain(plain_parts, r)).item(),
                      tol, f"ops.dotp n={DOTP_ABOVE_CAP} radix={r}")
            for r in DOTP_RADICES]
    emit({"phase": "dotp_axpy", "op": "ops.dotp", "n": DOTP_ABOVE_CAP,
          "dtype": "bfloat16", "leaves": dotp.leaf_count(DOTP_ABOVE_CAP),
          "tree_max": dotp.TREE_MAX,
          "launches_per_call": {r: 1 if r <= 1 else 2 + pre[r]
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
                "plain_ms": cuda_ms(axpy.axpy_plain, args),
                "library": "torch.add(y, x, alpha=a)",
                "bound_ms": b_ms, "bound_by": b_by,
                **in_turns(axpy.axpy,
                           lambda a, u, v: torch.add(v, u, alpha=a), args)})
            rec["ratio_to_library"] = rec["ms"] / rec["library_ms"]
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
                   "ms": cuda_ms(dotp.dotp_partials, args),
                   "plain_ms": cuda_ms(dotp.dotp_partials_plain,
                                       args),
                   "library_ms": cuda_ms(
                       lambda u, v: torch.einsum(
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
                   "ms": cuda_ms(dotp.dotp_central, args),
                   "plain_ms": cuda_ms(dotp.dotp_central_plain,
                                       args),
                   "library_ms": cuda_ms(torch.dot, args),
                   "library": "torch.dot",
                   "bound_ms": b_ms, "bound_by": b_by}
            if (n, name) == (big, "float32"):
                summary["dotp_central"] = rec
            emit(rec)

    # The fused tree against the chain of per-level launches, bit for
    # bit, at the path's 2048 leaves and above the cap.
    parts = dotp.dotp_partials(x32, y32)
    big_parts = dotp.dotp_partials(xh, yh)
    for p in (parts, big_parts):
        for r in tree_radices:
            chain = p
            while chain.numel() > 1:
                chain = dotp.combine_partials(chain, r)
            if not torch.equal(dotp.combine_tree(p, r), chain[0]):
                raise AssertionError(f"combine_tree over {p.numel()} "
                                     f"partials at radix {r} differs from "
                                     f"the per-level chain")
    emit({"phase": "dotp_axpy", "check": "combine_tree equals the chain of "
          "combine_partials launches", "partials": [parts.numel(),
                                                    big_parts.numel()],
          "radices": tree_radices, "bit_equal": True})
    del big_parts, plain_parts, leaf_lim

    # One tree level at the 64 Mi leaf count, and the whole tree; device
    # time (graph) and eager, each beside its library call in that mode.
    pcopies = cold_copies(parts)
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

        def level(p, k=r):
            return dotp.combine_partials(p, k)

        def library(p, k=r):
            return p.view(-1, k).sum(dim=1)

        rec = {"phase": "dotp_axpy", "name": "combine_partials",
               "n": parts.numel(), "radix": r, "max_abs_err": err,
               "tol": tol, "max_share_of_limit": share,
               "plain_ms": cuda_ms(dotp.combine_partials_plain,
                                   [(parts, r)]),
               "library": "tensor.view(-1, radix).sum(dim=1)",
               "bound_ms": b_ms, "bound_by": b_by}
        if parts.numel() % r == 0:
            rec.update(in_turns(level, library, pcopies))
        else:
            rec.update(timing="graph", library_ms=None,
                       library_eager_ms=None,
                       ms=graph_ms(level, pcopies),
                       eager_ms=cuda_ms(level, pcopies))
        if r == 32:
            summary["combine_partials"] = rec
        emit(rec)
    for r in (2, 32):
        got = dotp.combine_tree(parts, r)
        plain = dotp.combine_tree_plain(parts, r)
        levels = ops.dotp_levels(big, r)
        # Each level within 1e-6 of its groups' sums |partial|: at most
        # levels * 1e-6 * sum |partial| in all.
        tol = levels * 1e-6 * parts.abs().sum().item()
        err = check_sum(got.item(), plain.item(), tol,
                        f"combine_tree radix {r}")
        b_ms, b_by = bound(4 * (parts.numel() + 1), parts.numel(),
                           "float32")
        rec = {"phase": "dotp_axpy", "name": "combine_tree",
               "n": parts.numel(), "radix": r, "levels": levels,
               "max_abs_err": err, "tol": tol,
               "plain_ms": cuda_ms(dotp.combine_tree_plain,
                                   [(parts, r)]),
               "library": "tensor.sum()", "bound_ms": b_ms,
               "bound_by": b_by,
               "unit": f"one launch: all {levels} levels over "
                       f"{parts.numel()} leaves",
               **in_turns(lambda p, k=r: dotp.combine_tree(p, k),
                          lambda p: p.sum(), pcopies)}
        if r == 2:
            summary["combine_tree"] = rec
        emit(rec)

    def plain_chain(x, y, r):
        if r <= 1:
            return ref.dotp_central(x, y)
        return dotp.combine_tree_plain(ref.dotp_partials(x, y), r)

    for n in (1 << 20, big):
        args = cold_copies(x32[:n], y32[:n])
        emit({"phase": "dotp_axpy", "op": "ops.dotp chain", "n": n,
              "launches": {r: 1 if r <= 1 else 2 for r in DOTP_RADICES},
              "graph_ms": {r: graph_ms(lambda u, v, k=r: ops.dotp(
                  u, v, radix=k), args) for r in DOTP_RADICES},
              "eager_ms": {r: cuda_ms(lambda u, v, k=r: ops.dotp(
                  u, v, radix=k), args) for r in DOTP_RADICES},
              "plain_ms": {r: cuda_ms(lambda u, v, k=r: plain_chain(
                  u, v, k), args) for r in DOTP_RADICES},
              "library_graph_ms": graph_ms(torch.dot, args),
              "library_eager_ms": cuda_ms(torch.dot, args),
              "library": "torch.dot",
              "bound_ms": bound(8 * n, 2.0 * n, "float32")[0]})
    emit({"phase": "dotp_axpy", "launches": launches,
          "wall_s": time.perf_counter() - t_phase})
    return summary, launches


def phase_fig5(torch, fig5, workloads, figure_rows, ref_values) -> None:
    """Fig. 5 through ``repro_torch.examples.fig5``: every kernel's gap
    bit for bit and median to rtol 1e-6 against the reference values,
    and claim C5."""
    t0 = time.perf_counter()
    ref = ref_values["fig5"]
    if ref["key"] != fig5.KEY:
        raise AssertionError("fig5 driver and reference values disagree "
                             "on the key")
    points = fig5.suite("cuda")
    gaps = {}
    for p in points:
        name, arr = p["name"], p["arrivals"]
        if arr.shape != (1024,) or not torch.isfinite(arr).all():
            raise AssertionError(f"Fig. 5 {name}: bad arrivals")
        want = ref["kernels"][name]
        if p["gap"] != want["gap"]:
            raise AssertionError(f"Fig. 5 {name}: gap {p['gap']} != "
                                 f"{want['gap']}")
        np.testing.assert_allclose(p["p50"], want["p50"], rtol=1e-6)
        gaps[name] = p["gap"]
    # C5, as tests/test_barrier_sim.py::test_kernel_cdf_shapes holds it.
    suite = workloads.benchmark_suite()
    pick = {k: gaps[f"{k}_{max(dims)}"] for k, dims in suite.items()}
    if not (pick["axpy"] < pick["dotp"] and pick["dotp"] > 900
            and pick["conv2d"] > pick["axpy"]):
        raise AssertionError(f"C5 does not hold: {pick}")
    rows = fig5.rows(points)
    figure_rows.write("fig5", rows, "cuda")
    emit({"phase": "fig5", "driver": "repro_torch.examples.fig5",
          "rows": len(rows), "gap": gaps, "c5": pick, "bit_exact": True,
          "draw_s": {"steady_max": max(p["steady_us"] for p in points) / 1e6,
                     "first_max": max(p["first_us"] for p in points) / 1e6},
          "wall_s": time.perf_counter() - t0})


def phase_fig6(torch, fig6, figure_rows, ref_values) -> None:
    """The 7-radix x 15-kernel grid through
    ``repro_torch.examples.fig6``: exit times bit for bit, residencies,
    best radices, fractions and speedups against the reference values."""
    t0 = time.perf_counter()
    ref = ref_values["fig6"]
    if (ref["key"], tuple(ref["radices"])) != (fig6.KEY, fig6.RADICES):
        raise AssertionError("fig6 driver and reference values disagree "
                             "on the grid")
    g = fig6.grid("cuda")
    res = g["res"]
    if list(res.kernels) != ref["kernels"]:
        raise AssertionError(f"Fig. 6 kernels {res.kernels}")
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
    rows = fig6.rows(g)
    figure_rows.write("fig6", rows, "cuda")
    emit({"phase": "fig6", "driver": "repro_torch.examples.fig6",
          "rows": len(rows), "grid": list(res.exit_time.shape),
          "best_radix": dict(zip(ref["kernels"], radix)),
          "speedup": dict(zip(ref["kernels"], speedup)),
          "sweep_s": {"steady": g["steady_us"] / 1e6,
                      "first": g["first_us"] / 1e6},
          "wall_s": time.perf_counter() - t0})


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


def phase_fig7_tuned(torch, fig7, figure_rows, ref_values,
                     grid_rows) -> None:
    """The five tuner modes of the 5G app at (16, 1) and (64, 4) through
    ``repro_torch.examples.fig7`` against the reference values; writes
    the driver's record (the grid rows of the fig7 phase and the tuned
    trees)."""
    ref = ref_values["fig7_tuned"]
    if ref["key"] != fig7.KEY:
        raise AssertionError("fig7 driver and reference values disagree "
                             "on the key")
    tuned_rows = None
    for row in ref["rows"]:
        app = (row["n_rx"], row["ffts_per_round"])
        results, walls, got = {}, {}, {}
        for mode in TUNED_MODES:
            t0 = time.perf_counter()
            results.update(fig7.tuned_modes("cuda", app=app, modes=(mode,)))
            torch.cuda.synchronize()
            walls[mode] = time.perf_counter() - t0
            res, want = results[mode], row[mode]
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
        if app == fig7.TUNED_APP:
            tuned_rows = fig7.tuned_schedule_rows(results)
        emit({"phase": "fig7_tuned", "n_rx": row["n_rx"],
              "ffts_per_round": row["ffts_per_round"], "modes": got,
              "wall_s": walls})
    figure_rows.write("fig7", grid_rows + tuned_rows, "cuda")


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
    ref = ref_values["prng_original"]
    key = prng.PRNGKey(ref["key"])
    off = {}
    with prng.threefry_partitionable(False):
        off["split"] = int(prng.split(key, 3).cpu().ne(torch.tensor(
            ref["split"])).sum().item())
        for want in ref["draws"]:
            shape = tuple(want["shape"])
            for name in ("uniform", "normal"):
                got = getattr(prng, name)(key, shape).cpu()
                off[f"{name}{list(shape)}"] = int(got.view(torch.int32).ne(
                    torch.tensor(want[name], dtype=torch.float32)
                    .view(torch.int32)).sum().item())
            off[f"bernoulli{list(shape)}"] = int(
                prng.bernoulli(key, 0.3, shape).cpu().ne(
                    torch.tensor(want["bernoulli"])).sum().item())
    emit({"phase": "normal", "stream": "original", "draws_off": off})
    if any(off.values()):
        raise AssertionError(f"the original threefry stream on the card "
                             f"differs from JAX's: {off}")


def pareto_base_range(workloads) -> tuple:
    """Bit patterns ``(first, last)`` of every float32 base the Pareto
    straggler tail can hand to ``powf`` on a 64-, 256- or 1024-PE
    machine: ``c - u * d`` for ``u`` in [0, 1), ``c = lo^-1.5``,
    ``d = lo^-1.5 - hi^-1.5`` (float32), ``lo`` the model's work per PE
    and ``hi = 256 lo``; widened by 16 ulps at each end."""
    lows, highs = [], []
    for n in (64, 256, 1024):
        lo = ((1 << 18) / n) * workloads.COSTS.axpy_per_elem
        hi = 256.0 * lo
        c = np.float32(lo ** -1.5)
        d = np.float32(lo ** -1.5 - hi ** -1.5)
        lows.append(c - d)
        highs.append(c)
    first = int(np.float32(min(lows)).view(np.int32)) - 16
    last = int(np.float32(max(highs)).view(np.int32)) + 16
    return first, last


def phase_powf(torch, powf, prng, workloads, ref_values) -> tuple:
    """The kernel against the host's C library over every reachable base,
    then the straggler model's draws on the card, counted.  Returns the
    summary record and the launch count of the draws."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    y = -1.0 / 1.5
    first, last = pareto_base_range(workloads)
    mismatches, host_s = 0, 0.0
    for lo in range(first, last + 1, POWF_CHUNK):
        hi = min(last + 1, lo + POWF_CHUNK)
        t0 = time.perf_counter()
        want = powf.powf_plain(
            torch.from_numpy(np.arange(lo, hi, dtype=np.int32)
                             .view(np.float32)), y)
        host_s += time.perf_counter() - t0
        x = torch.arange(lo, hi, dtype=torch.int32, device=dev).view(
            torch.float32)
        got = powf.powf(x, y)
        mismatches += int((got.view(torch.int32)
                           != want.to(dev).view(torch.int32)).sum().item())
    n_bases = last - first + 1
    libc = os.confstr("CS_GNU_LIBC_VERSION")
    emit({"phase": "powf", "check": "every reachable base", "bases": n_bases,
          "first": float(np.int32(first).view(np.float32)),
          "last": float(np.int32(last).view(np.float32)),
          "exponent": float(np.float32(y)), "differing": mismatches,
          "host_libc": libc, "host_libm_s": host_s})
    if mismatches:
        raise AssertionError(f"powf kernel differs from the host's {libc} "
                             f"powf on {mismatches} of {n_bases} bases")

    # The path, counted: the straggler model's draws, as a user makes them.
    ref = ref_values["straggler_pareto"]
    powf.LAUNCHES = 0
    draws = workloads.arrival_batch(prng.PRNGKey(ref["key"]),
                                    STRAGGLER_KERNEL, tuple(ref["shape"]))
    torch.cuda.synchronize()
    launches = powf.LAUNCHES
    want = torch.tensor(ref["values"], dtype=torch.float32)
    off = int((draws.cpu().view(torch.int32) != want.view(torch.int32))
              .sum().item())
    ran_on = (f"{draws.device.type} kernel csrc/powf.cu"
              if launches == 1 and draws.device.type == "cuda" else "host")
    emit({"phase": "powf", "draws": list(draws.shape), "launches": launches,
          "pow_ran_on": ran_on, "draws_off": off})
    if launches != 1 or draws.device.type != "cuda" or off:
        raise AssertionError(f"straggler_pareto on the card: {launches} powf "
                             f"launches, {off} draws differ from JAX")

    # Times: the model's base count and a large block.
    summary = None
    gen = torch.Generator(device=dev).manual_seed(11)
    c = np.float32(((1 << 18) / 1024 * 3.0) ** -1.5)
    # FP64-pipe instructions and 64-bit conversions a base, from the
    # kernel's SASS; 8 bytes moved a base.
    fp64, conversions = powf.fp64_work()
    for n in (math.prod(ref["shape"]), POWF_CHUNK):
        x = c * (1.0 - 0.99 * torch.rand(n, device=dev, generator=gen))
        got = powf.powf(x, y)
        err = (got - powf.powf_plain(x, y)).abs().max().item()
        args = [(t, y) for (t,) in cold_copies(x)]
        rec = {"phase": "powf", "name": "powf", "n": n, "max_abs_err": err,
               "tol": "bit for bit",
               **in_turns(powf.powf, torch.pow, args),
               "plain_ms": cuda_ms(powf.powf_plain, args, iters=3,
                                   warmup=1),
               "library": "torch.pow (not the C library's rounding)",
               "fp64_per_base": fp64, "conversions_per_base": conversions,
               **fp64_bound(8.0 * n, fp64 * n, conversions * n)}
        if err != 0.0:
            raise AssertionError(f"powf n={n}: kernel != C library ({err})")
        if summary is None:
            summary = rec
        emit(rec)
    emit({"phase": "powf", "wall_s": time.perf_counter() - t_phase})
    return summary, launches


def phase_faults(torch, bench_faults, prng, tuning, ref_values,
                 bench) -> None:
    """The N = 1024 degradation sweep against the JAX reference values,
    and on the original threefry stream against ``BENCH_faults.json``."""
    ref = ref_values["faults"]
    t0 = time.perf_counter()
    record, res, i_lat = bench_faults.degradation_sweep(device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    names = list(res.names)
    robust = [c["robust_tuned"]["schedule"] for c in record["curve"]]
    if (names != ref["names"] or names[i_lat] != ref["latency_winner"]
            or robust != ref["robust_winners"]):
        raise AssertionError(f"fault sweep winners {names[i_lat]}, {robust}")
    prefix = res.span_cycles[:, :, :len(ref["span_prefix"][0][0])].cpu()
    if not torch.equal(prefix, torch.tensor(ref["span_prefix"],
                                            dtype=torch.float32)):
        raise AssertionError("fault sweep spans differ from the reference")
    p99 = tuning._objective_grid(res, "p99_cycles")
    if not np.array_equal(p99, np.asarray(ref["p99_cycles"], np.float32)):
        raise AssertionError("fault sweep p99 spans differ")
    for got, key in ((res.mean_span, "mean_cycles"),
                     (res.completion_rate, "completion_rate"),
                     (res.abandoned_pes.to(torch.float32).mean(dim=-1),
                      "abandoned_pes_mean")):
        np.testing.assert_allclose(got.cpu().numpy(), ref[key], rtol=1e-6,
                                   err_msg=key)
    if record != ref["record"]:
        raise AssertionError("fault sweep record differs from the JAX one")
    # BENCH_faults.json was drawn from the original threefry stream, not
    # today's partitionable one: on today's stream its claims must hold,
    # and on its own stream its numbers (below).
    file_curve = bench["degradation"]["curve"]
    claims = {
        "robust_beats_latency_at_1pct":
            record["robust_beats_latency_at_1pct"]
            == bench["degradation"]["robust_beats_latency_at_1pct"],
        "winners_as_file": [(c["latency_tuned"]["schedule"],
                             c["robust_tuned"]["schedule"])
                            for c in record["curve"]]
        == [(c["latency_tuned"]["schedule"], c["robust_tuned"]["schedule"])
            for c in file_curve]}
    if not all(claims.values()):
        raise AssertionError(f"fault sweep claims fail: {claims}")
    # The file was drawn from the original threefry stream: on it the
    # port reproduces the file.
    t1 = time.perf_counter()
    with prng.threefry_partitionable(False):
        original, _, _ = bench_faults.degradation_sweep(device="cuda")
    torch.cuda.synchronize()
    original_wall = time.perf_counter() - t1
    if original != bench["degradation"]:
        raise AssertionError(
            f"fault sweep on the original stream != BENCH_faults.json: "
            f"{original['curve']} != {file_curve}")
    emit({"phase": "faults", "grid": list(res.span_cycles.shape),
          "latency_winner": names[i_lat], "robust_winners": robust,
          "p99_improvement": [c["p99_improvement"] for c in record["curve"]],
          "file_p99_improvement": [c["p99_improvement"] for c in file_curve],
          "p99_cycles": [[c["latency_tuned"]["p99_cycles"],
                          c["robust_tuned"]["p99_cycles"]]
                         for c in record["curve"]],
          "file_p99_cycles": [[c["latency_tuned"]["p99_cycles"],
                               c["robust_tuned"]["p99_cycles"]]
                              for c in file_curve],
          "equals_reference": True, "file_claims": claims,
          "original_stream_equals_file": True,
          "original_p99_improvement": [c["p99_improvement"]
                                       for c in original["curve"]],
          "wall_s": wall, "original_wall_s": original_wall})


def phase_fiveg_faults(torch, bench_faults, prng, ref_values,
                       bench) -> None:
    ref = ref_values["fiveg_faults"]
    t0 = time.perf_counter()
    record, curve = bench_faults.fiveg_degradation(device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for mode in bench_faults.FIVEG_MODES:
        for rate, res, want in zip(ref["rates"], curve[mode], ref[mode]):
            for c in ("total_cycles", "completion_rate", "timed_out_levels"):
                if getattr(res, c).item() != np.float32(want[c]):
                    raise AssertionError(
                        f"5G {mode} at {rate}: {c} {getattr(res, c).item()} "
                        f"!= {want[c]}")
            for c in ("sync_fraction", "sync_energy"):
                np.testing.assert_allclose(getattr(res, c).item(), want[c],
                                           rtol=1e-5, err_msg=c)
    t1 = time.perf_counter()
    with prng.threefry_partitionable(False):
        original, _ = bench_faults.fiveg_degradation(device="cuda")
    torch.cuda.synchronize()
    original_wall = time.perf_counter() - t1
    if original != bench["fiveg"]:
        raise AssertionError(f"5G degradation on the original stream != "
                             f"BENCH_faults.json: {original}")
    cols = ("total_cycles", "completion_rate", "timed_out_levels")
    emit({"phase": "fiveg_faults",
          **{c: {m: [r[c] for r in record[m]]
                 for m in bench_faults.FIVEG_MODES} for c in cols},
          **{f"file_{c}": {m: [r[c] for r in bench["fiveg"][m]]
                           for m in bench_faults.FIVEG_MODES} for c in cols},
          "equals_reference": True,
          "original_stream_equals_file": True,
          "original_timed_out_levels": {
              m: [r["timed_out_levels"] for r in original[m]]
              for m in bench_faults.FIVEG_MODES},
          "wall_s": wall, "original_wall_s": original_wall,
          "wall_s_per_simulate_app": wall / (len(ref["rates"]) * len(
              bench_faults.FIVEG_MODES))})


def phase_fig4b(torch, fig4, ref_values) -> None:
    """Fig. 4b from the fig4a sweep and claim C3 against the reference
    values; residencies are means over PEs and trials, held to rtol
    1e-6 (torch sums in another order than XLA)."""
    ref = ref_values["fig4b"]
    t0 = time.perf_counter()
    res, steady_us, first_us = fig4.run_sweep("cuda")
    rows = fig4.fig4b(res)
    if len(rows) != len(ref["rows"]):
        raise AssertionError(f"Fig. 4b has {len(rows)} rows, the stored "
                             f"section {len(ref['rows'])}")
    for row, want in zip(rows, ref["rows"]):
        if (row["delay"], row["radix"]) != (want["delay"], want["radix"]):
            raise AssertionError(f"Fig. 4b best radix {row} != {want}")
        np.testing.assert_allclose(row["mean_residency"],
                                   want["mean_residency"], rtol=1e-6)
    c3 = fig4.claim_c3("cuda")
    if len(c3) != len(ref["c3"]["rows"]):
        raise AssertionError(f"C3 has {len(c3)} rows, the stored section "
                             f"{len(ref['c3']['rows'])}")
    for row, want in zip(c3, ref["c3"]["rows"]):
        if (row["delay"], row["band"]) != (want["delay"], want["band"]):
            raise AssertionError(f"C3 row {row} != stored {want}")
        np.testing.assert_allclose(list(row["costs"].values()),
                                   want["costs"], rtol=1e-6)
    if not all(r["holds"] for r in c3):
        raise AssertionError(f"C3 does not hold: {c3}")
    emit({"phase": "fig4b", "rows": rows,
          "c3": [{k: r[k] for k in ("delay", "sfr_needed", "band", "holds")}
                 for r in c3],
          "sweep_steady_us": steady_us, "sweep_first_us": first_us,
          "wall_s": time.perf_counter() - t0})


def phase_multicluster(torch, bench_multicluster, barrier, prng, sweep,
                       ref_values, bench) -> None:
    """The stored hierarchical stacks bit for bit, then the benchmark's
    machines against ``BENCH_multicluster.json``."""
    ref = ref_values["multicluster"]
    t0 = time.perf_counter()
    for want in ref["stacks"]:
        n = want["n_pes"]
        cfg = bench_multicluster.machine(n)
        arr = ref["delay"] * prng.uniform(prng.PRNGKey(ref["key"]),
                                          (ref["n_trials"], n))
        scheds = [barrier.mixed_radix_tree(c, cfg=cfg)
                  for c in want["sizes"]]
        res = sweep.sweep_arrivals(arr, scheds, cfg)
        widths = list(barrier.telescope_widths(
            barrier.stack_tables(scheds, cfg), n))
        if [s.name for s in scheds] != want["names"] or \
                widths != want["widths"]:
            raise AssertionError(f"N={n} stack {want['names']}: names or "
                                 f"widths {widths} differ")
        for f in ("exit_time", "span_cycles"):
            if not torch.equal(getattr(res, f)[:, 0].cpu(), torch.tensor(
                    want[f], dtype=torch.float32)):
                raise AssertionError(f"N={n} stack {want['names']}: {f} "
                                     f"differs from the reference values")
    emit({"phase": "multicluster", "reference_stacks": len(ref["stacks"]),
          "bit_exact": True, "wall_s": time.perf_counter() - t0})
    for n in bench_multicluster.NS:
        t1 = time.perf_counter()
        got = bench_multicluster.bench_machine(n, "cuda")
        wall = time.perf_counter() - t1
        want = bench[f"N={n}"]
        simulated = {
            "n_schedules": (got["n_schedules"], want["n_schedules"]),
            "points": (got["sweep"]["points"], want["sweep"]["points"]),
            "hier_vs_flat": (got["hier_vs_flat"], want["hier_vs_flat"]),
            "sum_tight": (got["widths"]["sum_tight"],
                          want["widths"]["sum_tight"]),
            "sum_fallback": (got["widths"]["sum_fallback"],
                             want["widths"]["sum_fallback"])}
        bad = {k: v for k, v in simulated.items() if v[0] != v[1]}
        if bad:
            raise AssertionError(f"N={n} != BENCH_multicluster.json: {bad}")
        emit({"phase": "multicluster", "n_pes": n,
              "n_schedules": got["n_schedules"],
              "hier_vs_flat": got["hier_vs_flat"],
              "sum_tight": got["widths"]["sum_tight"],
              "sum_fallback": got["widths"]["sum_fallback"],
              "equals_file": True, "sweep": got["sweep"],
              "width_timing": {k: got["widths"][k]
                               for k in ("tight", "fallback", "speedup")},
              "sharding": got["sharding"], "wall_s": wall})


def phase_energy(torch, bench_energy, bench) -> None:
    """The energy benchmark's sections against ``BENCH_energy.json``."""
    t0 = time.perf_counter()
    got, wall = {}, {}
    got["energy_per_barrier"], wall["energy_per_barrier"] = \
        bench_energy.energy_per_barrier(device="cuda")
    got["pareto"], wall["pareto"] = bench_energy.pareto(device="cuda")
    got["fiveg"], wall["fiveg"] = bench_energy.fiveg_energy(device="cuda")
    for name, value in got.items():
        emit({"phase": "energy", "section": name, "record": value,
              "equals_file": value == bench[name], "wall_us": wall[name]})
    bad = [name for name, value in got.items() if value != bench[name]]
    if bad:
        raise AssertionError(f"energy sections {bad} != BENCH_energy.json")
    emit({"phase": "energy", "wall_s": time.perf_counter() - t0})


def phase_figures(drivers, figure_rows, ref_values) -> None:
    """The beyond-figure drivers (``fig_placement``, ``fig_tuned_tree``,
    ``fig_workload_tuned``) on the card: each row's name and derived
    value equal to the reference values' section of the same name."""
    for name, driver in drivers.items():
        t0 = time.perf_counter()
        rows = driver.run("cuda")
        wall = time.perf_counter() - t0
        got = [[r[0], r[2]] for r in rows]
        want = ref_values[name]["rows"]
        if [g[0] for g in got] != [w[0] for w in want]:
            raise AssertionError(f"{name}: row names differ from the "
                                 f"reference")
        off = [(g, w[1]) for g, w in zip(got, want) if g[1] != w[1]]
        figure_rows.write(name, rows, "cuda")
        emit({"phase": "figures", "driver": f"repro_torch.examples.{name}",
              "rows": len(rows), "rows_off": off, "wall_s": wall,
              "timed_s": {r[0]: {"steady": r[1] / 1e6, "first": r[3] / 1e6}
                          for r in rows if r[1]}})
        if off:
            raise AssertionError(f"{name}: {len(off)} rows differ from the "
                                 f"reference: {off[:5]}")


def phase_resilience(torch, barrier, fiveg, prng, sweep, ref_values) -> None:
    """The resumable sweep runtime on the card: the Fig. 4a grid (10
    radices x 4 delays x 1024 trials at N = 1024) in 8 chunks of 128
    trials, preempted before chunk 4 and resumed from its store, bit for
    bit the plain ``sweep_schedules`` in the same chunks; the same for
    ``resilient_sweep_arrivals`` over 2 x 1024 arrival vectors; then
    ``fiveg``'s tuned mode read twice through a schedule cache, the
    second read a hit with the same cycles."""
    import shutil
    from repro_torch.runtime import (FaultPlan, Preemption,
                                     ResilienceConfig, SimulatedFault,
                                     resilient_sweep_arrivals,
                                     resilient_sweep_schedules,
                                     schedule_cache)
    t_phase = time.perf_counter()
    ref = ref_values["fig4a"]
    n, trials, chunk = ref["n_pes"], RESILIENCE_TRIALS, RESILIENCE_CHUNK
    key = prng.PRNGKey(ref["key"])
    scheds = [barrier.kary_tree(r, n_pes=n) for r in barrier.all_radices(n)]
    work = ROOT / "build" / "resilience"
    shutil.rmtree(work, ignore_errors=True)

    def resumed(kind, run, plain, kill_at):
        rc = ResilienceConfig(ckpt_dir=str(work / kind), trial_chunk=chunk)
        plan = FaultPlan(faults={kill_at: Preemption()})
        t0 = time.perf_counter()
        try:
            run(rc, plan)
            raise AssertionError(f"{kind}: the preemption never fired")
        except SimulatedFault:
            killed = time.perf_counter() - t0
        t0 = time.perf_counter()
        rep = run(rc, plan)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        same = {f: torch.equal(getattr(rep.result, f), getattr(plain, f))
                for f in rep.result._fields
                if isinstance(getattr(plain, f), torch.Tensor)}
        emit({"phase": "resilience", "sweep": kind,
              "grid": list(rep.result.span_cycles.shape),
              "chunks": [rep.chunks_total, rep.chunks_resumed,
                         rep.chunks_computed],
              "killed_run_s": killed, "resumed_run_s": wall,
              "report_wall_s": rep.wall_seconds,
              "ckpt_seconds": rep.ckpt_seconds, "bit_exact": same})
        if (rep.chunks_resumed, rep.chunks_computed) != (
                kill_at, rep.chunks_total - kill_at) or not all(same.values()):
            raise AssertionError(f"{kind}: resumed sweep differs from the "
                                 f"plain one: {same}")

    t0 = time.perf_counter()
    plain = sweep.sweep_schedules(key, scheds, ref["delays"], trials,
                                  trial_chunk=chunk, device="cuda")
    torch.cuda.synchronize()
    emit({"phase": "resilience", "plain_sweep_s": time.perf_counter() - t0})
    resumed("schedules", lambda rc, plan: resilient_sweep_schedules(
        key, scheds, ref["delays"], trials, resilience=rc, fault_plan=plan,
        device="cuda"), plain, 4)
    arrivals = 512.0 * prng.uniform(prng.fold_in(key, 1), (2, trials, n))
    plain = sweep.sweep_arrivals(arrivals, scheds, trial_chunk=chunk)
    resumed("arrivals", lambda rc, plan: resilient_sweep_arrivals(
        arrivals, scheds, resilience=rc, fault_plan=plan, device="cuda"),
        plain, 5)

    # fiveg's tuned mode through an on-disk schedule cache: the first read
    # tunes and stores, the second (a fresh in-process store) reads the
    # file.  The lookup is timed apart from the app it serves.
    app = fiveg.FiveGConfig(n_rx=16, ffts_per_round=1)
    reads = []
    os.environ[schedule_cache.CACHE_ENV] = str(work / "schedule_cache")
    try:
        for _ in range(2):
            fiveg._tuned_schedule.cache_clear()
            schedule_cache.reset_stats()
            t0 = time.perf_counter()
            fiveg._tuned_schedule(n, app.epoch_jitter, False, fiveg.DEFAULT,
                                  "cuda")
            lookup = time.perf_counter() - t0
            stats = dict(schedule_cache.STATS)
            t0 = time.perf_counter()
            res = fiveg.simulate_app(prng.PRNGKey(3), app, sync="tuned",
                                     device="cuda")
            torch.cuda.synchronize()
            reads.append({"lookup_s": lookup,
                          "app_s": time.perf_counter() - t0,
                          "total_cycles": res.total_cycles.item(),
                          "stage": res.stage_schedule, **stats})
    finally:
        del os.environ[schedule_cache.CACHE_ENV]
        fiveg._tuned_schedule.cache_clear()
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "resilience", "schedule_cache": reads,
          "wall_s": time.perf_counter() - t_phase})
    first, second = reads
    if (first["stores"], second["hits"], second["misses"]) != (1, 1, 0) \
            or second["total_cycles"] != first["total_cycles"]:
        raise AssertionError(f"schedule cache: {reads}")


def phase_serving(torch, serving, fiveg, prng, sweep, tuning, powf,
                  drivers, figure_rows, ref_values) -> int:
    """The tuning-serving daemon on the card at full width (N = 1024,
    hierarchy-pruned compositions), then the serving, resilience and core
    benchmark drivers at their reference sizes.  Returns the ``powf``
    launches of the kernel requests' draws."""
    import shutil
    import threading
    from repro_torch.runtime import (DeviceLoss, FaultPlan,
                                     ResilienceConfig, SimulatedOOM)
    t_phase = time.perf_counter()
    ref = ref_values["serving"]
    dev = torch.device("cuda")
    n = ref["n_pes"]
    scheds = tuning.all_schedules(n, prune=ref["prune"])
    work = ROOT / "build" / "serving"
    shutil.rmtree(work, ignore_errors=True)
    key = prng.PRNGKey(SERVING_TRACE_KEY)

    def trace(i: int, trials: int = 4) -> "torch.Tensor":
        return 300.0 * prng.uniform(prng.fold_in(key, i), (trials, n))

    def server(*, start=False, fault_plan=None, devices=None, **kw):
        kw.setdefault("batch_window", ref["batch_window"])
        return serving.TuningServer(serving.ServerConfig(**kw), start=start,
                                    device=dev, fault_plan=fault_plan,
                                    devices=devices)

    # (a) The stored kernel requests, submitted from a client thread
    # before the worker starts, so they coalesce; the Pareto straggler's
    # draw runs the powf kernel on that thread, the worker sweeps it.
    srv = server()
    tickets, client_launches = [], []

    def client():
        before = powf.LAUNCHES
        tickets.extend(srv.submit(serving.TuneRequest(
            kernel=r["kernel"], objective=r["objective"]))
            for r in ref["requests"])
        client_launches.append(powf.LAUNCHES - before)

    powf.LAUNCHES = 0
    t0 = time.perf_counter()
    thread = threading.Thread(target=client, name="serving-client")
    thread.start()
    thread.join(timeout=SERVING_TIMEOUT_S)
    if thread.is_alive() or len(tickets) != len(ref["requests"]):
        raise AssertionError("serving: the client thread did not submit")
    digests = {p.label: serving._trace_digest(p.arrivals)
               for p in srv._queue}
    srv.start()
    resps = [t.result(timeout=SERVING_TIMEOUT_S) for t in tickets]
    torch.cuda.synchronize()
    wall_a = time.perf_counter() - t0
    launches = powf.LAUNCHES
    bad = []
    for r, want in zip(resps, ref["requests"]):
        got = {"provenance": r.provenance, "tier": r.tier,
               "batch_size": r.batch_size, "name": r.name,
               "mean_span": r.mean_span}
        if got != {k: want[k] for k in got} or not math.isclose(
                r.mean_energy, want["mean_energy"], rel_tol=1e-6):
            bad.append({"got": {**got, "mean_energy": r.mean_energy},
                        "want": want})
    emit({"phase": "serving", "check": "kernel requests", "n_pes": n,
          "requests": len(resps), "batches": srv.stats.batches,
          "powf_launches": launches,
          "powf_launches_on_client_thread": client_launches[0],
          "digests_equal": digests == ref["digests"], "mismatches": bad,
          "wall_s": wall_a})
    if bad or digests != ref["digests"] or srv.stats.batches != 1 \
            or launches < 1 or client_launches[0] != launches:
        raise AssertionError(f"serving (a): {bad}, digests {digests}, "
                             f"{launches} powf launches")

    # (c) The ladder: a resubmission is a cache hit; an expired deadline
    # is the stored closed-form pick per objective.
    hit = srv.tune(serving.TuneRequest(kernel=ref["requests"][0]["kernel"],
                                       objective=ref["requests"][0]
                                       ["objective"]), timeout=SERVING_TIMEOUT_S)
    fallback = {}
    for i, (objective, want) in enumerate(ref["fallback"].items()):
        r = srv.tune(serving.TuneRequest(arrivals=trace(900 + i),
                                         deadline=0.0, objective=objective),
                     timeout=SERVING_TIMEOUT_S)
        fallback[objective] = {"provenance": r.provenance, "tier": r.tier,
                               "name": r.name, "mean_span": r.mean_span,
                               "mean_energy": r.mean_energy}
        if (r.provenance, r.tier) != ("degraded", "fallback") or {
                k: fallback[objective][k] for k in want} != want:
            raise AssertionError(f"serving fallback {objective}: "
                                 f"{fallback[objective]} != {want}")
    srv.close()
    if (hit.provenance, hit.tier) != ("cache_hit", "cache"):
        raise AssertionError(f"serving: resubmission gave {hit}")

    # (b) Batched against unbatched: 8 fresh traces in one dispatch equal
    # 8 single sweeps, every field bit for bit.
    traces = [trace(100 + i) for i in range(8)]
    srv = server(max_batch=8)
    tickets = [srv.submit(serving.TuneRequest(arrivals=t)) for t in traces]
    srv.start()
    resps = [t.result(timeout=SERVING_TIMEOUT_S) for t in tickets]
    srv.close()
    same = [all(torch.equal(getattr(r.result, f),
                            getattr(sweep.sweep_arrivals(t, scheds), f))
                for f in sweep.BarrierResult._fields)
            for t, r in zip(traces, resps)]
    emit({"phase": "serving", "check": "batched equals unbatched",
          "batches": srv.stats.batches,
          "efficiency": srv.stats.batch_efficiency, "bit_exact": same})
    if not all(same) or srv.stats.batches != 1:
        raise AssertionError(f"serving (b): {same}, {srv.stats}")

    # (c) A DeviceLoss mid-batch under a ResilienceConfig loses no
    # request; the breaker trips, then a probe closes it.
    rcfg = ResilienceConfig(ckpt_dir=str(work / "chunks"), trial_chunk=1,
                            backoff_base=0.0, backoff_cap=0.0)
    plan = FaultPlan(faults={1: DeviceLoss(1)})
    srv = server(fault_plan=plan, devices=[dev, dev], resilience=rcfg,
                 backoff_base=0.0, backoff_cap=0.0)
    lossy = [trace(200 + i) for i in range(2)]
    tickets = [srv.submit(serving.TuneRequest(arrivals=t)) for t in lossy]
    srv.start()
    resps = [t.result(timeout=SERVING_TIMEOUT_S) for t in tickets]
    srv.close()
    kept = [r.provenance == "batched" and torch.equal(
        r.result.span_cycles, sweep.sweep_arrivals(t, scheds).span_cycles)
        for t, r in zip(lossy, resps)]
    loss_faults = dict(srv.stats.faults)
    plan = FaultPlan(faults={0: SimulatedOOM(), 1: SimulatedOOM()})
    srv = server(start=True, fault_plan=plan, max_batch_retries=0,
                 breaker_threshold=1, breaker_probe_after=0.0,
                 backoff_base=0.0, backoff_cap=0.0)
    breaker = []
    for i in range(3):
        r = srv.tune(serving.TuneRequest(arrivals=trace(300 + i)),
                     timeout=SERVING_TIMEOUT_S)
        breaker.append([r.provenance, srv.breaker_state])
    srv.close()
    shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "serving", "check": "ladder",
          "resubmission": [hit.provenance, hit.tier], "fallback": fallback,
          "device_loss": {"exact_and_equal": kept, "faults": loss_faults},
          "breaker": breaker})
    if not all(kept) or loss_faults.get("DeviceLoss", 0) < 1:
        raise AssertionError(f"serving: device loss lost a request: {kept}")
    if [b[0] for b in breaker] != ["degraded", "degraded", "batched"] \
            or breaker[0][1] == "closed" or breaker[2][1] != "closed":
        raise AssertionError(f"serving: breaker {breaker}")

    # (d) fiveg's client mode: the tuned modes through the server, one
    # dispatch each, equal to the inline run.
    app = fiveg.FiveGConfig(n_rx=16, ffts_per_round=1)
    client_mode = {}
    for sync in ("workload", "pareto"):
        inline = fiveg.simulate_app(prng.PRNGKey(3), app, sync=sync)
        with server(start=True) as srv:
            with fiveg.tuning_server(srv):
                served = fiveg.simulate_app(prng.PRNGKey(3), app, sync=sync)
        client_mode[sync] = {
            "batches": srv.stats.batches,
            "stage": [served.stage_schedule, inline.stage_schedule],
            "global": [served.global_schedule, inline.global_schedule],
            "total_cycles": [served.total_cycles.item(),
                             inline.total_cycles.item()]}
        if srv.stats.batches != 1 or served.stage_schedule != \
                inline.stage_schedule or served.global_schedule != \
                inline.global_schedule or not torch.equal(
                    served.total_cycles, inline.total_cycles):
            raise AssertionError(f"fiveg client mode {sync}: "
                                 f"{client_mode[sync]}")
    emit({"phase": "serving", "check": "fiveg client mode", **client_mode})

    # (e) The drivers at their reference sizes, their records written.
    records = {}
    for name, mod in drivers.items():
        t0 = time.perf_counter()
        records[name] = figure_rows.write_record(mod.measure("cuda"),
                                                 mod.OUT)
        emit({"phase": "serving", "driver": name, "record": records[name],
              "wall_s": time.perf_counter() - t0})
    seq = records["serving"]
    if seq["sequential_stats"]["exact"] != seq["n_requests"] \
            or seq["batch_efficiency_req_per_dispatch"] != 8.0:
        raise AssertionError(f"bench_serving: {seq}")
    if not records["resilience"]["recovery"]["resumed_equals_plain"]:
        raise AssertionError("bench_resilience: the resumed sweep differs "
                             "from the plain one")
    cores = [e["cores_equal"] for k, g in records["core"].items()
             if k.startswith("N=") for e in g.values()]
    if not all(cores):
        raise AssertionError(f"bench_core: scan and telescope differ: "
                             f"{records['core']}")
    emit({"phase": "serving", "wall_s": time.perf_counter() - t_phase})
    return launches


def phase_dct_conv2d(torch, ops, dct, conv2d) -> tuple:
    """``ops.dct`` and ``ops.conv2d`` at the suite's sizes, counted; each
    kernel against its plain version; the times at the suite's DCT sizes
    and the large sizes.  Returns the summary records and the launch
    counts."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(9)
    xs = {s: torch.randn(*s, device=dev, generator=gen) for s in DCT_SIZES}
    imgs = {s: torch.randn(*s, device=dev, generator=gen) for s in CONV_SIZES}
    k = torch.randn(3, 3, device=dev, generator=gen)

    # The path, counted: the suite's inputs, as a user transforms them.
    dct.LAUNCHES = 0
    conv2d.LAUNCHES = 0
    out = {("dct", s): ops.dct(x) for s, x in xs.items()}
    out.update({("conv2d", s): ops.conv2d(img, k) for s, img in imgs.items()})
    torch.cuda.synchronize()
    launches = {"dct": dct.LAUNCHES, "conv2d": conv2d.LAUNCHES}
    if launches != {"dct": len(DCT_SIZES), "conv2d": len(CONV_SIZES)}:
        raise AssertionError(f"dct/conv2d path launches {launches}")
    for s, x in xs.items():
        plain = dct.dct_plain(x, ops.dct_basis_t(s[1], dev))
        np.testing.assert_allclose(out[("dct", s)].cpu().numpy(),
                                   plain.cpu().numpy(), rtol=1e-3, atol=1e-3)
        emit({"phase": "dct_conv2d", "op": "ops.dct", "shape": list(s),
              "max_abs_err": (out[("dct", s)] - plain).abs().max().item(),
              "tol": {"rtol": 1e-3, "atol": 1e-3}})
    for s, img in imgs.items():
        plain = conv2d.conv2d_plain(img, k)
        np.testing.assert_allclose(out[("conv2d", s)].cpu().numpy(),
                                   plain.cpu().numpy(), rtol=1e-4, atol=1e-5)
        emit({"phase": "dct_conv2d", "op": "ops.conv2d", "shape": list(s),
              "max_abs_err": (out[("conv2d", s)] - plain).abs().max().item(),
              "bit_equal": bool(torch.equal(out[("conv2d", s)], plain)),
              "tol": {"rtol": 1e-4, "atol": 1e-5}})

    # Every row is one FMA chain in increasing k whatever tile its call's
    # row count picks: the suite's rows of a large call equal the same
    # rows alone, bit for bit.  Then bf16 and f16 rows, and a ragged
    # shape, against the plain version.
    summary = {}
    t, n = DCT_LARGE
    x = torch.randn(t, n, device=dev, generator=gen)
    bt = ops.dct_basis_t(n, dev)
    got = dct.dct(x, bt)
    for rows, _ in DCT_SIZES:
        if not torch.equal(dct.dct(x[:rows], bt), got[:rows]):
            raise AssertionError(f"dct: the first {rows} rows of a ({t}, "
                                 f"{n}) call differ from the same rows alone")
    emit({"phase": "dct_conv2d", "check": "dct rows independent of the "
          "tile", "rows": [r for r, _ in DCT_SIZES], "of": [t, n],
          "bit_equal": True})
    for shape in (DCT_LARGE, (300, 1000)):
        xr = (x if shape == DCT_LARGE
              else torch.randn(*shape, device=dev, generator=gen))
        basis = ops.dct_basis_t(shape[1], dev)
        for dtype in (torch.bfloat16, torch.float16):
            xd = xr.to(dtype)
            got_d, plain_d = dct.dct(xd, basis), dct.dct_plain(xd, basis)
            np.testing.assert_allclose(got_d.cpu().numpy(),
                                       plain_d.cpu().numpy(),
                                       rtol=1e-3, atol=1e-3)
            emit({"phase": "dct_conv2d", "op": "dct", "shape": list(shape),
                  "dtype": str(dtype).split(".")[1],
                  "max_abs_err": (got_d - plain_d).abs().max().item(),
                  "tol": {"rtol": 1e-3, "atol": 1e-3}})
        del xd, got_d, plain_d
    plain = dct.dct_plain(x, bt)
    np.testing.assert_allclose(got.cpu().numpy(), plain.cpu().numpy(),
                               rtol=1e-3, atol=1e-3)
    large = {"max_abs_err": (got - plain).abs().max().item(),
             "plain_ms": cuda_ms(dct.dct_plain, [(x, bt)], iters=2,
                                 warmup=1)}
    del got, plain
    # Times at the suite's shapes and the large one, each beside
    # torch.matmul in the same mode.
    for rows, n in DCT_SIZES + (DCT_LARGE,):
        xr = xs[(rows, n)] if (rows, n) in xs else x
        args = cold_copies(xr, bt)
        b_ms, b_by = bound(4.0 * (2 * rows * n + n * n), 2.0 * rows * n * n,
                           "float32")
        rec = {"phase": "dct_conv2d", "name": "dct", "shape": [rows, n],
               "tol": {"rtol": 1e-3, "atol": 1e-3},
               "library": "torch.matmul(x, basis_t), float32 (TF32 off)",
               "library_max_abs_diff": (dct.dct(xr, bt) - torch.matmul(
                   xr, bt)).abs().max().item(),
               "bound_ms": b_ms, "bound_by": b_by,
               **in_turns(dct.dct, torch.matmul, args)}
        if (rows, n) == DCT_LARGE:
            rec.update(large)
            summary["dct"] = rec
        else:
            rec["max_abs_err"] = (out[("dct", (rows, n))] - dct.dct_plain(
                xr, bt)).abs().max().item()
        emit(rec)
        del args
    del x

    img = torch.randn(*CONV_LARGE, device=dev, generator=gen)
    px = img.numel()
    got = conv2d.conv2d(img, k)
    plain = conv2d.conv2d_plain(img, k)
    np.testing.assert_allclose(got.cpu().numpy(), plain.cpu().numpy(),
                               rtol=1e-4, atol=1e-5)

    def library(u, w):
        return torch.nn.functional.conv2d(u[:, None], w[None, None],
                                          padding=1)[:, 0]

    args = cold_copies(img, k)
    b_ms, b_by = bound(8.0 * px + 36, 17.0 * px, "float32")
    summary["conv2d"] = {
        "phase": "dct_conv2d", "name": "conv2d", "shape": list(CONV_LARGE),
        "max_abs_err": (got - plain).abs().max().item(),
        "bit_equal": bool(torch.equal(got, plain)),
        "tol": {"rtol": 1e-4, "atol": 1e-5},
        "ms": cuda_ms(conv2d.conv2d, args),
        "plain_ms": cuda_ms(conv2d.conv2d_plain, args, iters=5),
        "library_ms": cuda_ms(library, args),
        "library": "F.conv2d on (B, 1, H, W), padding=1 (cuDNN, TF32 off)",
        "library_max_abs_diff": (got - library(img, k)).abs().max().item(),
        "bound_ms": b_ms, "bound_by": b_by}
    emit(summary["conv2d"])
    emit({"phase": "dct_conv2d", "launches": launches,
          "wall_s": time.perf_counter() - t_phase})
    return summary, launches


def _top2_margin(logits):
    top = logits.double().topk(2, dim=-1).values
    return top[..., 0] - top[..., 1]


def row_scaled_err(got, want) -> float:
    """The largest, over query rows, of a row's max |got - want| over its
    max |want|: the error at the scale of each row's output."""
    diff = (got.float() - want.float()).abs().amax(dim=-1)
    return (diff / want.float().abs().amax(dim=-1)).max().item()


def check_bf16_rows(flash_attn, q, k, v, causal, got, want,
                    scale=None, window=0) -> dict:
    """``got`` (the kernel in bf16) against float32 attention on the same
    bf16 inputs at :data:`FA_BF16_ROW_TOL`, with the plain bf16 version's
    error beside it; raises past the limit."""
    ref32 = flash_attn.flash_attention_plain(q.float(), k.float(), v.float(),
                                             causal=causal, scale=scale,
                                             window=window)
    rec = {"row_scaled_err": row_scaled_err(got, ref32),
           "plain_row_scaled_err": row_scaled_err(want, ref32),
           "row_tol": FA_BF16_ROW_TOL}
    if not rec["row_scaled_err"] <= FA_BF16_ROW_TOL:
        raise AssertionError(f"flash_attention bf16 {list(q.shape)}: row "
                             f"error {rec['row_scaled_err']} over "
                             f"{FA_BF16_ROW_TOL} of the row's scale")
    return rec


def fa_grid_checks(torch, flash_attn, q, k, v, causal, got, scale=None,
                   window=0) -> dict:
    """The wgmma kernel's persistent grid on these inputs: its plan
    (``flash_attn.fwd_plan``), a second launch the same bits as ``got``,
    and the same items in the other order on its own grid the same bits;
    raises otherwise."""
    b, h, s, d = q.shape
    dv = v.shape[3]
    sms = flash_attn.sm_count(torch.cuda.current_device())
    plan = flash_attn.fwd_plan(b, h, s, k.shape[2], d, dv, bool(causal),
                               window, sms)
    other = plan.reordered(1 - plan.order, sms)
    out = torch.empty_like(got)
    flash_attn.launch(q, k, v, out, None, d ** -0.5 if scale is None
                      else scale, causal, window, other)
    rec = {"plan": {"rows": plan.rows, "keys": plan.keys,
                    "order": plan.order, "grid": plan.grid,
                    "rounds": plan.rounds},
           "repeat_bits_equal": torch.equal(flash_attn.flash_attention(
               q, k, v, causal=causal, scale=scale, window=window), got),
           "other_order_bits_equal": torch.equal(out, got)}
    if not (rec["repeat_bits_equal"] and rec["other_order_bits_equal"]):
        raise AssertionError(f"flash_attention {list(q.shape)}: the grid's "
                             f"bits move {rec}")
    return rec


def fa_planted_faults(flash_attn, q, k, v, causal, got, want,
                      scale=None) -> dict:
    """Three faults the bf16 limits must catch: one 64-key tile's values
    left out of PV (its weights still in the row sum), the last 16
    features left out of QK^T (a k16 step dropped), the last 16 output
    features zeroed.  Each must exceed :data:`FA_BF16_ROW_TOL`; whether
    :data:`FA_BF16_TOL` alone would have caught it is recorded."""
    ref32 = flash_attn.flash_attention_plain(q.float(), k.float(), v.float(),
                                             causal=causal, scale=scale)
    mid = k.shape[2] // 2
    v_gap = v.clone()
    v_gap[:, :, mid:mid + 64] = 0
    q_cut = q.clone()
    q_cut[..., -16:] = 0
    zeroed = got.clone()
    zeroed[..., -16:] = 0
    faults = {
        "pv_tile_skipped": flash_attn.flash_attention(
            q, k, v_gap, causal=causal, scale=scale),
        "qk_last_k16_dropped": flash_attn.flash_attention(
            q_cut, k, v, causal=causal, scale=scale),
        "out_last_16_zeroed": zeroed}
    rec = {}
    for name, bad in faults.items():
        err = row_scaled_err(bad, ref32)
        near = ((bad.float() - want.float()).abs()
                <= FA_BF16_TOL * (1 + want.float().abs())).all().item()
        if not err > FA_BF16_ROW_TOL:
            raise AssertionError(f"planted fault {name} passes the bf16 row "
                                 f"check ({err})")
        rec[name] = {"row_scaled_err": err, "passes_fa_bf16_tol": near}
    return rec


def _fa_kernel_checks(torch, flash_attn, build) -> dict:
    """The kernel against its plain version at the test shapes (float32,
    the reference's 2e-3) and at the prefill's shape (bf16), and the
    model's strided layout against contiguous heads; the prefill shape's
    times and the wgmma kernel's resources.  Returns the summary
    record."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(14)
    for s, d in FA_TEST_SHAPES:
        for causal in (True, False):
            q, k, v = (0.5 * torch.randn(2, 2, s, d, device=dev,
                                         generator=gen) for _ in range(3))
            got = flash_attn.flash_attention(q, k, v, causal=causal)
            want = flash_attn.flash_attention_plain(q, k, v, causal=causal)
            torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)
            emit({"phase": "lm_serve", "name": "flash_attention",
                  "shape": [2, 2, s, d], "dtype": "float32",
                  "causal": causal,
                  "max_abs_err": (got - want).abs().max().item(),
                  "tol": {"rtol": 2e-3, "atol": 2e-3}})
    # float32 (the register-tiled FMA kernel) at the configs' widths 80
    # and 192, grouped heads 2 to 1.
    for d in (80, 192):
        for causal in (True, False):
            q = 0.5 * torch.randn(2, 4, 200, d, device=dev, generator=gen)
            k, v = (0.5 * torch.randn(2, 2, 200, d, device=dev,
                                      generator=gen) for _ in range(2))
            got = flash_attn.flash_attention(q, k, v, causal=causal)
            want = flash_attn.flash_attention_plain(q, k, v, causal=causal)
            torch.testing.assert_close(got, want, rtol=FA_F32_TOL,
                                       atol=FA_F32_TOL)
            emit({"phase": "lm_serve", "name": "flash_attention",
                  "shape": [2, 4, 2, 200, d], "dtype": "float32",
                  "causal": causal,
                  "max_abs_err": (got - want).abs().max().item(),
                  "tol": {"rtol": FA_F32_TOL, "atol": FA_F32_TOL}})
    # bf16 at every width, on each of its kernels: FMAs at D 8 and 40,
    # mma.sync at 16 and 32 (the smoke configs), wgmma at 64, 80, 128 and
    # 192; grouped heads 4 to 1, a ragged length.
    for d in flash_attn.HEAD_DIMS:
        for causal in (True, False):
            q = torch.randn(1, 8, 300, d, device=dev, generator=gen).bfloat16()
            k, v = (torch.randn(1, 2, 300, d, device=dev,
                                generator=gen).bfloat16() for _ in range(2))
            got = flash_attn.flash_attention(q, k, v, causal=causal)
            want = flash_attn.flash_attention_plain(q, k, v, causal=causal)
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=FA_BF16_TOL, atol=FA_BF16_TOL)
            emit({"phase": "lm_serve", "name": "flash_attention",
                  "shape": [1, 8, 2, 300, d], "dtype": "bfloat16",
                  "causal": causal,
                  "max_abs_err": (got.float() - want.float()).abs().max()
                  .item(), "tol": {"rtol": FA_BF16_TOL, "atol": FA_BF16_TOL},
                  **check_bf16_rows(flash_attn, q, k, v, causal, got, want)})
    b, h, hk, s, d = FA_PATH_SHAPE
    q = torch.randn(b, h, s, d, device=dev, generator=gen).to(torch.bfloat16)
    k = torch.randn(b, hk, s, d, device=dev, generator=gen).to(torch.bfloat16)
    v = torch.randn(b, hk, s, d, device=dev, generator=gen).to(torch.bfloat16)
    got = flash_attn.flash_attention(q, k, v, causal=True)
    want = flash_attn.flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=FA_BF16_TOL,
                               atol=FA_BF16_TOL)

    def library(q_, k_, v_):
        return torch.nn.functional.scaled_dot_product_attention(
            q_, k_, v_, is_causal=True, enable_gqa=True)

    # The model's layout: (B, S, H, D) tensors seen through transpose(1,
    # 2), read and written in place; the same bits as contiguous heads.
    qs, ks, vs = (t.transpose(1, 2).contiguous().transpose(1, 2)
                  for t in (q, k, v))
    out = torch.empty(b, s, h, d, device=dev, dtype=torch.bfloat16)
    flash_attn.flash_attention(qs, ks, vs, causal=True,
                               out=out.transpose(1, 2))
    if not torch.equal(out.transpose(1, 2), got):
        raise AssertionError("flash_attention on (B, S, H, D) views differs "
                             "from the contiguous call")

    lib = library(q, k, v)
    # The causal half: query row i meets i + 1 keys; two products of
    # 2 D operations per pair.  Bytes: q, k, v read once, out written once.
    b_ms, b_by = bound(2.0 * (q.numel() + k.numel() + v.numel() + q.numel()),
                       4.0 * b * h * d * s * (s + 1) / 2, "bfloat16")
    args = cold_copies(q, k, v)
    ms = cuda_ms(flash_attn.flash_attention, args)
    library_ms = cuda_ms(library, args)
    rec = {"phase": "lm_serve", "name": "flash_attention",
           "shape": [b, h, hk, s, d], "dtype": "bfloat16", "causal": True,
           "max_abs_err": (got.float() - want.float()).abs().max().item(),
           "tol": {"rtol": FA_BF16_TOL, "atol": FA_BF16_TOL},
           "strided_equal": True,
           "grid": fa_grid_checks(torch, flash_attn, q, k, v, True, got),
           "ms": ms,
           "strided_ms": cuda_ms(lambda *a: flash_attn.flash_attention(
               *a, causal=True, out=out.transpose(1, 2)),
               [(qs, ks, vs)]),
           "plain_ms": cuda_ms(flash_attn.flash_attention_plain, args,
                               iters=3, warmup=1),
           "library_ms": library_ms, "ratio_to_library": ms / library_ms,
           "library": "F.scaled_dot_product_attention(is_causal=True, "
                      "enable_gqa=True)",
           "library_max_abs_diff": (got.float() - lib.float()).abs().max()
           .item(),
           "bound_ms": b_ms, "bound_by": b_by,
           "kernel_resources": {
               name: usage for name, usage in fa_resources(
                   build, flash_attn).items()
               if name.startswith("fa_wgmma_kernel")},
           "unit": "one launch: the prefill attention of one layer"}
    emit(rec)
    return rec


def _fa_pair_checks(torch, flash_attn) -> None:
    """The kernel at its (D, Dv) pairs beyond D = Dv (:data:`FA_PAIRS`)
    against its plain version: causal and full, float32 (the FMA kernel)
    and bf16 (``wgmma`` at (192, 128), the FMA kernel at (24, 16)), the
    default scale and :data:`FA_SCALE`, grouped heads 4 to 1 and a ragged
    length; bf16 also against float32 attention row by row, with the
    planted faults, which must fail that check."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(22)
    for d, dv in FA_PAIRS:
        for name in ("float32", "bfloat16"):
            dtype = getattr(torch, name)
            for causal in (True, False):
                for scale in (None, FA_SCALE):
                    q = torch.randn(1, 8, 300, d, device=dev,
                                    generator=gen).to(dtype)
                    k = torch.randn(1, 2, 300, d, device=dev,
                                    generator=gen).to(dtype)
                    v = torch.randn(1, 2, 300, dv, device=dev,
                                    generator=gen).to(dtype)
                    before = flash_attn.LAUNCHES
                    got = flash_attn.flash_attention(q, k, v, causal=causal,
                                                     scale=scale)
                    if flash_attn.LAUNCHES != before + 1:
                        raise AssertionError("flash_attention did not launch")
                    want = flash_attn.flash_attention_plain(
                        q, k, v, causal=causal, scale=scale)
                    tol = FA_F32_TOL if name == "float32" else FA_BF16_TOL
                    torch.testing.assert_close(got.float(), want.float(),
                                               rtol=tol, atol=tol)
                    rows = {}
                    if name == "bfloat16":
                        rows = check_bf16_rows(flash_attn, q, k, v, causal,
                                               got, want, scale)
                        if scale is not None:
                            rows["planted_faults"] = fa_planted_faults(
                                flash_attn, q, k, v, causal, got, want,
                                scale)
                    emit({"phase": "lm_serve", "name": "flash_attention",
                          "shape": [1, 8, 2, 300, [d, dv]], "dtype": name,
                          "causal": causal, "scale": scale,
                          "max_abs_err": (got.float() - want.float()).abs()
                          .max().item(), "tol": {"rtol": tol, "atol": tol},
                          **rows})
    x = torch.zeros(1, 2, 8, 16, device=dev)
    try:
        flash_attn.flash_attention(x, x, torch.zeros(1, 2, 8, 8, device=dev))
    except ValueError:
        emit({"phase": "lm_serve", "check": "unsupported (D, Dv) (16, 8) "
              "raises ValueError"})
    else:
        raise AssertionError("flash_attention took an unsupported (D, Dv)")


def _fa_config_checks(torch, flash_attn, build) -> dict:
    """The kernel at the full-width attention shapes of the configs with
    head widths 192 and 80 and of DeepSeek-V3's MLA, against its plain
    version, and timed beside SDPA (device time and eager) and its bound;
    the resources of the kernels that run those widths (``nvcc -Xptxas
    -v``).  Returns DeepSeek-V3's record (the kernel's summary entry on
    the MLA path)."""
    emit({"phase": "lm_serve", "kernel_resources": {
        name: usage for name, usage in fa_resources(build, flash_attn).items()
        if name.endswith((" d80", " d192", " dv128"))}})
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(16)
    mla = None
    for config, (b, h, hk, s, d, causal, dtypes) in FA_CONFIG_SHAPES.items():
        d, dv = d if isinstance(d, tuple) else (d, d)
        for name in dtypes:
            dtype = getattr(torch, name)
            q = torch.randn(b, h, s, d, device=dev, generator=gen).to(dtype)
            k = torch.randn(b, hk, s, d, device=dev, generator=gen).to(dtype)
            v = torch.randn(b, hk, s, dv, device=dev, generator=gen).to(dtype)
            got = flash_attn.flash_attention(q, k, v, causal=causal)
            want = flash_attn.flash_attention_plain(q, k, v, causal=causal)
            tol = FA_F32_TOL if name == "float32" else FA_BF16_TOL
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=tol)
            rows = {}
            if name == "bfloat16":
                rows = check_bf16_rows(flash_attn, q, k, v, causal, got,
                                       want)
                rows["planted_faults"] = fa_planted_faults(
                    flash_attn, q, k, v, causal, got, want)
                rows["grid"] = fa_grid_checks(torch, flash_attn, q, k, v,
                                              causal, got)

            def kernel(q_, k_, v_, c=causal):
                return flash_attn.flash_attention(q_, k_, v_, causal=c)

            def library(q_, k_, v_, c=causal):
                return torch.nn.functional.scaled_dot_product_attention(
                    q_, k_, v_, is_causal=c, enable_gqa=True)

            b_ms, b_by = bound(*attention_work(b, h, hk, s, s, d, causal,
                                               q.element_size(), dv=dv),
                               name)
            args = cold_copies(q, k, v)
            times = in_turns(kernel, library, args)
            rec = {"phase": "lm_serve", "name": "flash_attention",
                   "config": config, "shape": [b, h, hk, s, [d, dv]],
                   "dtype": name, "causal": causal,
                   "max_abs_err": (got.float() - want.float()).abs().max()
                   .item(), "tol": {"rtol": tol, "atol": tol}, **rows,
                   "library": "F.scaled_dot_product_attention("
                              "enable_gqa=True)",
                   "library_max_abs_diff": (got.float() - library(
                       q, k, v).float()).abs().max().item(),
                   "ratio_to_library": times["ms"] / times["library_ms"],
                   "bound_ms": b_ms, "bound_by": b_by, **times}
            if dv != d:
                rec.update(plain_ms=cuda_ms(flash_attn.flash_attention_plain,
                                            args, iters=3, warmup=1),
                           unit="one launch: the prefill attention of one "
                                "MLA layer")
                mla = rec
            emit(rec)
            del q, k, v, got, want, args
    torch.cuda.empty_cache()
    return mla


def _fa_window_checks(torch, flash_attn) -> dict:
    """The kernel under a sliding window against its plain version: every
    window of :data:`FA_WINDOWS`, causal and not, on each kernel the
    window reaches (:data:`FA_WINDOW_KERNELS`), float32 within
    :data:`FA_F32_TOL` and bf16 within :data:`FA_BF16_TOL` and
    :data:`FA_BF16_ROW_TOL` of each row's scale; planted faults (one key
    too few or too many, no window at all, a tile of values zeroed inside
    the window) must fail both checks; then Hymba-1.5B's prefill attention
    (:data:`FA_WINDOW_SHAPE`, bf16, causal) against its plain version,
    timed in turns with SDPA on an explicit (S, S) boolean mask, beside
    its bound over the pairs the window keeps.  Returns that record."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)
    for d, name in FA_WINDOW_KERNELS:
        dtype = getattr(torch, name)
        tol = FA_F32_TOL if name == "float32" else FA_BF16_TOL
        for causal in (True, False):
            errs, rows = [], []
            for window in FA_WINDOWS:
                q = torch.randn(1, 10, 1100, d, device=dev,
                                generator=gen).to(dtype)
                k, v = (torch.randn(1, 2, 1100, d, device=dev,
                                    generator=gen).to(dtype)
                        for _ in range(2))
                got = flash_attn.flash_attention(q, k, v, causal=causal,
                                                 window=window)
                want = flash_attn.flash_attention_plain(
                    q, k, v, causal=causal, window=window)
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=tol, atol=tol)
                errs.append((got.float() - want.float()).abs().max().item())
                ref32 = flash_attn.flash_attention_plain(
                    q.float(), k.float(), v.float(), causal=causal,
                    window=window)
                rows.append(row_scaled_err(got, ref32))
                if name == "bfloat16" and not rows[-1] <= FA_BF16_ROW_TOL:
                    raise AssertionError(f"window {window} D {d}: row error "
                                         f"{rows[-1]}")
            emit({"phase": "lm_serve", "name": "flash_attention_window",
                  "shape": [1, 10, 2, 1100, d], "dtype": name,
                  "causal": causal, "windows": list(FA_WINDOWS),
                  "max_abs_err_per_window": errs,
                  "row_scaled_err_per_window": rows,
                  "tol": {"rtol": tol, "atol": tol}})
        q = torch.randn(1, 10, 600, d, device=dev, generator=gen).to(dtype)
        k, v = (torch.randn(1, 2, 600, d, device=dev, generator=gen)
                .to(dtype) for _ in range(2))
        got = flash_attn.flash_attention(q, k, v, causal=True, window=64)
        v_gap = v.clone()
        v_gap[:, :, 520:584] = 0
        faults = {f"window {w}": flash_attn.flash_attention_plain(
            q, k, v, causal=True, window=w) for w in (63, 65, 0)}
        faults["v tile zeroed"] = flash_attn.flash_attention_plain(
            q, k, v_gap, causal=True, window=64)
        caught = {}
        for fault, bad in faults.items():
            err = row_scaled_err(got, bad.float())
            close = torch.allclose(got.float(), bad.float(), rtol=tol,
                                   atol=tol)
            if close or not err > FA_BF16_ROW_TOL:
                raise AssertionError(f"planted window fault {fault} passes "
                                     f"(row error {err})")
            caught[fault] = err
        emit({"phase": "lm_serve", "name": "flash_attention_window",
              "check": "planted faults at window 64", "dtype": name,
              "head_dim": d, "row_scaled_err": caught})

    b, h, hk, s, d, window = FA_WINDOW_SHAPE
    q = torch.randn(b, h, s, d, device=dev, generator=gen).bfloat16()
    k = torch.randn(b, hk, s, d, device=dev, generator=gen).bfloat16()
    v = torch.randn(b, hk, s, d, device=dev, generator=gen).bfloat16()
    got = flash_attn.flash_attention(q, k, v, causal=True, window=window)
    want = flash_attn.flash_attention_plain(q, k, v, causal=True,
                                            window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=FA_BF16_TOL,
                               atol=FA_BF16_TOL)
    rows = check_bf16_rows(flash_attn, q, k, v, True, got, want,
                           window=window)
    rows["grid"] = fa_grid_checks(torch, flash_attn, q, k, v, True, got,
                                  window=window)
    lag = (torch.arange(s, device=dev)[:, None]
           - torch.arange(s, device=dev)[None, :])
    mask = (lag >= 0) & (lag < window)

    def kernel(q_, k_, v_):
        return flash_attn.flash_attention(q_, k_, v_, causal=True,
                                          window=window)

    def library(q_, k_, v_):
        return torch.nn.functional.scaled_dot_product_attention(
            q_, k_, v_, attn_mask=mask, enable_gqa=True)

    b_ms, b_by = bound(*attention_work(b, h, hk, s, s, d, True, 2,
                                       window=window), "bfloat16")
    args = cold_copies(q, k, v)
    times = in_turns(kernel, library, args)
    rec = {"phase": "lm_serve", "name": "flash_attention_window",
           "config": "hymba-1.5b", "shape": [b, h, hk, s, d],
           "window": window, "dtype": "bfloat16", "causal": True,
           "max_abs_err": (got.float() - want.float()).abs().max().item(),
           "tol": {"rtol": FA_BF16_TOL, "atol": FA_BF16_TOL}, **rows,
           "plain_ms": cuda_ms(lambda *a: flash_attn.flash_attention_plain(
               *a, causal=True, window=window), args, iters=3, warmup=1),
           "library": "F.scaled_dot_product_attention(attn_mask=(S, S) "
                      "bool, enable_gqa=True)",
           "library_max_abs_diff": (got.float() - library(q, k, v).float())
           .abs().max().item(),
           "ratio_to_library": times["ms"] / times["library_ms"],
           "bound_ms": b_ms, "bound_by": b_by, **times,
           "unit": "one launch: the prefill attention of one hybrid layer"}
    emit(rec)
    return rec


def _scan_inputs(torch, gen, b, s, di, n):
    """Scan inputs as the model makes them: dt = softplus(N(0, 1) - 2),
    x, B, C and the start state N(0, 1), A = -(1 .. n) per channel (the
    ``ssm_a`` init), D N(0, 1)."""
    dev = torch.device("cuda")
    dt = torch.nn.functional.softplus(
        torch.randn(b, s, di, device=dev, generator=gen) - 2.0)
    x = torch.randn(b, s, di, device=dev, generator=gen)
    bm = torch.randn(b, s, n, device=dev, generator=gen)
    cm = torch.randn(b, s, n, device=dev, generator=gen)
    a = -torch.arange(1, n + 1, device=dev, dtype=torch.float32).expand(
        di, n).contiguous()
    d = torch.randn(di, device=dev, generator=gen)
    h0 = torch.randn(b, di, n, device=dev, generator=gen)
    return dt, x, bm, cm, a, d, h0


def scan_resources(build, ssm_scan) -> dict:
    """``ssm_scan_kernel``'s registers, barriers, spills and dynamic
    shared memory at every (lanes, n) it instantiates
    (``ssm_scan.lane_counts`` of each n in ``ssm_scan.STATES``; ``nvcc
    -Xptxas -v`` and the library's ``ssm_scan_smem``), by
    ``"ssm_scan_kernel l{lanes} n{n}"``; raises if an instantiation
    spills, is missing from the log or has no shared memory in the
    library."""
    log = build.compiler_log("ssm_scan")
    lib = build.load("ssm_scan", ssm_scan._SIGNATURES)
    spills = ptxas_spills(log, "ssm_scan_kernel")
    pairs = [(lanes, n) for n in ssm_scan.STATES
             for lanes in ssm_scan.lane_counts(n)]
    usage = {f"ssm_scan_kernel l{lanes} n{n}": dict(
        ptxas_usage(log, f"ssm_scan_kernelILi{lanes}ELi{n}E"),
        dynamic_smem_bytes=lib.ssm_scan_smem(lanes, n))
        for lanes, n in pairs}
    if (len(spills) != len(pairs) or any(spills.values())
            or not all("registers" in u and u["dynamic_smem_bytes"] > 0
                       for u in usage.values())):
        raise AssertionError(f"ssm_scan: spill bytes {spills}, resources "
                             f"{usage}")
    return usage


def _scan_checks(torch, ssm_scan, build) -> dict:
    """The selective-scan kernel: its resources (``nvcc -Xptxas -v``; a
    spill fails the run), then against its plain version at
    :data:`SCAN_TEST_S` (n 8 and 16, 300 channels, a nonzero start state;
    the planned launch and every lane count the kernel has, whose final
    states must equal each other bit for bit) and at the two models'
    prefill shapes (:data:`SCAN_SHAPES`), each timed (device time, a CUDA
    graph replay, and eagerly) beside its launch plan, the plain version
    and its bound.  No single PyTorch call computes the scan, so it has
    no library time.  Returns Falcon-Mamba's record."""
    emit({"phase": "lm_serve", "name": "ssm_scan",
          "kernel_resources": scan_resources(build, ssm_scan)})
    gen = torch.Generator(device="cuda").manual_seed(24)
    for s in SCAN_TEST_S:
        for n in ssm_scan.STATES:
            args = _scan_inputs(torch, gen, 2, s, 300, n)
            wy, wh = ssm_scan.ssm_scan_plain(*args)
            runs = {"plan": ssm_scan.ssm_scan(*args)}
            runs.update((lanes, ssm_scan.launch(*args, lanes))
                        for lanes in ssm_scan.lane_counts(n))
            errs = {}
            for key, (y, h) in runs.items():
                torch.testing.assert_close(y, wy, rtol=SCAN_TOL,
                                           atol=SCAN_TOL)
                torch.testing.assert_close(h, wh, rtol=SCAN_TOL,
                                           atol=SCAN_TOL)
                if not torch.equal(h, runs[1][1]):
                    raise AssertionError(f"ssm_scan: the final states at "
                                         f"{key} lanes differ from 1 lane's")
                errs[str(key)] = max((y - wy).abs().max().item(),
                                     (h - wh).abs().max().item())
            emit({"phase": "lm_serve", "name": "ssm_scan",
                  "shape": [2, s, 300, n],
                  "lanes": ssm_scan.scan_plan(2, 300, n).lanes,
                  "max_abs_err": max(errs.values()),
                  "max_abs_err_by_lanes": errs,
                  "tol": {"rtol": SCAN_TOL, "atol": SCAN_TOL}})
    out = None
    for config, (b, s, di, n) in SCAN_SHAPES.items():
        args = _scan_inputs(torch, gen, b, s, di, n)
        y, h = ssm_scan.ssm_scan(*args)
        wy, wh = ssm_scan.ssm_scan_plain(*args)
        torch.testing.assert_close(y, wy, rtol=SCAN_TOL, atol=SCAN_TOL)
        torch.testing.assert_close(h, wh, rtol=SCAN_TOL, atol=SCAN_TOL)
        err = max((y - wy).abs().max().item(), (h - wh).abs().max().item())
        del y, h, wy, wh
        inputs = cold_copies(*args)
        plan = ssm_scan.scan_plan(b, di, n)
        rec = {"phase": "lm_serve", "name": "ssm_scan", "config": config,
               "shape": [b, s, di, n], "dtype": "float32",
               "plan": {"lanes": plan.lanes, "channels": plan.channels,
                        "blocks": plan.blocks,
                        "warps_per_scheduler": plan.warps_per_scheduler},
               "max_abs_err": err, "tol": {"rtol": SCAN_TOL,
                                           "atol": SCAN_TOL},
               "timing": "graph", "ms": graph_ms(ssm_scan.ssm_scan, inputs),
               "eager_ms": cuda_ms(ssm_scan.ssm_scan, inputs),
               "plain_ms": cuda_ms(ssm_scan.ssm_scan_plain, inputs, iters=2,
                                   warmup=1),
               "library_ms": None, "library_eager_ms": None,
               "library": "none: no single PyTorch call computes the "
                          "selective scan",
               **scan_bound(b, s, di, n),
               "unit": "one launch: the prefill scan of one SSM layer"}
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        emit(rec)
        out = out or rec
        del args, inputs
        torch.cuda.empty_cache()
    return out


def scan_bwd_resources(build, ssm_scan, ssm_scan_bwd) -> dict:
    """The scan backward's resources: ``ssm_scan_bwd_kernel`` (the walk,
    n / 4 lanes a channel) and ``scan_bwd_prepass`` at each n it
    instantiates, the walk with its dynamic shared memory (``nvcc -Xptxas
    -v`` and the library's ``ssm_scan_bwd_smem``), by
    ``"ssm_scan_bwd_kernel n{n}"`` and ``"scan_bwd_prepass n{n}"``;
    raises if any kernel of the library spills or an instantiation is
    missing from the log."""
    log = build.compiler_log("ssm_scan_bwd")
    lib = build.load("ssm_scan_bwd", ssm_scan_bwd._SIGNATURES)
    usage = {f"ssm_scan_bwd_kernel n{n}": dict(
        ptxas_usage(log, f"ssm_scan_bwd_kernelILi{n}E"),
        dynamic_smem_bytes=lib.ssm_scan_bwd_smem(n))
        for n in ssm_scan.STATES}
    usage.update({f"scan_bwd_prepass n{n}": ptxas_usage(
        log, f"scan_bwd_prepassILi{n}E") for n in ssm_scan.STATES})
    spills = ptxas_spills(log, "scan_bwd")
    if (len(spills) != 2 * len(ssm_scan.STATES) + 1
            or any(spills.values())
            or not all("registers" in u for u in usage.values())
            or not all(u["dynamic_smem_bytes"] > 0 for k, u in usage.items()
                       if k.startswith("ssm_scan_bwd_kernel"))):
        raise AssertionError(f"ssm_scan_bwd: spill bytes {spills}, "
                             f"resources {usage}")
    return usage


def _scan_bwd_checks(torch, ssm_scan, ssm_scan_bwd, build) -> dict:
    """The scan's backward: its resources (:func:`scan_bwd_resources`; a
    spill fails the run), then against its plain version (autograd
    through the chunked scan) at :data:`SCAN_BWD_TEST_S` at n 8 and 16
    and every chunk length of the test (one tile and
    ``ssm_scan_bwd.CHUNK_STEPS``), the final state's gradient absent and
    present; the 4-byte staging (:data:`SCAN_BWD_SCALAR`: an odd d_inner,
    operands at storage offset 1) over several chunks; and at the two
    models' training micro-batches
    (:data:`SCAN_BWD_SHAPES`) at every chunk length the plan picks from,
    two runs bit for bit, each gradient to :data:`SCAN_BWD_TOL` of its
    largest element; the training shapes timed at the plan's chunk
    (device time, a CUDA graph replay, and eagerly) beside the plain
    version and the bound.  No PyTorch call computes the scan's gradient,
    so it has no library time.  Returns Falcon-Mamba's record, Hymba's
    beside it."""
    usage = scan_bwd_resources(build, ssm_scan, ssm_scan_bwd)
    pairs = [(lanes, n) for n in ssm_scan.STATES
             for lanes in ssm_scan.lane_counts(n)]
    fwd_log = build.compiler_log("ssm_scan")
    ckpt_usage = {f"ssm_scan_ckpt_kernel l{lanes} n{n}": ptxas_usage(
        fwd_log, f"ssm_scan_ckpt_kernelILi{lanes}ELi{n}E")
        for lanes, n in pairs}
    emit({"phase": "lm_train", "name": "ssm_scan_bwd",
          "kernel_resources": usage, "forward_ckpt_resources": ckpt_usage})
    if not all("registers" in u for u in ckpt_usage.values()):
        raise AssertionError(f"ssm_scan_bwd: the checkpointing forward's "
                             f"resources {ckpt_usage}")
    gen = torch.Generator(device="cuda").manual_seed(30)
    names = ("dt", "x", "B", "C", "A", "D", "h0")

    def inputs(b, s, di, n, with_dh):
        args = _scan_inputs(torch, gen, b, s, di, n)
        dy = torch.randn(b, s, di, device="cuda", generator=gen)
        dh = (torch.randn(b, di, n, device="cuda", generator=gen)
              if with_dh else None)
        ckpt = torch.empty(b, ssm_scan_bwd.checkpoints(s), di, n,
                           device="cuda")
        ssm_scan.ssm_scan(*args, ckpt=ckpt)
        return args, dy, dh, ckpt

    def errors(got, want, what):
        errs = {k: _scaled_err(g, w) for k, g, w in zip(names, got, want)}
        if max(errs.values()) > SCAN_BWD_TOL:
            raise AssertionError(f"ssm_scan_bwd {what}: {errs}")
        return errs

    chunks = (16,) + tuple(ssm_scan_bwd.CHUNK_STEPS)
    worst = 0.0
    for s in SCAN_BWD_TEST_S:
        for n in ssm_scan.STATES:
            for with_dh in (False, True):
                args, dy, dh, ckpt = inputs(2, s, 200, n, with_dh)
                want = ssm_scan_bwd.ssm_scan_bwd_plain(*args, dy, dh)
                for chunk in chunks:
                    got = ssm_scan_bwd.ssm_scan_bwd(*args, dy, dh,
                                                    ckpt=ckpt, chunk=chunk)
                    errs = errors(got, want, f"(2, {s}, 200, {n}) at chunk "
                                  f"{chunk}, dh {with_dh}")
                    worst = max(worst, max(errs.values()))
    emit({"phase": "lm_train", "name": "ssm_scan_bwd", "check": "against "
          "plain at every chunk length", "s": SCAN_BWD_TEST_S,
          "d_inner": 200, "states": list(ssm_scan.STATES), "chunks": chunks,
          "worst_scaled_err": worst, "tol": SCAN_BWD_TOL})

    def offset(t):
        flat = torch.empty(t.numel() + 1, device="cuda")
        view = flat[1:].view(t.shape)
        view.copy_(t)
        if view.data_ptr() % 16 != 4:
            raise AssertionError("ssm_scan_bwd: the offset view is aligned")
        return view

    scalar = {}
    b, s, n, chunk = SCAN_BWD_SCALAR["shape"]
    for di, moved in SCAN_BWD_SCALAR["cases"]:
        args, dy, dh, ckpt = inputs(b, s, di, n, True)
        want = ssm_scan_bwd.ssm_scan_bwd_plain(*args, dy, dh)
        ops = [offset(t) if moved else t for t in (*args, dy, dh)]
        got = ssm_scan_bwd.ssm_scan_bwd(*ops, ckpt=ckpt, chunk=chunk)
        scalar[f"d_inner {di}, offset {moved}"] = errors(
            got, want, f"({b}, {s}, {di}, {n}) 4-byte staging, offset "
            f"{moved}, chunk {chunk}")
    emit({"phase": "lm_train", "name": "ssm_scan_bwd", "check": "4-byte "
          "staging against plain", "shape": [b, s, n], "chunk": chunk,
          "chunks": ssm_scan_bwd.chunk_count(s, chunk),
          "scaled_err": scalar, "tol": SCAN_BWD_TOL})
    out = None
    for config, (b, s, di, n) in SCAN_BWD_SHAPES.items():
        plan = ssm_scan_bwd.bwd_plan(b, s, di, n)
        args, dy, _, ckpt = inputs(b, s, di, n, False)
        want = ssm_scan_bwd.ssm_scan_bwd_plain(*args, dy)
        by_chunk = {}
        for chunk in ssm_scan_bwd.CHUNK_STEPS:
            got = ssm_scan_bwd.ssm_scan_bwd(*args, dy, ckpt=ckpt,
                                            chunk=chunk)
            errs = errors(got, want, f"{config} at chunk {chunk}")
            again = ssm_scan_bwd.ssm_scan_bwd(*args, dy, ckpt=ckpt,
                                              chunk=chunk)
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise AssertionError(f"ssm_scan_bwd {config} at chunk "
                                     f"{chunk}: two runs differ")
            by_chunk[chunk] = {"scaled_err": errs, "max_abs_err": max(
                (g - w).abs().max().item() for g, w in zip(got, want))}
            del got, again
        inputs_ = [(*args, dy, None)]

        def kernel(*a):
            return ssm_scan_bwd.ssm_scan_bwd(*a, ckpt=ckpt)

        rec = {"phase": "lm_train", "name": "ssm_scan_bwd", "config": config,
               "shape": [b, s, di, n], "dtype": "float32",
               "plan": {"lanes": plan.lanes, "channels": plan.channels,
                        "chunk": plan.chunk, "chunks": plan.chunks,
                        "grid": list(plan.grid),
                        "prepass_grid": list(plan.prepass_grid),
                        "checkpoints": plan.checkpoints},
               "max_abs_err": by_chunk[plan.chunk]["max_abs_err"],
               "scaled_err": by_chunk[plan.chunk]["scaled_err"],
               "by_chunk": by_chunk, "tol": SCAN_BWD_TOL,
               "deterministic": True,
               "timing": "graph", "ms": graph_ms(kernel, inputs_),
               "eager_ms": cuda_ms(kernel, inputs_),
               "forward_with_checkpoints_ms": graph_ms(
                   lambda *a: ssm_scan.ssm_scan(*a, ckpt=ckpt), [args]),
               "forward_ms": graph_ms(ssm_scan.ssm_scan, [args]),
               "plain_ms": cuda_ms(ssm_scan_bwd.ssm_scan_bwd_plain, inputs_,
                                   iters=2, warmup=1),
               "library_ms": None, "library_eager_ms": None,
               "library": "none: no PyTorch call computes the selective "
                          "scan's gradient",
               **scan_bwd_bound(b, s, di, n),
               "kernel_resources": usage,
               "unit": "one call: the chunks' pre-pass, the reverse walk "
                       "and the partial sums of one SSM layer, one "
                       "micro-batch"}
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        emit(rec)
        if out is None:
            out = rec
        else:
            out["hymba"] = {k: rec[k] for k in (
                "shape", "plan", "ms", "eager_ms", "plain_ms", "bound_ms",
                "bound_by", "bound_share", "max_abs_err",
                "forward_with_checkpoints_ms")}
        del args, dy, ckpt, inputs_, want
        torch.cuda.empty_cache()
    return out


def ptxas_usage(log: str, fragment: str) -> dict:
    """``nvcc -Xptxas -v``'s registers, barriers, static shared memory and
    spills of the kernel whose mangled name holds ``fragment``."""
    usage, current = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            current = fragment in line
        elif current and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            usage.update(stack_bytes=nums[0], spill_store_bytes=nums[1],
                         spill_load_bytes=nums[2])
        elif current and "Used" in line:
            words = line.replace(",", " ").split()
            for i, w in enumerate(words):
                if w in ("registers", "barriers") and words[i - 1].isdigit():
                    usage[w] = int(words[i - 1])
                if w == "smem" and words[i - 2].isdigit():
                    usage["static_smem_bytes"] = int(words[i - 2])
    return usage


def ptxas_spills(log: str, fragment: str) -> dict:
    """Spill bytes (stores plus loads) of every kernel whose mangled name
    holds ``fragment``, by mangled name, from ``nvcc -Xptxas -v``."""
    spills, current = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            current = line.split("'")[1] if fragment in line else None
        elif current and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            spills[current] = nums[1] + nums[2]
    return spills


def fa_resources(build, flash_attn) -> dict:
    """The resources of the attention kernels that run D 64-192 and
    float32: ``fa_wgmma_kernel`` at every (D, Dv) pair it launches at,
    (64, 64) to (192, 192) and (192, 128) (ptxas's account; its register
    count is the launch bound's per-thread share, which the kernel's
    setmaxnreg then moves from the producer to the consumers) and the
    float32 ``fa_fma_kernel`` at every pair, each with the dynamic shared
    memory of a launch, which ptxas does not see; a pair with D = Dv is
    named ``d{D}``, another ``d{D} dv{Dv}``.  Raises if ptxas reports a
    spill in any instantiation of either kernel (bf16 at D 8, 40 and (24,
    16) included) or a launch would take more shared memory than the 227
    KB a block may have."""
    log = build.compiler_log("flash_attn")
    lib = build.load("flash_attn", flash_attn._SIGNATURES)
    res = {}
    for kernel, tag, smem in (
            ("fa_wgmma_kernel", "", lib.flash_attn_wgmma_smem),
            ("fa_fma_kernel", "f", lib.flash_attn_fma_smem)):
        for d, dv in flash_attn.PAIRS:
            if smem(d, dv):
                name = f"{kernel} d{d}" + ("" if dv == d else f" dv{dv}")
                res[name] = dict(
                    ptxas_usage(log, f"{kernel}I{tag}Li{d}ELi{dv}E"),
                    dynamic_smem_bytes=smem(d, dv))
    spills = {**ptxas_spills(log, "fa_wgmma_kernel"),
              **ptxas_spills(log, "fa_fma_kernel")}
    bf16_fma = ptxas_spills(log, "fa_fma_kernelI13__nv_bfloat16")
    too_big = {name: u for name, u in res.items()
               if u["dynamic_smem_bytes"] + u.get("static_smem_bytes", 0)
               > SMEM_PER_BLOCK}
    if (len(spills) != len(res) + len(bf16_fma) or len(bf16_fma) != 3
            or any(spills.values()) or too_big):
        raise AssertionError(f"attention kernels: spill bytes {spills}, "
                             f"over {SMEM_PER_BLOCK} bytes of shared "
                             f"memory {too_big}")
    return res


def _param_digests(torch, tree_items, params) -> dict:
    """sha256 (first 16 hex digits) of each leaf's bytes, by path."""
    digests = {}
    for path, t in tree_items(params):
        t = t.cpu()
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t)
        digests[path] = hashlib.sha256(raw.numpy().tobytes()).hexdigest()[:16]
    return digests


def _frontend_against_jax(torch, configs, prng, transformer, tree_items,
                          ref) -> None:
    """A frontend smoke config (``lm_serve_ssm``'s hubert-xlarge, audio,
    and internvl2-76b, vision) on the card against its stored JAX forward:
    the init's leaf digests bit for bit, the last positions' logits on the
    stored inputs within the serve path's float32 and bf16 bounds."""
    batch = {k: torch.tensor(v, device="cuda")
             for k, v in ref["inputs"].items()}
    for dtype, want in ref["variants"].items():
        cfg = dataclasses.replace(configs.get_smoke(ref["arch"]),
                                  param_dtype=dtype, compute_dtype=dtype)
        params = transformer.init_params(cfg, prng.PRNGKey(0, device="cuda"))
        if _param_digests(torch, tree_items, params) != want["digests"]:
            raise AssertionError(f"lm_serve {ref['arch']} {dtype}: "
                                 f"init_params differs from the JAX leaves")
        with torch.inference_mode():
            logits = transformer.forward(params, cfg, batch)[0]
        got = logits[:, -ref["last"]:].cpu()
        w = torch.tensor(want["logits"], dtype=torch.float32)
        tol = ({"rtol": LM_F32_TOL, "atol": LM_F32_TOL} if dtype == "float32"
               else {"rtol": 0.0, "atol": LM_BF16_ATOL})
        torch.testing.assert_close(got, w, **tol)
        emit({"phase": "lm_serve", "check": f"frontend {ref['arch']} "
              f"({cfg.frontend}) {dtype} against JAX", "digests_equal": True,
              "max_abs_err": (got - w).abs().max().item(), "tol": tol})


def _smoke_against_jax(torch, configs, prng, steps, transformer, tree_items,
                       ref) -> None:
    """A smoke config on the card against its stored JAX run (the qwen3
    one of ``lm_serve``, the moonshot and deepseek-v3 ones of
    ``lm_serve_moe``, the falcon-mamba and hymba ones of
    ``lm_serve_ssm``): the bf16 variant through the serve steps, the
    float32 one float32 end to end (the prefill step's function on
    float32 caches, as stored), each with the config overrides stored
    beside it (the MoE configs' bf16 routing neutralised)."""
    toks = torch.tensor(ref["prompts"], dtype=torch.int64, device="cuda")
    b, length = toks.shape
    bf16_atol = LM_BF16_ATOL_BY_ARCH.get(ref["arch"], LM_BF16_ATOL)
    for dtype, want in ref["variants"].items():
        cfg = dataclasses.replace(configs.get_smoke(ref["arch"]),
                                  param_dtype=dtype, compute_dtype=dtype,
                                  **want.get("overrides", {}))
        params = transformer.init_params(cfg, prng.PRNGKey(0, device="cuda"))
        if _param_digests(torch, tree_items, params) != want["digests"]:
            raise AssertionError(f"lm_serve {dtype}: init_params on the card "
                                 f"differs from the JAX leaves")
        decode, _ = steps.build_decode_step(cfg, batch=b, max_len=length)
        if want["cache_dtype"] == "float32":
            caches = transformer.init_caches(cfg, b, length, torch.float32)
            with torch.inference_mode():
                logits, caches, _, _ = transformer.forward(
                    params, cfg, {"tokens": toks}, caches=caches,
                    last_only=True)
        else:
            prefill, _ = steps.build_prefill_step(cfg, batch=b,
                                                  seq_len=length)
            logits, caches = prefill(params, {"tokens": toks})
        outs, toks_out = [logits[:, -1]], [logits[:, -1].argmax(-1)]
        for i in range(ref["steps"]):
            tok = toks_out[-1]
            if dtype == "bfloat16":     # fed the stored tokens
                tok = torch.tensor(want["tokens"][i], device="cuda")
            pos = torch.full((b,), ref["prompt_len"] + i, dtype=torch.int32,
                             device="cuda")
            logits, caches = decode(params, caches, tok[:, None], pos)
            outs.append(logits[:, 0])
            toks_out.append(logits[:, 0].argmax(-1))
        stored = [want["prefill_logits"]] + want["decode_logits"]
        errs, mismatched = [], 0
        for got, w, gt, wt in zip(outs, stored, toks_out, want["tokens"]):
            w = torch.tensor(w, dtype=torch.float32)
            got, gt, wt = got.cpu(), gt.cpu(), torch.tensor(wt)
            errs.append((got - w).abs().max().item())
            if dtype == "float32":
                torch.testing.assert_close(got, w, rtol=LM_F32_TOL,
                                           atol=LM_F32_TOL)
                clear = torch.ones_like(wt, dtype=torch.bool)
            else:
                torch.testing.assert_close(got, w, rtol=0.0, atol=bf16_atol)
                clear = _top2_margin(w) > 2 * bf16_atol
            mismatched += int((gt[clear] != wt[clear]).sum().item())
        emit({"phase": "lm_serve", "check": f"smoke {ref['arch']} {dtype} "
              f"against JAX", "cache_dtype": want["cache_dtype"],
              "overrides": want.get("overrides", {}),
              "digests_equal": True, "max_abs_err_per_step": errs,
              "tol": {"rtol": LM_F32_TOL, "atol": LM_F32_TOL}
              if dtype == "float32" else {"atol": bf16_atol},
              "tokens_mismatched": mismatched})
        if mismatched:
            raise AssertionError(f"lm_serve {dtype}: {mismatched} greedy "
                                 f"tokens differ from JAX")


def _serve_full(torch, kernels, serve_lm, steps, attention, cfg,
                spec) -> dict:
    """A full-width serve through ``repro_torch.examples.serve_lm`` (the
    main path, the launches of each kernel module of ``kernels``,
    ``flash_attn`` and ``ssm_scan``, counted from 0), checked: each
    kernel launched once a layer that has its mixer a prefill (attention
    in every layer but the SSM family's, the scan in the SSM and hybrid
    families' layers), finite logits, tokens in range, and the first
    token's logits against the same prefill with the plain chunked
    attention and the plain scan on the card.  Returns the launches by
    kernel."""
    flash_attn, ssm_scan = kernels["flash_attention"], kernels["ssm_scan"]
    flash_attn.LAUNCHES = ssm_scan.LAUNCHES = 0
    out = serve_lm.serve(cfg, batch=spec["batch"],
                         prompt_len=spec["prompt_len"],
                         tokens=spec["tokens"], device="cuda")
    torch.cuda.synchronize()
    launches = {"flash_attention": flash_attn.LAUNCHES,
                "ssm_scan": ssm_scan.LAUNCHES}
    calls = out["prefill_calls"]
    expected = {"flash_attention": cfg.n_layers * calls
                if cfg.family != "ssm" else 0,
                "ssm_scan": cfg.n_layers * calls if cfg.has_ssm else 0}
    if launches != expected:
        raise AssertionError(f"full-width serve: launches {launches} over "
                             f"{calls} prefills, expected {expected}")
    generated = out["tokens"]
    if (generated.shape != (spec["batch"], spec["tokens"])
            or not torch.isfinite(out["first_logits"]).all()
            or generated.min() < 0 or generated.max() >= cfg.vocab_size):
        raise AssertionError("full-width serve: bad logits or tokens")

    # The same prefill with the plain chunked attention and the plain
    # scan on the card.
    max_len = spec["prompt_len"] + spec["tokens"]
    prefill, _ = steps.build_prefill_step(cfg, batch=spec["batch"],
                                          seq_len=max_len)
    toks = torch.from_numpy(serve_lm.prompts(cfg, spec["batch"],
                                             max_len)).cuda()
    kernel_attention, kernel_scan = (attention.flash_attention,
                                     ssm_scan.ssm_scan)
    attention.flash_attention = attention.chunked_attention
    ssm_scan.ssm_scan = ssm_scan.ssm_scan_plain
    try:
        t0 = time.perf_counter()
        plain_logits, _ = prefill(out["params"], {"tokens": toks})
        torch.cuda.synchronize()
        plain_prefill_s = time.perf_counter() - t0
    finally:
        attention.flash_attention = kernel_attention
        ssm_scan.ssm_scan = kernel_scan
    plain_first = plain_logits[:, -1]
    gap = (out["first_logits"] - plain_first).abs().max().item()
    clear = _top2_margin(plain_first) > 2 * gap
    first_equal = bool(torch.equal(generated[:, 0][clear],
                                   plain_first.argmax(-1)[clear]))
    rec = {"phase": "lm_serve", "run": "full-width serve",
           "model": cfg.name, **spec,
           "n_dense_layers": cfg.n_dense_layers if cfg.is_moe else None,
           "params_b": cfg.param_count() / 1e9,
           "init_s": out["init_s"], "prefill_ms": out["prefill_s"] * 1e3,
           "decode_s": out["decode_s"],
           "decode_tok_s": out["decode_tok_s"],
           "launches": launches, "prefill_calls": calls,
           "launches_per_prefill": {k: n // calls
                                    for k, n in launches.items()},
           "peak_gib": out["peak_bytes"] / 2 ** 30,
           "plain_kernels_prefill_ms": plain_prefill_s * 1e3,
           "logits_gap_vs_plain": gap, "gap_bound": LM_FULL_GAP,
           "first_token_equal_where_clear": first_equal,
           "rows_clear": int(clear.sum().item()),
           "first_tokens": generated[:, 0].tolist()}
    emit(rec)
    if not (gap <= LM_FULL_GAP and first_equal):
        raise AssertionError(f"full-width prefill: kernels against plain "
                             f"gap {gap}, first tokens equal where clear: "
                             f"{first_equal}")
    return launches


def phase_lm_serve(torch, flash_attn, ssm_scan, build, ref_values) -> dict:
    """The LM serving paths; returns ``{entry: (summary record,
    launches)}`` for the summary's four entries of the LM path: the
    attention kernel on the GQA path (full-width Qwen3-4B), on the MLA
    path (DeepSeek-V3 at its published widths, 4 layers) and under the
    hybrid family's window (full-width Hymba-1.5B), and the scan kernel
    (full-width Falcon-Mamba-7B)."""
    from repro_torch import configs
    from repro_torch.core import prng
    from repro_torch.examples import serve_lm
    from repro_torch.launch import steps
    from repro_torch.models import attention, transformer
    from repro_torch.models.layers import tree_items

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    summary = _fa_kernel_checks(torch, flash_attn, build)
    _fa_pair_checks(torch, flash_attn)
    mla_summary = _fa_config_checks(torch, flash_attn, build)
    window_summary = _fa_window_checks(torch, flash_attn)
    scan_summary = _scan_checks(torch, ssm_scan, build)
    ssm_refs = ref_values["lm_serve_ssm"].values()
    for ref in (ref_values["lm_serve"],
                *ref_values["lm_serve_moe"].values(),
                *(r for r in ssm_refs if not r.get("frontend"))):
        _smoke_against_jax(torch, configs, prng, steps, transformer,
                           tree_items, ref)
    for ref in ssm_refs:
        if ref.get("frontend"):
            _frontend_against_jax(torch, configs, prng, transformer,
                                  tree_items, ref)

    # Full width: each path driven with the counts set to 0 just before
    # it and read just after.
    kernels = {"flash_attention": flash_attn, "ssm_scan": ssm_scan}
    launches = _serve_full(torch, kernels, serve_lm, steps, attention,
                           configs.get(LM_FULL["arch"]), LM_FULL)
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(configs.get(LM_MLA["arch"]),
                              n_layers=LM_MLA["n_layers"])
    mla_launches = _serve_full(torch, kernels, serve_lm, steps,
                               attention, cfg, LM_MLA)
    torch.cuda.empty_cache()
    hybrid_launches = _serve_full(torch, kernels, serve_lm, steps,
                                  attention, configs.get(LM_HYBRID["arch"]),
                                  LM_HYBRID)
    torch.cuda.empty_cache()
    ssm_launches = _serve_full(torch, kernels, serve_lm, steps, attention,
                               configs.get(LM_SSM["arch"]), LM_SSM)
    torch.cuda.empty_cache()
    scan_summary["hybrid_launches"] = hybrid_launches["ssm_scan"]
    emit({"phase": "lm_serve", "wall_s": time.perf_counter() - t_phase})
    return {"flash_attention": (summary, launches["flash_attention"]),
            "flash_attention_mla": (mla_summary,
                                    mla_launches["flash_attention"]),
            "flash_attention_window": (window_summary,
                                       hybrid_launches["flash_attention"]),
            "ssm_scan": (scan_summary, ssm_launches["ssm_scan"])}


def _scaled_err(got, want, top: float = 0.0) -> float:
    """A gradient's largest error over its largest element (``top`` where
    the gradient is exactly zero)."""
    diff = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item() or top
    return diff / scale if scale else (math.inf if diff else 0.0)


def grad_row_err(got, want, top: float = 0.0) -> float:
    """:func:`row_scaled_err` for a gradient: each row's largest error
    over the larger of its largest element and :data:`FA_BWD_ROW_FLOOR`
    of the gradient's largest row (of ``top`` where the gradient is
    exactly zero: at window 1 under causal masking a row sees only itself,
    p = 1 and dS = dP - delta = 0, so dQ and dK vanish but for
    rounding)."""
    diff = (got.float() - want.float()).abs().amax(dim=-1)
    rows = want.float().abs().amax(dim=-1)
    floor = (rows.max().item() or top) * FA_BWD_ROW_FLOOR
    return (diff / rows.clamp_min(floor)).max().item()


def bwd_resources(build, flash_attn, flash_attn_bwd) -> dict:
    """ptxas's registers and spills of the backward kernels at each (D,
    Dv) pair of ``flash_attn.PAIRS`` (named ``d{D}``, or ``d{D} dv{Dv}``
    where Dv differs): ``bwd_dkdv_wgmma``/``bwd_dq_wgmma`` (bf16 at the
    pairs of ``flash_attn_bwd.WGMMA_DIMS``, (192, 128) among them, with the
    dynamic shared memory of a launch), ``bwd_dkdv_mma``/``bwd_dq_mma``
    (bf16 at the other pairs whose widths are multiples of 16) and
    ``bwd_dkdv_fma``/``bwd_dq_fma`` (float32 at every pair; bf16 at D 8
    and 40 and at (24, 16)).  Raises if ptxas reports a spill in a wgmma
    kernel or in an FMA kernel at a pair where Dv differs, or a wgmma
    launch would take more shared memory than a block may have; the
    spills of the older mma.sync and (D, D) FMA kernels are recorded
    beside the times (they cost time, not correctness)."""
    log = build.compiler_log("flash_attn_bwd")
    lib = build.load("flash_attn_bwd", flash_attn_bwd._SIGNATURES)
    res, strict = {}, []
    for d, dv in flash_attn.PAIRS:
        tag = f"d{d}" + ("" if dv == d else f" dv{dv}")
        for which, kernel in enumerate(("bwd_dkdv", "bwd_dq")):
            if (d, dv) in flash_attn_bwd.WGMMA_DIMS:
                res[f"{kernel}_wgmma {tag}"] = dict(
                    ptxas_usage(log, f"{kernel}_wgmmaILi{d}ELi{dv}E"),
                    dynamic_smem_bytes=lib.flash_attn_bwd_wgmma_smem(
                        d, dv, which))
                strict.append(f"{kernel}_wgmma {tag}")
            elif d % 16 == 0 and dv % 16 == 0:
                res[f"{kernel}_mma {tag}"] = ptxas_usage(
                    log, f"{kernel}_mmaILi{d}ELi{dv}E")
            else:
                res[f"{kernel}_fma bf16 {tag}"] = ptxas_usage(
                    log, f"{kernel}_fmaI13__nv_bfloat16Li{d}ELi{dv}E")
                strict += [f"{kernel}_fma bf16 {tag}"] if dv != d else []
            res[f"{kernel}_fma f32 {tag}"] = ptxas_usage(
                log, f"{kernel}_fmaIfLi{d}ELi{dv}E")
            strict += [f"{kernel}_fma f32 {tag}"] if dv != d else []
    spills = {name: res[name].get("spill_store_bytes", -1)
              + res[name].get("spill_load_bytes", -1) for name in strict}
    too_big = {name: u for name, u in res.items()
               if "_wgmma" in name and u["dynamic_smem_bytes"]
               + u.get("static_smem_bytes", 0) > SMEM_PER_BLOCK}
    # ptxas's C75xx warnings: a wgmma it serialises.
    serialised = [line for line in log.splitlines() if "C75" in line]
    if (any(spills.values()) or too_big or serialised
            or not all(u.get("registers") for u in res.values())):
        raise AssertionError(f"backward kernels: spill bytes {spills} (-2: "
                             f"not in ptxas's log), over {SMEM_PER_BLOCK} "
                             f"bytes of shared memory {too_big}, "
                             f"serialised {serialised}; {res}")
    return res


def _bf16_reference_errs(torch, q, k, v, do, causal, window, got,
                         want) -> dict:
    """A bf16 draw's kernel gradients ``got`` beside SDPA's backward on
    the same bf16 inputs (``enable_gqa``, the (S, T) boolean mask of the
    window: s - t < window, and t <= s where causal), both against the
    float32 reference ``want`` by each gradient's largest element
    (:func:`_scaled_err`, the windowed bf16 check's metric) and by rows
    (:func:`grad_row_err`, the metric :data:`FA_BWD_TOL` holds without a
    window): dq, dk, dv each, and SDPA's backend."""
    s, t = q.shape[2], k.shape[2]
    lag = (torch.arange(s, device=q.device)[:, None]
           - torch.arange(t, device=q.device)[None, :])
    mask = lag < window
    if causal:
        mask &= lag >= 0
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    with torch.enable_grad():
        out = torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True)
        lib = torch.autograd.grad(out, (qs, ks, vs), do)
    top = max(w.float().abs().max().item() for w in want)
    return {"kernel_scaled_err": [_scaled_err(g, w, top)
                                  for g, w in zip(got, want)],
            "reference_scaled_err": [_scaled_err(g, w, top)
                                     for g, w in zip(lib, want)],
            "kernel_row_err": [grad_row_err(g, w, top)
                               for g, w in zip(got, want)],
            "reference_row_err": [grad_row_err(g, w, top)
                                  for g, w in zip(lib, want)],
            "reference_backend": sdpa_backend(q, k, v, False, mask)}


def _bwd_timed(torch, flash_attn, flash_attn_bwd, run, inputs, shape,
               kernel_resources, window=0) -> dict:
    """The backward at a training shape (B, H, Hk, S, D[, Dv]), bf16,
    causal, the caller's default scale (MLA's ``D ** -0.5`` at (192,
    128)), under a sliding ``window`` or none: ``run``'s checks against
    the plain version, then the kernels' time in device time and eagerly,
    SDPA's backward alone in turns with them eagerly (the backend torch
    picked named; under a window on the (S, S) boolean mask of the causal
    window), the plain version's time and the bound of the five products;
    the summary record."""
    b, h, hk, s, d, *dv = shape
    dv = dv[0] if dv else d
    q, k, v, do = inputs(torch.bfloat16, b, h, hk, s, s, d, dv)
    rec, (out, lse, got, want) = run(q, k, v, do, True, window=window)
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    mask = None
    if window:
        lag = (torch.arange(s, device=q.device)[:, None]
               - torch.arange(s, device=q.device)[None, :])
        mask = (lag >= 0) & (lag < window)
    lib_out = torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask, is_causal=mask is None, enable_gqa=True)

    def library(do_):
        return torch.autograd.grad(lib_out, (qs, ks, vs), do_,
                                   retain_graph=True)

    lib = library(do)

    def kernel(*a):
        return flash_attn_bwd.flash_attention_bwd(*a, causal=True,
                                                  window=window)

    args = [(q, k, v, out, do, lse)]
    b_ms, b_by = bound(*attention_bwd_work(b, h, hk, s, s, d, True, 2,
                                           dv=dv, window=window), "bfloat16")
    turns = [cuda_ms(kernel, args), cuda_ms(library, [(do,)]),
             cuda_ms(library, [(do,)]), cuda_ms(kernel, args)]
    ms, library_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    return {"phase": "lm_train", "shape": list(shape), "dtype": "bfloat16",
            "causal": True, "window": window, **rec,
            "max_abs_err": max((g.float() - w.float()).abs().max().item()
                               for g, w in zip(got, want)),
            "ms": ms, "runs_ms": [turns[0], turns[3]],
            "graph_ms": graph_ms(kernel, args),
            "plain_ms": cuda_ms(
                lambda *a: flash_attn_bwd.flash_attention_bwd_plain(
                    *a, causal=True, window=window), [(q, k, v, do)],
                iters=3, warmup=1),
            "library_ms": library_ms,
            "library_runs_ms": [turns[1], turns[2]],
            "ratio_to_library": ms / library_ms,
            "library": "torch.autograd.grad of F.scaled_dot_product_"
                       "attention(" + ("attn_mask=the (S, S) causal "
                                       "window" if window else
                                       "is_causal=True")
                       + ", enable_gqa=True) (the backward alone), in "
                       "turns with the kernels, eagerly",
            "library_backend": sdpa_backend(q, k, v, mask is None, mask),
            "library_row_err": [grad_row_err(g, w)
                                for g, w in zip(lib, want)],
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_share": b_ms / ms,
            "kernel_resources": kernel_resources,
            "unit": "one call: the pre-pass, dK/dV and dQ kernels of one "
                    "layer's attention, one micro-batch"}


def _fa_bwd_checks(torch, flash_attn, flash_attn_bwd, ref, build) -> tuple:
    """The backward kernels against their plain version at the test
    shapes, at every (D, D) and at MLA's pairs, under the sliding window,
    their determinism and refusals, their resources, and the times at
    Qwen3-4B's, DeepSeek-V3's and Hymba-1.5B's training shapes.  Returns
    the three summary records (Qwen3-4B's shape, DeepSeek-V3's,
    Hymba-1.5B's under its window)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(25)

    def inputs(dtype, b, h, hk, s, t, d, dv=None, g=None):
        dv = d if dv is None else dv
        g = gen if g is None else g
        q = (0.5 * torch.randn(b, h, s, d, device=dev, generator=g)
             ).to(dtype)
        k = (0.5 * torch.randn(b, hk, t, d, device=dev, generator=g)
             ).to(dtype)
        v = torch.randn(b, hk, t, dv, device=dev, generator=g).to(dtype)
        do = torch.randn(b, h, s, dv, device=dev, generator=g).to(dtype)
        return q, k, v, do

    def run(q, k, v, do, causal, scale=None, rows=True, window=0):
        lse = torch.empty(q.shape[:3], device=dev)
        kw = dict(causal=causal, scale=scale, window=window)
        out = flash_attn.flash_attention(q, k, v, lse=lse, **kw)
        got = flash_attn_bwd.flash_attention_bwd(q, k, v, out, do, lse, **kw)
        again = flash_attn_bwd.flash_attention_bwd(q, k, v, out, do, lse,
                                                   **kw)
        want = flash_attn_bwd.flash_attention_bwd_plain(q, k, v, do, **kw)
        lse_err = (lse - ref.attention_lse(q, k, **kw)).abs().max().item()
        dtype = str(q.dtype).split(".")[1]
        err, tol = ((grad_row_err, FA_BWD_TOL[dtype]) if rows
                    else (_scaled_err, FA_BWD_SCALED_TOL[dtype]))
        top = max(w.float().abs().max().item() for w in want)
        errs = [err(g, w, top) for g, w in zip(got, want)]
        if not (max(errs) <= tol and lse_err <= FA_LSE_TOL):
            raise AssertionError(f"flash_attention_bwd {list(q.shape)} "
                                 f"{list(v.shape)} {q.dtype} causal={causal}"
                                 f" scale={scale} window={window}: dq/dk/dv "
                                 f"errors {errs} (tol {tol}), lse {lse_err}")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError("flash_attention_bwd: two runs differ")
        return {"dq_dk_dv_row_err" if rows else "dq_dk_dv_scaled_err": errs,
                "lse_err": lse_err, "tol": tol,
                "deterministic": True}, (out, lse, got, want)

    worst = {}
    for name in ("float32", "bfloat16"):
        for d in flash_attn.HEAD_DIMS:
            for causal in (True, False):
                for h, hk, s, t in FA_BWD_SHAPES:
                    rec, _ = run(*inputs(getattr(torch, name), 2, h, hk, s, t,
                                         d), causal)
                    worst[name] = max(worst.get(name, 0.0),
                                      max(rec["dq_dk_dv_row_err"]))
    emit({"phase": "lm_train", "check": "flash_attention_bwd against plain "
          "at the test shapes", "shapes": FA_BWD_SHAPES,
          "head_dims": flash_attn.HEAD_DIMS, "worst_row_err": worst,
          "tol": FA_BWD_TOL, "deterministic": True})
    worst = {}
    for name in ("float32", "bfloat16"):
        for d, dv in FA_PAIRS:
            for causal in (True, False):
                for scale in (None, FA_SCALE):
                    rows = name == "float32" or scale is None
                    for h, hk, s, t in FA_BWD_SHAPES:
                        rec, _ = run(*inputs(getattr(torch, name), 2, h, hk,
                                             s, t, d, dv), causal, scale,
                                     rows)
                        key = (f"{name} ({d}, {dv}) scale {scale or 'MLA'} "
                               + ("row" if rows else "scaled"))
                        worst[key] = max(worst.get(key, 0.0),
                                         max(rec.get("dq_dk_dv_row_err")
                                             or rec["dq_dk_dv_scaled_err"]))
    emit({"phase": "lm_train", "check": "flash_attention_bwd against plain "
          "at the (D, Dv) pairs, MLA's scale and "
          f"{FA_SCALE}", "shapes": FA_BWD_SHAPES, "pairs": FA_PAIRS,
          "worst_err": worst, "tol": FA_BWD_TOL,
          "scaled_tol": FA_BWD_SCALED_TOL, "deterministic": True})

    # Under the window: the forward's window checks, then the (192, 128)
    # wgmma kernels.  Each bf16 draw also runs SDPA's backward on the same
    # inputs, a bf16 reference whose errors stand beside the kernel's.
    worst, beside = {}, []
    b, h, hk, s = FA_BWD_WINDOW_SHAPE
    for d, name in FA_WINDOW_KERNELS:
        for causal in (True, False):
            for window in FA_WINDOWS:
                rows = name == "float32"
                q, k, v, do = inputs(getattr(torch, name), b, h, hk, s, s, d)
                rec, (_, _, got, want) = run(q, k, v, do, causal, rows=rows,
                                             window=window)
                key = f"{name} d{d} " + ("row" if rows else "scaled")
                worst[key] = max(worst.get(key, 0.0),
                                 max(rec.get("dq_dk_dv_row_err")
                                     or rec["dq_dk_dv_scaled_err"]))
                if not rows:
                    beside.append(dict(d=d, causal=causal, window=window,
                                       **_bf16_reference_errs(
                                           torch, q, k, v, do, causal,
                                           window, got, want)))
    b, h, hk, s, d, dv = FA_BWD_WINDOW_PAIR
    for causal in (True, False):
        for window in (7, 64, 1000):
            q, k, v, do = inputs(torch.bfloat16, b, h, hk, s, s, d, dv)
            rec, (_, _, got, want) = run(q, k, v, do, causal, rows=False,
                                         window=window)
            key = f"bfloat16 ({d}, {dv}) scaled"
            worst[key] = max(worst.get(key, 0.0),
                             max(rec["dq_dk_dv_scaled_err"]))
            beside.append(dict(d=d, dv=dv, causal=causal, window=window,
                               **_bf16_reference_errs(torch, q, k, v, do,
                                                      causal, window, got,
                                                      want)))
    del q, k, v, do, got, want
    emit({"phase": "lm_train", "check": "flash_attention_bwd against plain "
          "under the sliding window", "shape": FA_BWD_WINDOW_SHAPE,
          "windows": FA_WINDOWS, "kernels": FA_WINDOW_KERNELS,
          "pair_shape": FA_BWD_WINDOW_PAIR, "worst_err": worst,
          "tol": FA_BWD_TOL, "scaled_tol": FA_BWD_SCALED_TOL,
          "deterministic": True})
    emit({"phase": "lm_train", "check": "the windowed bf16 backward beside "
          "SDPA's backward on the same draw, both against the float32 "
          "reference", "worst": {
              key: max(max(c[key]) for c in beside)
              for key in ("kernel_scaled_err", "reference_scaled_err",
                          "kernel_row_err", "reference_row_err")},
          "scaled_tol": FA_BWD_SCALED_TOL["bfloat16"],
          "row_metric_before_pr30": FA_BWD_TOL["bfloat16"],
          "cases": beside})

    x = torch.zeros(1, 2, 8, 192, device=dev, dtype=torch.bfloat16)
    lse0 = torch.zeros(1, 2, 8, device=dev)
    before = flash_attn_bwd.LAUNCHES
    for what, args, kw in (
            ("window over S > T", (x, x[:, :, :4], x[:, :, :4], x, x, lse0),
             {"window": 4}),
            ("(192, 64)", (x, x, *(x[..., :64],) * 3, lse0), {})):
        try:
            flash_attn_bwd.flash_attention_bwd(*args, **kw)
        except ValueError:
            continue
        raise AssertionError(f"flash_attention_bwd took a {what}")
    if flash_attn_bwd.LAUNCHES != before:
        raise AssertionError("flash_attention_bwd launched before refusing")
    emit({"phase": "lm_train", "check": "a window over more query rows "
          "than keys and a pair outside flash_attn.PAIRS raise ValueError "
          "before any launch"})

    resources = bwd_resources(build, flash_attn, flash_attn_bwd)
    summary = _bwd_timed(torch, flash_attn, flash_attn_bwd, run, inputs,
                         FA_TRAIN_SHAPE, resources)
    mla_summary = _bwd_timed(torch, flash_attn, flash_attn_bwd, run, inputs,
                             FA_MLA_TRAIN_SHAPE, resources)
    window_summary = _bwd_timed(torch, flash_attn, flash_attn_bwd, run,
                                inputs, FA_WINDOW_TRAIN_SHAPE[:5], resources,
                                window=FA_WINDOW_TRAIN_SHAPE[5])
    # Hymba-1.5B's full training shape under its window, causal and not,
    # on draws of their own generator (the draws above keep theirs): by
    # each gradient's largest element (the windowed bound), beside SDPA's
    # backward on the same draws.
    full_gen = torch.Generator(device=dev).manual_seed(FA_BWD_FULL_SEED)
    bb, hh, hkk, ss, dd, window = FA_WINDOW_TRAIN_SHAPE
    full = []
    for causal in (True, False):
        q, k, v, do = inputs(torch.bfloat16, bb, hh, hkk, ss, ss, dd,
                             g=full_gen)
        rec, (_, _, got, want) = run(q, k, v, do, causal, rows=False,
                                     window=window)
        full.append(dict(causal=causal, **rec, **_bf16_reference_errs(
            torch, q, k, v, do, causal, window, got, want)))
    del q, k, v, do, got, want
    emit({"phase": "lm_train", "check": "flash_attention_bwd at Hymba-1.5B's "
          "training shape under its window against plain, beside SDPA's "
          "backward on the same draws", "shape": FA_WINDOW_TRAIN_SHAPE,
          "seed": FA_BWD_FULL_SEED,
          "scaled_tol": FA_BWD_SCALED_TOL["bfloat16"], "cases": full})
    # The forward kernel with and without the lse output, in turns, in
    # device time, at the training shapes and at the serving prefill's.
    fwd = {}
    for label, shape in (("train", FA_TRAIN_SHAPE),
                         ("mla_train", FA_MLA_TRAIN_SHAPE),
                         ("serve", FA_PATH_SHAPE)):
        bb, hh, hkk, ss, dd, *dv = shape
        fq, fk, fv, _ = inputs(torch.bfloat16, bb, hh, hkk, ss, ss, dd,
                               *dv)
        lse_buf = torch.empty(bb, hh, ss, device=dev)
        ins = cold_copies(fq, fk, fv)
        runs = [graph_ms(lambda *a: flash_attn.flash_attention(
                    *a, causal=True, lse=lse_buf if with_lse else None), ins)
                for with_lse in (False, True, True, False)]
        fwd[label] = {"no_lse_ms": (runs[0] + runs[3]) / 2,
                      "lse_ms": (runs[1] + runs[2]) / 2, "runs_ms": runs}
        del fq, fk, fv, ins, lse_buf
    summary.update(name="flash_attention_bwd", forward_lse_cost=fwd)
    mla_summary.update(name="flash_attention_bwd_mla",
                       forward_lse_cost={"mla_train": fwd["mla_train"]})
    # The windowed forward with lse at Hymba's training shape, for the
    # run's attention share.
    bb, hh, hkk, ss, dd, window = FA_WINDOW_TRAIN_SHAPE
    fq, fk, fv, _ = inputs(torch.bfloat16, bb, hh, hkk, ss, ss, dd)
    lse_buf = torch.empty(bb, hh, ss, device=dev)
    window_summary.update(
        name="flash_attention_bwd_window",
        forward_lse_ms=graph_ms(lambda *a: flash_attn.flash_attention(
            *a, causal=True, window=window, lse=lse_buf),
            cold_copies(fq, fk, fv)))
    del fq, fk, fv, lse_buf
    emit(summary)
    emit(mla_summary)
    emit(window_summary)
    return summary, mla_summary, window_summary


def _leaf_digests(torch, items) -> dict:
    """sha256 (first 16 hex digits) of each (path, tensor)'s bytes."""
    out = {}
    for path, t in items:
        t = t.detach().cpu()
        raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        out[path] = hashlib.sha256(raw.numpy().tobytes()).hexdigest()[:16]
    return out


def _train_smoke_against_jax(torch, configs, prng, optim, steps, data,
                             init_params, tree_items, ref, tols) -> None:
    """A smoke config's stored three train steps (``lm_train``: qwen3;
    ``lm_train_moe``: deepseek-v3) on the card: the init's leaf digests,
    each step's metrics and the updated leaves' sums at ``tols``
    (:data:`LM_TRAIN_TOL`, :data:`LM_TRAIN_MOE_TOL`)."""
    dcfg = data.DataConfig(seed=ref["data_seed"], seq_len=ref["seq_len"],
                           global_batch=ref["global_batch"],
                           vocab_size=configs.get_smoke(ref["arch"])
                           .vocab_size)
    for dtype, want in ref["variants"].items():
        cfg = dataclasses.replace(configs.get_smoke(ref["arch"]),
                                  **want["overrides"])
        ocfg = optim.OptConfig.from_model(cfg, **ref["opt"])
        params = init_params(cfg, prng.PRNGKey(0, device="cuda"))
        if _leaf_digests(torch, tree_items(params)) != want["digests"]:
            raise AssertionError(f"lm_train {dtype}: init_params on the card "
                                 f"differs from the JAX leaves")
        fn, _ = steps.build_train_step(cfg, opt_cfg=ocfg)
        state = optim.init(params, ocfg)
        gaps = {}
        for i, w in enumerate(want["metrics"]):
            batch = {k: torch.from_numpy(v).cuda() for k, v in
                     data.batch_for_model(cfg, dcfg, i).items()}
            params, state, m = fn(params, state, batch)
            for k, wv in w.items():
                g = float(m[k])
                gaps[k] = max(gaps.get(k, 0.0),
                              abs(g - wv) / abs(wv) if wv else abs(g))
        m_gap = max(gaps.values())
        s_gap = 0.0
        for path, t in tree_items(params):
            s, l1 = want["leaf_sums"][path]
            s_gap = max(s_gap, abs(t.double().sum().item() - s) / l1)
        tol = tols[dtype]
        emit({"phase": "lm_train", "check": f"smoke {ref['arch']} {dtype} "
              f"train steps against JAX", "steps": ref["steps"],
              "micro_batches": ref["micro_batches"], "digests_equal": True,
              "metrics_gap": m_gap, "metrics_gap_by_key": gaps,
              "leaf_sum_gap": s_gap, "tol": tol})
        if not (m_gap <= tol["metrics"] and s_gap <= tol["leaf_sum"]):
            raise AssertionError(f"lm_train {dtype}: metrics gap {m_gap}, "
                                 f"leaf sum gap {s_gap} past {tol}")


class _Routing:
    """``models.moe.top_k`` recorded in one run and replayed in the next,
    so that two runs of a MoE model that differ only in their attention
    send every token to the same experts (one bf16 ulp of the attention's
    output flips a near-tied expert otherwise, and with it that token's
    gradients); ``flips`` counts the (token, slot) choices that the
    replayed run would have made otherwise.  A dense model never calls
    it."""

    def __init__(self, moe):
        self.moe, self.real, self.calls, self.flips = moe, moe.top_k, [], 0

    def record(self, probs, k):
        vals, idx = self.real(probs, k)
        self.calls.append(idx)
        return vals, idx

    def replay(self, probs, k):
        idx = self.calls.pop(0)
        self.flips += int((self.real(probs, k)[1] != idx).sum())
        return probs.gather(-1, idx), idx


def _train_full(torch, configs, prng, optim, steps, data, attention,
                models, layers, flash_attn, flash_attn_bwd, spec,
                fa_ms) -> dict:
    """A config at its published widths, depth cut to ``spec``'s
    ``n_layers``: one micro-batch's loss and gradients through the kernels
    against the plain chunked attention and the plain selective scan under
    autograd on the card (a MoE model's expert choices recorded in the
    kernel run and replayed in the plain one, :class:`_Routing`), then a
    warm-up step and the timed steps of ``build_train_step`` at the
    config's own optimizer plan (the main path, the kernels' launches
    counted from 0 just before the timed steps).  ``fa_ms`` holds one
    forward and one backward call's device milliseconds at this shape (of
    the attention, or of the scan: ``scan_forward``, ``scan_backward``),
    or is None where they were not timed.  Returns the launches by
    kernel."""
    import functools

    from repro_torch.kernels import ssm_scan, ssm_scan_bwd
    from repro_torch.models import moe
    from repro_torch.models import ssm as ssm_model
    full = configs.get(spec["arch"])
    cfg = dataclasses.replace(full, n_layers=spec["n_layers"])
    t0 = time.perf_counter()
    params = models.init_params(cfg, prng.PRNGKey(0, device="cuda"))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    dcfg = data.DataConfig(seed=0, seq_len=spec["seq_len"],
                           global_batch=spec["global_batch"],
                           vocab_size=cfg.vocab_size)

    def batch(step):
        return {k: torch.from_numpy(v).cuda()
                for k, v in data.batch_for_model(cfg, dcfg, step).items()}

    # One micro-batch (the first row of step 0), kernels against plain.
    one = {k: v[:1] for k, v in batch(0).items()}
    live = layers.tree_map(lambda t: t.detach().requires_grad_(True),
                           params)
    items = layers.tree_items(live)
    leaves = [t for _, t in items]
    routing = _Routing(moe)

    def loss_grads(top_k):
        moe.top_k = top_k
        try:
            loss, _ = models.loss_fn(live, cfg, one)
            # A stack cut to no layers (DeepSeek-V3's MoE stack) has
            # empty leaves that the loss never reads.
            return loss.detach(), torch.autograd.grad(
                loss, leaves, allow_unused=True, materialize_grads=True)
        finally:
            moe.top_k = routing.real

    kernel_loss, kernel_grads = loss_grads(routing.record)
    kernel_attention, kernel_scan = attention.flash_attention, \
        ssm_model.ssm_scan
    attention.flash_attention = attention.chunked_attention
    ssm_model.ssm_scan = functools.partial(kernel_scan, plain=True)
    try:
        plain_loss, plain_grads = loss_grads(routing.replay)
    finally:
        attention.flash_attention = kernel_attention
        ssm_model.ssm_scan = kernel_scan
    if routing.calls:
        raise AssertionError(f"{cfg.name}: {len(routing.calls)} recorded "
                             f"routings not replayed")
    loss_gap = abs(kernel_loss.item() - plain_loss.item())
    grad_gaps = {path: _scaled_err(g, w) for (path, _), g, w in
                 zip(items, kernel_grads, plain_grads)
                 if w.numel()}
    del live, items, leaves, kernel_grads, plain_grads
    gc.collect()
    torch.cuda.empty_cache()
    grad_gap = max(grad_gaps.values())
    emit({"phase": "lm_train", "model": cfg.name, "check": "full-width "
          "micro-batch: kernels against the plain chunked attention and "
          "scan under autograd", "loss_kernels": kernel_loss.item(),
          "loss_plain": plain_loss.item(), "loss_gap": loss_gap,
          "loss_gap_bound": LM_TRAIN_LOSS_GAP, "grad_gap_by_leaf": grad_gaps,
          "grad_gap": grad_gap, "grad_gap_bound": LM_TRAIN_GRAD_GAP,
          "routing_replayed": cfg.is_moe,
          "routing_flips_plain_would_make": routing.flips})
    if not (loss_gap <= LM_TRAIN_LOSS_GAP and grad_gap <= LM_TRAIN_GRAD_GAP):
        raise AssertionError(f"{cfg.name} full-width training: kernels "
                             f"against plain loss gap {loss_gap}, gradient "
                             f"gap {grad_gap}")

    ocfg = optim.OptConfig.from_model(cfg)
    fn, _ = steps.build_train_step(cfg, opt_cfg=ocfg)
    state = optim.init(params, ocfg)
    t0 = time.perf_counter()
    params, state, _ = fn(params, state, batch(0))          # warm-up
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    flash_attn.LAUNCHES = flash_attn_bwd.LAUNCHES = 0
    ssm_scan.LAUNCHES = ssm_scan_bwd.LAUNCHES = 0
    step_s, metrics = [], []
    for i in range(spec["timed_steps"]):
        b = batch(1 + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = fn(params, state, b)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    launches = {"flash_attention": flash_attn.LAUNCHES,
                "flash_attention_bwd": flash_attn_bwd.LAUNCHES,
                "ssm_scan": ssm_scan.LAUNCHES,
                "ssm_scan_bwd": ssm_scan_bwd.LAUNCHES}
    n = spec["timed_steps"]
    micro = min(cfg.micro_batches, spec["global_batch"])
    # A micro-batch: each layer's attention forward and selective scan
    # twice under remat (the block's forward, then its recomputation in
    # the backward), the mtp block's once (transformer.mtp_loss does not
    # remat it); one backward each.  An SSM layer has no attention, a
    # hybrid layer both.
    mtp = 1 if cfg.use_mtp else 0
    attn = cfg.family != "ssm"
    scan = cfg.family in ("ssm", "hybrid")
    fwd_layers = cfg.n_layers * (2 if cfg.remat else 1)
    expected = {"flash_attention": n * micro * (fwd_layers + mtp) * attn,
                "flash_attention_bwd": n * micro * (cfg.n_layers + mtp)
                * attn,
                "ssm_scan": n * micro * fwd_layers * scan,
                "ssm_scan_bwd": n * micro * cfg.n_layers * scan}
    tokens = spec["global_batch"] * spec["seq_len"]
    step_mean = sum(step_s) / n
    # Model FLOPs: 6 per active parameter and token, plus attention's two
    # products (2 (D + Dv) a kept pair a head, under the window the pairs
    # it keeps) three times (forward, backward), over every layer and the
    # mtp block (S - 1 positions); the scan's elementwise work is not
    # counted.
    d_qk = (cfg.qk_nope_dim + cfg.qk_rope_dim) if cfg.use_mla \
        else cfg.head_dim
    d_v = cfg.v_head_dim if cfg.use_mla else cfg.head_dim
    seq = spec["seq_len"]
    rows = np.arange(seq)
    kept = float(np.minimum(rows + 1, cfg.attn_window).sum()
                 if cfg.attn_window else seq * (seq + 1) / 2)
    pairs = kept * cfg.n_layers + (seq - 1) * seq / 2 * mtp
    attn_flops = (3 * 2 * (d_qk + d_v) * cfg.n_heads * pairs
                  * spec["global_batch"])
    model_flops = 6 * cfg.active_param_count() * tokens + attn_flops
    rec = {"phase": "lm_train", "run": "full-width training",
           "model": cfg.name, **spec,
           "reduced": {"n_layers": [full.n_layers, cfg.n_layers]},
           "micro_batches": micro, "remat": cfg.remat,
           "optimizer": {"master": ocfg.master_dtype,
                         "moments": ocfg.moment_dtype,
                         "factored_second_moment":
                         ocfg.factored_second_moment,
                         "grad_accum": cfg.grad_accum_dtype},
           "params_b": cfg.param_count() / 1e9,
           "active_params_b": cfg.active_param_count() / 1e9,
           "init_s": init_s,
           "warmup_step_s": warmup_s, "step_ms": [x * 1e3 for x in step_s],
           "step_ms_mean": step_mean * 1e3,
           "tokens_per_s": tokens / step_mean,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": launches, "launches_expected": expected,
           "metrics": metrics,
           "model_tflop_per_step": model_flops / 1e12,
           "mfu_bf16": model_flops / step_mean / 989e12}
    if cfg.is_moe:
        rec["reduced"]["moe_layers"] = [full.n_moe_layers, cfg.n_moe_layers]
    if fa_ms is not None and attn:
        attention_ms = (launches["flash_attention"] * fa_ms["forward"]
                        + launches["flash_attention_bwd"]
                        * fa_ms["backward"]) / n
        rec.update(attention_ms_per_step=attention_ms,
                   attention_share=attention_ms / (step_mean * 1e3))
    if fa_ms is not None and scan:
        scan_ms = (launches["ssm_scan"] * fa_ms["scan_forward"]
                   + launches["ssm_scan_bwd"] * fa_ms["scan_backward"]) / n
        rec.update(scan_ms_per_step=scan_ms,
                   scan_share=scan_ms / (step_mean * 1e3))
    emit(rec)
    finite = all(math.isfinite(v) for m in metrics for v in m.values())
    if launches != expected or not finite:
        raise AssertionError(f"{cfg.name} full-width training: launches "
                             f"{launches}, expected {expected}; finite "
                             f"metrics {finite}")
    return launches


def _train_example(flash_attn, flash_attn_bwd) -> None:
    """``examples/train_lm.py`` at its default ``10m`` scale (head width
    40, the FMA kernels both ways) for 40 steps of 8 x 64 tokens on the
    card, checkpoints in a temporary directory: both kernels launch, the
    losses are finite and fall by more than 1."""
    from repro_torch.examples import train_lm
    cfg = train_lm.scale_config("10m")
    fwd, bwd = flash_attn.LAUNCHES, flash_attn_bwd.LAUNCHES
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as ckpt:
        out = train_lm.train(cfg, steps=40, seq=64, ckpt=ckpt, log_every=0)
    losses = [h.metrics["loss"] for h in out["history"]]
    launches = [flash_attn.LAUNCHES - fwd, flash_attn_bwd.LAUNCHES - bwd]
    emit({"phase": "lm_train", "run": "train_lm --scale 10m",
          "head_dim": cfg.head_dim, "steps": len(losses),
          "loss_first": losses[0], "loss_last": losses[-1],
          "launches_fwd_bwd": launches,
          "wall_s": time.perf_counter() - t0})
    if not (len(losses) == 40 and all(map(math.isfinite, losses))
            and losses[-1] < losses[0] - 1.0 and min(launches) > 0):
        raise AssertionError(f"train_lm 10m: losses {losses}, launches "
                             f"{launches}")


def phase_lm_train(torch, flash_attn, flash_attn_bwd, ssm_scan,
                   ssm_scan_bwd, ref, build, ref_values) -> dict:
    """The training paths of the dense, MoE, MLA, SSM and hybrid families;
    returns ``{entry: (summary record, launches)}`` for the summary's four
    entries of the gradients: attention's at (D, D) with the Qwen3-4B and
    Moonshot-v1-16B-A3B runs' launches, at (192, 128) with the DeepSeek-V3
    run's, under the window with the Hymba-1.5B run's, and the scan's with
    the Falcon-Mamba-7B and Hymba-1.5B runs'."""
    from repro_torch import configs, data, models, optim
    from repro_torch.core import prng
    from repro_torch.launch import steps
    from repro_torch.models import attention, layers

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    summary, mla_summary, window_summary = _fa_bwd_checks(
        torch, flash_attn, flash_attn_bwd, ref, build)
    scan_summary = _scan_bwd_checks(torch, ssm_scan, ssm_scan_bwd, build)
    for section, tols in (("lm_train", LM_TRAIN_TOL),
                          ("lm_train_moe", LM_TRAIN_MOE_TOL),
                          ("lm_train_ssm", LM_TRAIN_SSM_TOL),
                          ("lm_train_hybrid", LM_TRAIN_SSM_TOL)):
        _train_smoke_against_jax(torch, configs, prng, optim, steps, data,
                                 models.init_params, layers.tree_items,
                                 ref_values[section], tols)
    scan_ms = {"falcon_mamba_7b": {
                   "scan_forward": scan_summary[
                       "forward_with_checkpoints_ms"],
                   "scan_backward": scan_summary["ms"]},
               "hymba_1_5b": {
                   "scan_forward": scan_summary["hymba"][
                       "forward_with_checkpoints_ms"],
                   "scan_backward": scan_summary["hymba"]["ms"],
                   "forward": window_summary["forward_lse_ms"],
                   "backward": window_summary["graph_ms"]}}
    launches = {}
    for spec, rec, shape in ((LM_TRAIN, summary, "train"),
                             (LM_TRAIN_MLA, mla_summary, "mla_train"),
                             (LM_TRAIN_MOE, None, None),
                             (LM_TRAIN_SSM, None, None),
                             (LM_TRAIN_HYBRID, None, None)):
        fa_ms = scan_ms.get(spec["arch"]) if rec is None else {
            "forward": rec["forward_lse_cost"][shape]["lse_ms"],
            "backward": rec["graph_ms"]}
        launches[spec["arch"]] = _train_full(
            torch, configs, prng, optim, steps, data, attention, models,
            layers, flash_attn, flash_attn_bwd, spec, fa_ms)
        gc.collect()
        torch.cuda.empty_cache()
    _train_example(flash_attn, flash_attn_bwd)
    emit({"phase": "lm_train", "wall_s": time.perf_counter() - t_phase})
    return {"flash_attention_bwd": (
                summary,
                launches[LM_TRAIN["arch"]]["flash_attention_bwd"]
                + launches[LM_TRAIN_MOE["arch"]]["flash_attention_bwd"]),
            "flash_attention_bwd_mla": (
                mla_summary,
                launches[LM_TRAIN_MLA["arch"]]["flash_attention_bwd"]),
            "flash_attention_bwd_window": (
                window_summary,
                launches[LM_TRAIN_HYBRID["arch"]]["flash_attention_bwd"]),
            "ssm_scan_bwd": (
                scan_summary,
                launches[LM_TRAIN_SSM["arch"]]["ssm_scan_bwd"]
                + launches[LM_TRAIN_HYBRID["arch"]]["ssm_scan_bwd"])}


def kernel_entry(name: str, rec: dict, launches: int) -> dict:
    """One kernel's entry of the summary line.  ``timing`` says how ``ms``
    and ``library_ms`` were taken: "eager" (:func:`cuda_ms`, calls issued
    one by one from Python) or "graph" (:func:`graph_ms`, device time
    without the host's launch cost; ``eager_ms`` and ``library_eager_ms``
    then give the eager times of the same calls).  ``plain_ms`` is always
    eager."""
    entry = {"name": name, "route": "cuda", "source": SOURCES[name],
             "replaces": REPLACES[name], "launches": launches,
             "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
             "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
             "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
             "timing": rec.get("timing", "eager"),
             "shape": rec.get("shape", rec.get("n")),
             "unit": rec.get("unit", "one launch")}
    if "library" in rec:
        entry["library"] = rec["library"]
    if entry["timing"] == "graph":
        entry.update(eager_ms=rec["eager_ms"],
                     library_eager_ms=rec["library_eager_ms"])
    return entry


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    from repro_torch.core import (barrier, barrier_sim, fiveg, placement,
                                  prng, sweep, tuning, workloads)
    from repro_torch.examples import (bench_core, bench_energy,
                                      bench_faults, bench_multicluster,
                                      bench_resilience, bench_serving, fig4,
                                      fig5, fig6, fig7, fig_placement,
                                      fig_tuned_tree, fig_workload_tuned,
                                      figure_rows, fiveg_pipeline)
    from repro_torch.kernels import (_build, axpy, conv2d, dct, dotp, fft4,
                                     flash_attn, flash_attn_bwd, matmul, ops,
                                     powf, ref, ssm_scan, ssm_scan_bwd)
    from repro_torch.runtime import serving

    ref_values = json.loads(
        (ROOT / "src" / "repro_torch" / "reference_values.json").read_text())
    bench = {name: json.loads((ROOT / f"BENCH_{name}.json").read_text())
             for name in ("faults", "multicluster", "energy")}
    phase_info(torch, _build)
    summary = phase_kernels(torch, ops, fft4, matmul, ref)
    launches = phase_pipeline(torch, fiveg_pipeline, fft4, matmul, ops)
    phase_fig4a(torch, barrier, barrier_sim, prng, sweep, ref_values)
    fig7_rows = phase_fig7(torch, fiveg, fig7, prng, ref_values)
    more, more_launches = phase_dotp_axpy(torch, ops, dotp, axpy, ref)
    summary.update(more)
    launches.update(more_launches)
    phase_fig5(torch, fig5, workloads, figure_rows, ref_values)
    phase_fig6(torch, fig6, figure_rows, ref_values)
    phase_tuner(torch, placement, prng, sweep, tuning, ref_values)
    phase_fig7_tuned(torch, fig7, figure_rows, ref_values, fig7_rows)
    phase_normal(torch, prng, ref_values)
    summary["powf"], launches["powf"] = phase_powf(torch, powf, prng,
                                                   workloads, ref_values)
    phase_faults(torch, bench_faults, prng, tuning, ref_values,
                 bench["faults"])
    phase_fiveg_faults(torch, bench_faults, prng, ref_values,
                       bench["faults"])
    phase_fig4b(torch, fig4, ref_values)
    phase_multicluster(torch, bench_multicluster, barrier, prng, sweep,
                       ref_values, bench["multicluster"])
    phase_energy(torch, bench_energy, bench["energy"])
    phase_figures({"fig_placement": fig_placement,
                   "fig_tuned_tree": fig_tuned_tree,
                   "fig_workload_tuned": fig_workload_tuned},
                  figure_rows, ref_values)
    phase_resilience(torch, barrier, fiveg, prng, sweep, ref_values)
    launches["powf"] += phase_serving(
        torch, serving, fiveg, prng, sweep, tuning, powf,
        {"serving": bench_serving, "resilience": bench_resilience,
         "core": bench_core}, figure_rows, ref_values)
    more, more_launches = phase_dct_conv2d(torch, ops, dct, conv2d)
    summary.update(more)
    launches.update(more_launches)
    for name, (rec, count) in phase_lm_serve(torch, flash_attn, ssm_scan,
                                             _build, ref_values).items():
        summary[name], launches[name] = rec, count
    for name, (rec, count) in phase_lm_train(torch, flash_attn,
                                             flash_attn_bwd, ssm_scan,
                                             ssm_scan_bwd, ref, _build,
                                             ref_values).items():
        summary[name], launches[name] = rec, count

    emit({"kernels": [kernel_entry(name, summary[name], launches[name])
                      for name in KERNELS]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
