"""Arrival-time models for the paper's benchmark kernels (Sec. 4.2), port
of ``repro.core.workloads``.

Each model produces per-PE *completion times* (cycles) for one parallel
epoch of a kernel — the distribution whose CDF the paper plots in
Fig. 5 and which drives the barrier-radix selection of Fig. 6:

* AXPY / DOTP  — strictly local banks, uniform work -> steep CDF; DOTP
  adds an atomic reduction onto ONE shared variable, whose single-bank
  serialization scatters the arrivals by up to N_PE cycles.
* DCT / MATMUL — remote accesses through the shared interconnect;
  contention scatter grows with the input size.  The "2x4096" DCT maps
  every access to a local bank -> steepest CDF.
* Conv2D       — local accesses but imbalanced work: PEs on the
  zero-padded border finish early -> bimodal CDF.

Every model takes keys of shape ``(..., 2)`` and returns arrivals of
shape ``(..., n_pes)``, one epoch per key, on the keys' device, so a
whole trial batch is one call (:func:`arrival_batch`).  The draws go
through :mod:`repro_torch.core.prng` and the float32 arithmetic follows
the reference op for op: arrival batches match it bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from . import prng
from .topology import DEFAULT, TeraPoolConfig
from .xla_math import exp, powf


@dataclasses.dataclass(frozen=True)
class KernelCosts:
    axpy_per_elem: float = 3.0     # 2 ld + fmadd + st, local banks
    dotp_per_elem: float = 4.0     # 2 ld + fmadd (+ loop)
    dct_per_elem: float = 14.0     # 8-pt DCT butterflies per sample
    mac: float = 2.5               # MAC incl. avg. remote-load stall
    conv_inner_px: float = 30.0    # 3x3 MACs + ld/st per inner pixel
    conv_border_px: float = 9.0    # zero-skipped border pixel
    startup_jitter: float = 4.0    # scheduling jitter at epoch start
    contention_frac: float = 0.04  # scatter fraction for remote kernels
    local_frac: float = 0.004      # scatter fraction for local kernels


COSTS = KernelCosts()


def _f32(x: float) -> float:
    """A Python float rounded to float32, as JAX rounds a weakly typed
    scalar that meets a float32 array."""
    return float(np.float32(x))


def _jitter(key: torch.Tensor, n: int, scale: float) -> torch.Tensor:
    """Non-negative contention jitter: half-normal + uniform tail."""
    k = prng.split(key)
    hn = prng.normal(k[..., 0, :], (n,)).abs() * _f32(scale)
    un = prng.uniform(k[..., 1, :], (n,), 0.0, scale)
    return hn + un


def axpy_arrivals(key: torch.Tensor, n_elems: int,
                  cfg: TeraPoolConfig = DEFAULT,
                  costs: KernelCosts = COSTS) -> torch.Tensor:
    """y <- a*x + y, strictly tile-local banks."""
    work = (n_elems / cfg.n_pes) * costs.axpy_per_elem
    return _f32(work) + _jitter(key, cfg.n_pes,
                                costs.startup_jitter + costs.local_frac * work)


def dotp_arrivals(key: torch.Tensor, n_elems: int,
                  cfg: TeraPoolConfig = DEFAULT,
                  costs: KernelCosts = COSTS) -> torch.Tensor:
    """Dot product: local MAC loop + atomic add of the partial sum to a
    single shared variable.  All N_PE atomics target one bank: the
    arrival set the barrier sees is the sorted ready times pushed
    through the max-plus service queue."""
    work = (n_elems / cfg.n_pes) * costs.dotp_per_elem
    ready = _f32(work) + _jitter(key, cfg.n_pes,
                                 costs.startup_jitter
                                 + costs.local_frac * work)
    a = torch.sort(ready, dim=-1).values
    j = torch.arange(cfg.n_pes, dtype=torch.float32,
                     device=a.device) * cfg.bank_service_cycles
    start = torch.cummax(a - j, dim=-1).values + j
    return start + cfg.lat_cluster


def dct_arrivals(key: torch.Tensor, n_elems: int, *,
                 local_layout: bool = False,
                 cfg: TeraPoolConfig = DEFAULT,
                 costs: KernelCosts = COSTS) -> torch.Tensor:
    """Direct cosine transform; ``local_layout`` models the 2x4096 case
    where sequential addressing makes every access bank-local."""
    work = (n_elems / cfg.n_pes) * costs.dct_per_elem
    if local_layout:
        scale = costs.startup_jitter + costs.local_frac * work
    else:  # contention scatter grows sublinearly (sqrt) with work
        scale = costs.startup_jitter + costs.contention_frac * 25 * work ** 0.5
    return _f32(work) + _jitter(key, cfg.n_pes, scale)


def matmul_arrivals(key: torch.Tensor, n: int, p: int, m: int,
                    cfg: TeraPoolConfig = DEFAULT,
                    costs: KernelCosts = COSTS) -> torch.Tensor:
    """(n x p) @ (p x m): outputs split across PEs, rows/columns fetched
    through the shared interconnect; scatter grows with the input."""
    outs_per_pe = (n * m) / cfg.n_pes
    work = outs_per_pe * p * costs.mac
    scale = costs.startup_jitter + costs.contention_frac * 25 * work ** 0.5
    return _f32(work) + _jitter(key, cfg.n_pes, scale)


def conv2d_arrivals(key: torch.Tensor, h: int, w: int,
                    cfg: TeraPoolConfig = DEFAULT,
                    costs: KernelCosts = COSTS) -> torch.Tensor:
    """3x3 Conv2D: border-assigned PEs resolve zero pixels early."""
    px_per_pe = (h * w) / cfg.n_pes
    border_frac = (2 * h + 2 * w - 4) / (h * w)
    # jnp.round of the float32 product: round half to even.
    n_border = max(1, int(np.round(np.float32(border_frac * cfg.n_pes))))
    is_border = torch.arange(cfg.n_pes, device=key.device) < n_border
    work = torch.where(is_border, _f32(px_per_pe * costs.conv_border_px),
                       _f32(px_per_pe * costs.conv_inner_px))
    inner_work = px_per_pe * costs.conv_inner_px
    return work + _jitter(key, cfg.n_pes,
                          costs.startup_jitter
                          + costs.local_frac * inner_work)


# ---------------------------------------------------------------------------
# The benchmark suite of Fig. 5 / Fig. 6: kernel x input-dimension grid.
# ---------------------------------------------------------------------------

ArrivalFn = Callable[[torch.Tensor], torch.Tensor]


def benchmark_suite(cfg: TeraPoolConfig = DEFAULT,
                    costs: KernelCosts = COSTS
                    ) -> Dict[str, Dict[str, ArrivalFn]]:
    """kernel -> {input-label -> arrival sampler}."""
    def mk(fn, *args, **kw):
        return lambda key: fn(key, *args, cfg=cfg, costs=costs, **kw)

    return {
        "axpy": {
            "256Ki": mk(axpy_arrivals, 1 << 18),
            "512Ki": mk(axpy_arrivals, 1 << 19),
            "1Mi": mk(axpy_arrivals, 1 << 20),
        },
        "dotp": {
            "256Ki": mk(dotp_arrivals, 1 << 18),
            "512Ki": mk(dotp_arrivals, 1 << 19),
            "1Mi": mk(dotp_arrivals, 1 << 20),
        },
        "dct": {
            "2x4096": mk(dct_arrivals, 8192, local_layout=True),
            "64x4096": mk(dct_arrivals, 1 << 18),
            "256x4096": mk(dct_arrivals, 1 << 20),
        },
        "matmul": {
            "128x32x128": mk(matmul_arrivals, 128, 32, 128),
            "256x128x256": mk(matmul_arrivals, 256, 128, 256),
            "512x128x512": mk(matmul_arrivals, 512, 128, 512),
        },
        "conv2d": {
            "128x128": mk(conv2d_arrivals, 128, 128),
            "256x256": mk(conv2d_arrivals, 256, 256),
            "512x512": mk(conv2d_arrivals, 512, 512),
        },
    }


def cdf_first_last_gap(arrivals: torch.Tensor) -> torch.Tensor:
    """Fig. 5 summary statistic: slowest-PE minus fastest-PE runtime."""
    return arrivals.amax(dim=-1) - arrivals.amin(dim=-1)


# ---------------------------------------------------------------------------
# 5G application epoch models (Fig. 7): the arrival distributions the
# per-epoch workload tuner specializes the app's barriers to.
# ---------------------------------------------------------------------------

def _epoch_from_zero(key: torch.Tensor, work: float, jitter: float,
                     n: int) -> torch.Tensor:
    """``0 + work + uniform(0, jitter)``: the app simulator's epoch
    model, epoch-relative."""
    return _f32(work) + prng.uniform(key, (n,), 0.0, jitter)


def fiveg_stage_arrivals(key: torch.Tensor, app=None,
                         cfg: TeraPoolConfig = DEFAULT) -> torch.Tensor:
    """Per-PE arrivals into one FFT butterfly-stage barrier of the 5G
    app: ``ffts_per_round`` stages of work plus the uniform scheduling
    jitter of :class:`repro_torch.core.fiveg.FiveGConfig`."""
    from .fiveg import FiveGConfig
    app = app if app is not None else FiveGConfig()
    return _epoch_from_zero(key, app.epoch_work, app.epoch_jitter,
                            cfg.n_pes)


def fiveg_matmul_arrivals(key: torch.Tensor, app=None,
                          cfg: TeraPoolConfig = DEFAULT) -> torch.Tensor:
    """Per-PE arrivals into the barrier closing the beamforming MATMUL
    epoch (``FiveGConfig.mm_work`` / ``.mm_jitter``)."""
    from .fiveg import FiveGConfig
    app = app if app is not None else FiveGConfig()
    n = cfg.n_pes
    return _epoch_from_zero(key, app.mm_work(n), app.mm_jitter(n), n)


def straggler_arrivals(key: torch.Tensor, n_elems: int, *,
                       tail: str = "lognormal", frac: float = 0.05,
                       cfg: TeraPoolConfig = DEFAULT,
                       costs: KernelCosts = COSTS) -> torch.Tensor:
    """Heavy-tail straggler epoch: AXPY-like uniform local work where a
    ``frac`` fraction of PEs draws a heavy-tailed extra delay —
    lognormal (median 16 x the startup jitter, sigma 1) or a bounded
    Pareto (alpha 1.5) over [1x, 256x] the base work, drawn through its
    inverse CDF.  The Pareto tail's ``pow`` runs on the host, one C
    library ``powf`` call per element, for bit-exactness with the
    reference (:func:`repro_torch.core.xla_math.powf`; ROADMAP.md §3):
    on a card its cost grows with the number of PEs drawn."""
    if not 0.0 < frac <= 1.0:
        raise ValueError(f"straggler frac must be in (0, 1], got {frac}")
    k = prng.split(key, 3)
    k_base, k_pick, k_tail = k[..., 0, :], k[..., 1, :], k[..., 2, :]
    n = cfg.n_pes
    work = (n_elems / n) * costs.axpy_per_elem
    base = _f32(work) + _jitter(k_base, n, costs.startup_jitter
                                + costs.local_frac * work)
    if tail == "lognormal":
        extra = _f32(16.0 * costs.startup_jitter) * exp(
            prng.normal(k_tail, (n,)))
    elif tail == "pareto":
        alpha, lo, hi = 1.5, work, 256.0 * work
        u = prng.uniform(k_tail, (n,))
        extra = powf(_f32(lo ** -alpha)
                     - u * _f32(lo ** -alpha - hi ** -alpha), -1.0 / alpha)
    else:
        raise ValueError(
            f"unknown straggler tail {tail!r}; choose from "
            f"('lognormal', 'pareto')")
    straggles = prng.bernoulli(k_pick, frac, (n,))
    return base + torch.where(straggles, extra, 0.0)


# ---------------------------------------------------------------------------
# Uniform batched sampler API: kernel name -> stacked arrival matrices.
# ---------------------------------------------------------------------------

#: Flat Fig. 5/6 kernel x input names ("dotp_1Mi", "conv2d_512x512", ...).
FIG6_KERNELS: Tuple[str, ...] = tuple(
    f"{kernel}_{label}" for kernel, dims in benchmark_suite().items()
    for label in dims)

#: Every named arrival model: the Fig. 5/6 suite, the 5G epochs, and
#: the heavy-tail straggler epochs.
ARRIVAL_KERNELS: Tuple[str, ...] = FIG6_KERNELS + (
    "fiveg_fft_stage", "fiveg_matmul_row",
    "straggler_lognormal", "straggler_pareto")


def arrival_fns(cfg: TeraPoolConfig = DEFAULT, costs: KernelCosts = COSTS,
                app=None) -> Dict[str, ArrivalFn]:
    """Flat name -> sampler registry behind :data:`ARRIVAL_KERNELS`.
    ``app`` (a :class:`repro_torch.core.fiveg.FiveGConfig`)
    parameterizes the two 5G epoch models; ``None`` uses the paper's
    4x16-FFT design point."""
    flat: Dict[str, ArrivalFn] = {}
    for kernel, dims in benchmark_suite(cfg, costs).items():
        for label, fn in dims.items():
            flat[f"{kernel}_{label}"] = fn
    flat["fiveg_fft_stage"] = \
        lambda key: fiveg_stage_arrivals(key, app, cfg)
    flat["fiveg_matmul_row"] = \
        lambda key: fiveg_matmul_arrivals(key, app, cfg)
    flat["straggler_lognormal"] = \
        lambda key: straggler_arrivals(key, 1 << 18, tail="lognormal",
                                       cfg=cfg, costs=costs)
    flat["straggler_pareto"] = \
        lambda key: straggler_arrivals(key, 1 << 18, tail="pareto",
                                       cfg=cfg, costs=costs)
    return flat


def arrival_batch(key: torch.Tensor, kernel: str, shape: Tuple[int, int],
                  cfg: TeraPoolConfig = DEFAULT, costs: KernelCosts = COSTS,
                  app=None) -> torch.Tensor:
    """Stacked per-PE arrival matrices for one kernel's epoch model,
    ``shape = (n_trials, n_pes)``, on ``key``'s device: row ``t`` is the
    kernel's arrival vector under the ``t``-th split of ``key``, all
    rows drawn in one batched call.  ``n_pes`` different from
    ``cfg.n_pes`` re-scales the machine (same problem size on a smaller
    cluster).  ``straggler_pareto`` takes its ``pow`` on the host (see
    :func:`straggler_arrivals`), one call per trial and PE."""
    n_trials, n_pes = (int(x) for x in shape)
    if n_trials < 1:
        raise ValueError(f"need at least one trial, got {n_trials}")
    if n_pes != cfg.n_pes:
        cfg = dataclasses.replace(cfg, n_pes=n_pes)
    fns = arrival_fns(cfg, costs, app)
    try:
        fn = fns[kernel]
    except KeyError:
        raise ValueError(
            f"unknown arrival kernel {kernel!r}; choose from "
            f"{tuple(fns)}") from None
    return fn(prng.split(key, n_trials))
