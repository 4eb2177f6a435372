"""Quickstart (port of ``examples/quickstart.py``): the paper's barrier
simulator and a tiny training run.

    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
    PYTHONPATH=src python -m repro_torch.examples.quickstart
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import configs, optim, resolve_device
from repro_torch.core import barrier, barrier_sim, fiveg, prng
from repro_torch.data import DataConfig, batch_for_model
from repro_torch.models import init_params, loss_fn
from repro_torch.models.layers import _unflatten, tree_items, tree_map


def barrier_demo(device="cuda") -> None:
    dev = resolve_device(device)
    print("== TeraPool barrier simulator (paper Fig. 4a) ==")
    key = prng.PRNGKey(0, device=dev)
    for delay in (0.0, 2048.0):
        spans = {r: float(barrier_sim.mean_span_cycles(
            key, barrier.kary_tree(r), delay, n_trials=8, device=dev))
            for r in (2, 16, 32, 256, 1024)}
        best = min(spans, key=spans.get)
        print(f" max_delay={int(delay):5d}: "
              + "  ".join(f"r{r}={v:7.1f}" for r, v in spans.items())
              + f"   -> best radix {best}")

    print("\n== 5G OFDM + beamforming (paper Fig. 7) ==")
    res = fiveg.compare_barriers(key, fiveg.FiveGConfig(
        n_rx=16, ffts_per_round=1), radix=32, device=dev)
    print(f" radix-32 partial barriers: {float(res['speedup_partial']):.2f}x"
          f" over central counter; sync fraction "
          f"{float(res['partial'].sync_fraction) * 100:.1f}%")


def train_demo(steps: int = 20, device="cuda") -> list:
    """``steps`` AdamW steps of the qwen3 smoke config on the synthetic
    stream; returns the losses."""
    dev = resolve_device(device)
    print("\n== 20 training steps on a reduced qwen3-family model ==")
    cfg = configs.get_smoke("qwen3_4b")
    dcfg = DataConfig(seed=0, seq_len=64, global_batch=8,
                      vocab_size=cfg.vocab_size)
    ocfg = optim.OptConfig.from_model(cfg, lr=3e-3, warmup_steps=5)
    params = init_params(cfg, prng.PRNGKey(0, device=dev))
    state = optim.init(params, ocfg)
    losses = []
    for i in range(steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in batch_for_model(cfg, dcfg, i).items()}
        items = tree_items(params)
        leaves = [t.requires_grad_(True) for _, t in items]
        loss, _ = loss_fn(params, cfg, batch)
        grads = torch.autograd.grad(loss, leaves)
        grads = _unflatten(params, {p: g for (p, _), g in zip(items, grads)})
        params, state = optim.update(
            grads, state, tree_map(torch.Tensor.detach, params), ocfg)
        losses.append(float(loss.detach()))
        if i % 5 == 0 or i == steps - 1:
            print(f" step {i:3d}  loss {losses[-1]:.4f}")
    return losses



def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    barrier_demo(args.device)
    train_demo(device=args.device)


if __name__ == "__main__":
    main()
