"""End-to-end training (port of ``examples/train_lm.py``): data pipeline
-> train step -> fault-tolerant runner with atomic checkpoints, on one
device.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu \\
        --steps 40 --seq 64
    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300
    PYTHONPATH=src python -m repro_torch.examples.train_lm --scale 100m \\
        --steps 300

``--scale 100m`` trains a ~100M-parameter qwen3-family model, the default
``10m`` about 10M.  Restarting the same command resumes from the latest
checkpoint under ``--ckpt``.  On the card the attention runs the
flash-attention kernels, forward and backward (``10m``'s head width 40,
``100m``'s 64).  ``--sync`` names the reference's
gradient-synchronisation schedule across devices; on one device there
is nothing to synchronise, and a schedule other than the default waits
for the port's multi-device slice.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import optim, resolve_device
from repro_torch.core import prng
from repro_torch.data import DataConfig, batch_for_model
from repro_torch.launch import steps as steps_mod
from repro_torch.models import ModelConfig, init_params
from repro_torch.runtime import FaultConfig, FaultTolerantRunner

SCALES = {
    "10m": dict(n_layers=6, d_model=320, n_heads=8, n_kv_heads=4,
                d_ff=1280, vocab_size=8192),
    "100m": dict(n_layers=12, d_model=640, n_heads=10, n_kv_heads=5,
                 d_ff=2560, vocab_size=32000),
}


def scale_config(scale: str) -> ModelConfig:
    """The qwen3-family model of ``--scale`` (the reference's)."""
    return ModelConfig(name=f"lm-{scale}", family="dense", qk_norm=True,
                       attn_chunk=128, micro_batches=1, **SCALES[scale])


def train(cfg: ModelConfig, *, steps: int = 300, seq: int = 256,
          batch: int = 8, lr: float = 3e-3, ckpt: str = "runs/train_lm",
          ckpt_every: int = 100, log_every: int = 20,
          device="cuda") -> dict:
    """Train ``cfg`` from ``init_params(cfg, PRNGKey(0))`` on ``device``
    for ``steps`` steps of ``batch`` x ``seq`` tokens of the synthetic
    stream (seed 0) through :func:`~repro_torch.launch.steps.
    build_train_step` and a :class:`FaultTolerantRunner` that checkpoints
    ``(params, opt_state)`` under ``ckpt`` every ``ckpt_every`` steps and
    at the end, resuming from the latest checkpoint there.  Returns the
    step it started from, the runner's per-step records and the final
    ``(params, opt_state)``."""
    dev = resolve_device(device)
    ocfg = optim.OptConfig.from_model(cfg, lr=lr, warmup_steps=20,
                                      total_steps=steps)
    dcfg = DataConfig(seed=0, seq_len=seq, global_batch=batch,
                      vocab_size=cfg.vocab_size)
    fn, _ = steps_mod.build_train_step(cfg, opt_cfg=ocfg, device=dev)
    params = init_params(cfg, prng.PRNGKey(0, device=dev))
    opt_state = optim.init(params, ocfg)

    def step_fn(state, batch_in):
        p, s = state
        p, s, metrics = fn(p, s, batch_in)
        return (p, s), metrics

    def batch_fn(step):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in batch_for_model(cfg, dcfg, step).items()}

    runner = FaultTolerantRunner(
        FaultConfig(ckpt_dir=ckpt, ckpt_every=ckpt_every),
        step_fn=step_fn, batch_fn=batch_fn,
        state_template=(params, opt_state))
    start = runner.resume_step()
    del params, opt_state
    t0 = time.time()

    def on_step(st):
        if log_every and st.step % log_every == 0:
            rate = (st.step + 1 - start) * dcfg.seq_len \
                * dcfg.global_batch / max(time.time() - t0, 1e-9)
            print(f"step {st.step:5d}  loss {st.metrics['loss']:.4f}"
                  f"  grad_norm {st.metrics['grad_norm']:.3f}"
                  f"  tok/s {rate:,.0f}", flush=True)

    state = runner.run(steps, on_step=on_step)
    return {"start": start, "history": runner.history, "state": state}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", default="10m", choices=sorted(SCALES))
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default="runs/train_lm")
    ap.add_argument("--sync", default="hierarchical",
                    choices=["hierarchical", "flat"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.sync != "hierarchical":
        raise NotImplementedError(
            f"--sync {args.sync}: gradient synchronisation across devices "
            f"waits for the port's multi-device slice")

    cfg = scale_config(args.scale)
    print(f"model: {cfg.param_count() / 1e6:.1f}M params")
    out = train(cfg, steps=args.steps, seq=args.seq, batch=args.batch,
                lr=args.lr, ckpt=args.ckpt, device=args.device)
    if out["start"]:
        print(f"resumed from checkpointed step {out['start']}")
    print("done.")


if __name__ == "__main__":
    main()
