"""Batched serving (port of ``examples/serve_lm.py``): prefill a batch of
prompts, then decode new tokens step by step against the caches (the KV
cache, the latent cache under multi-head latent attention, the SSM
family's conv and scan states), greedily.  The dense, MoE (moonshot),
MLA + MoE (deepseek-v3), SSM (falcon-mamba) and hybrid (hymba) families
serve; on the card the prefill attention runs the flash-attention
kernel (under hymba's sliding window too) and the prefill scan the
selective-scan kernel.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu \\
        --arch deepseek-v3-671b
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu \\
        --arch falcon_mamba_7b          # also hymba_1_5b
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --full \\
        --batch 4 --prompt-len 2016 --tokens 32

``--full`` runs the published config.  Qwen3-4B, Hymba-1.5B and
Falcon-Mamba-7B (14.5 GB in bf16) fit one H100, and so would
moonshot-v1-16b-a3b's 28.4 B parameters (56.8 GB in bf16), which no run
has served yet; DeepSeek-V3's 671.7 B do not: ``chip_smoke.py`` serves
it at its published widths with its depth cut to 4 layers through
:func:`serve`.

As in the reference, the prefill covers ``prompt_len + tokens`` random
prompt tokens and decode step ``i`` writes position ``prompt_len + i``.
Prompts come from a seeded numpy generator; the weights from the port's
``init_params`` (the reference's, bit for bit) with ``PRNGKey(0)`` on
the device.  Without ``--full`` the architecture's smoke config runs.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch import configs
from repro_torch.core import prng
from repro_torch.kernels import flash_attn, ssm_scan
from repro_torch.launch import steps
from repro_torch.models import init_params


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# Prompts are drawn from this seed.
PROMPT_SEED = 0


def prompts(cfg, batch: int, length: int) -> np.ndarray:
    """(batch, length) int64 token ids, uniform over the vocabulary."""
    rng = np.random.default_rng(PROMPT_SEED)
    return rng.integers(0, cfg.vocab_size, (batch, length), dtype=np.int64)


def serve(cfg, *, batch: int = 4, prompt_len: int = 48, tokens: int = 32,
          device="cuda") -> dict:
    """Prefill ``batch`` prompts of ``prompt_len + tokens`` tokens, then
    ``tokens - 1`` greedy decode steps, with the weights of
    ``init_params(cfg, PRNGKey(0))`` on ``device`` (timed as
    ``init_s``).  One untimed prefill and decode step run first (the
    process's first use of each kernel on these shapes).  Returns the
    timings, the timed prefill's last logits, the generated tokens
    (batch, tokens), the prefill calls made, the peak device memory of
    the timed run and the weights."""
    if cfg.family == "encoder":
        raise ValueError("encoder-only architectures do not decode")
    dev = resolve_device(device)
    max_len = prompt_len + tokens
    t0 = time.perf_counter()
    params = init_params(cfg, prng.PRNGKey(0, device=dev))
    _sync(dev)
    init_s = time.perf_counter() - t0
    prefill, _ = steps.build_prefill_step(cfg, batch=batch, seq_len=max_len,
                                          device=dev)
    decode, _ = steps.build_decode_step(cfg, batch=batch, max_len=max_len,
                                        device=dev)
    tokens_in = torch.from_numpy(prompts(cfg, batch, max_len)).to(dev)
    pos0 = torch.full((batch,), prompt_len, dtype=torch.int32, device=dev)
    logits, caches = prefill(params, {"tokens": tokens_in})     # warm-up
    decode(params, caches, logits[:, -1].argmax(-1)[:, None], pos0)
    del logits, caches
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    t0 = time.perf_counter()
    logits, caches = prefill(params, {"tokens": tokens_in})
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    first_logits = logits[:, -1]
    tok = first_logits.argmax(-1)
    generated = [tok]
    t0 = time.perf_counter()
    for i in range(tokens - 1):
        logits, caches = decode(params, caches, tok[:, None], pos0 + i)
        tok = logits[:, 0].argmax(-1)
        generated.append(tok)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    return {"init_s": init_s, "prefill_s": prefill_s, "decode_s": decode_s,
            "decode_tok_s": (tokens - 1) * batch / decode_s
            if tokens > 1 else None,
            "prefill_calls": 2, "first_logits": first_logits,
            "tokens": torch.stack(generated, dim=1),
            "peak_bytes": peak, "params": params}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="the published config instead of the smoke one")
    args = ap.parse_args(argv)

    cfg = (configs.get if args.full else configs.get_smoke)(args.arch)
    flash_attn.LAUNCHES = ssm_scan.LAUNCHES = 0
    out = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                tokens=args.tokens, device=args.device)
    max_len = args.prompt_len + args.tokens
    print(f"{cfg.name} on {args.device}: init {out['init_s']:.1f} s")
    print(f"prefill {args.batch}x{max_len}: {out['prefill_s'] * 1e3:.0f} ms")
    if out["decode_tok_s"] is not None:
        print(f"decode {args.tokens - 1} steps: {out['decode_s'] * 1e3:.0f} "
              f"ms ({out['decode_tok_s']:.1f} tok/s)")
    print(f"flash_attention launches: {flash_attn.LAUNCHES}, ssm_scan "
          f"launches: {ssm_scan.LAUNCHES}, over {out['prefill_calls']} "
          f"prefills (a warm-up and the timed one)")
    peak = out["peak_bytes"]
    print("peak device memory: "
          + ("not measured (CPU)" if peak is None else f"{peak / 2**30:.2f} GiB"))
    print("generated token ids (first sequence):",
          out["tokens"][0].tolist()[:16], "...")


if __name__ == "__main__":
    main()
