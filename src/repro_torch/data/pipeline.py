"""Deterministic synthetic data pipeline (port of
``repro.data.pipeline``: numpy only, the same bits).

Produces seeded, reproducible token batches with a next-token LM
structure (so loss curves are meaningful: the stream mixes Zipfian
unigrams with copy/induction patterns that a real model can learn).

Sharding contract: ``global_batch(step)`` is a pure function of
(seed, step), so every host can materialize exactly its own rows
without communication — host i of H loads rows [i*B/H, (i+1)*B/H).
Restart-safe by construction: the loader has no mutable state.  Batches
are numpy arrays; the caller moves them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from ..models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    seq_len: int = 1024
    global_batch: int = 8
    vocab_size: int = 32000
    zipf_alpha: float = 1.2
    copy_period: int = 64      # induction-pattern period


def _zipf_probs(v: int, alpha: float) -> np.ndarray:
    p = 1.0 / np.arange(1, v + 1) ** alpha
    return p / p.sum()


class SyntheticLM:
    """Stateless-by-step synthetic LM stream."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._probs = _zipf_probs(cfg.vocab_size, cfg.zipf_alpha)

    def batch(self, step: int, *, host_id: int = 0,
              host_count: int = 1) -> Dict[str, np.ndarray]:
        """The rows of global batch ``step`` owned by this host."""
        cfg = self.cfg
        if cfg.global_batch % host_count:
            raise ValueError("global_batch must divide across hosts")
        rows = cfg.global_batch // host_count
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, host_id]))
        toks = rng.choice(cfg.vocab_size, p=self._probs,
                          size=(rows, cfg.seq_len + 1)).astype(np.int32)
        # Periodic copying: positions t copy t - copy_period, giving the
        # model an induction signal.
        t = np.arange(cfg.seq_len + 1)
        mask = (t % cfg.copy_period) >= (cfg.copy_period // 2)
        src = np.maximum(t - cfg.copy_period // 2, 0)
        toks[:, mask] = toks[:, src[mask]]
        return {"tokens": toks[:, :-1],
                "targets": toks[:, 1:].copy()}

    def iterator(self, start_step: int = 0, *, host_id: int = 0,
                 host_count: int = 1) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch(step, host_id=host_id, host_count=host_count)
            step += 1


def batch_for_model(mcfg: ModelConfig, dcfg: DataConfig, step: int,
                    *, host_id: int = 0, host_count: int = 1
                    ) -> Dict[str, np.ndarray]:
    """Adapt the LM stream to a model family's input schema (audio
    frontends take frame embeddings; VLMs add stub patch embeddings)."""
    stream = SyntheticLM(dataclasses.replace(
        dcfg, vocab_size=min(dcfg.vocab_size, mcfg.vocab_size)))
    b = stream.batch(step, host_id=host_id, host_count=host_count)
    out: Dict[str, np.ndarray] = {"targets": b["targets"]}
    rows = b["tokens"].shape[0]
    if mcfg.frontend == "audio":
        rng = np.random.default_rng(
            np.random.SeedSequence([dcfg.seed, step, host_id, 7]))
        out["features"] = rng.standard_normal(
            (rows, dcfg.seq_len, mcfg.d_model)).astype(np.float32) * 0.02
    else:
        out["tokens"] = b["tokens"]
        if mcfg.frontend == "vision":
            rng = np.random.default_rng(
                np.random.SeedSequence([dcfg.seed, step, host_id, 11]))
            out["img_embeds"] = rng.standard_normal(
                (rows, mcfg.n_frontend_tokens, mcfg.d_model)
            ).astype(np.float32) * 0.02
    return out
