"""The ``lm_train`` section of ``src/repro_torch/reference_values.json``:
three steps of the JAX package's ``build_train_step`` (under its smoke
mesh) on the qwen3 smoke config, 2 micro-batches of a global batch of 4
x 32 tokens from ``data.batch_for_model`` (seed 0, steps 0-2), AdamW
``OptConfig.from_model(cfg, lr=1e-3, warmup_steps=1, total_steps=10)``,
from ``init_params(PRNGKey(0))`` drawn on JAX's default threefry stream
(``jax_threefry_partitionable`` on, as stored; the port's ``prng`` draws
the same stream by default).  Two variants: "float32" computes in float32
on the config's bf16 weights, "bfloat16" is the config as published.
Each holds the digests of the initial leaves, each step's metrics
(``loss``, ``ce``, ``aux``, ``grad_norm``), and each updated leaf's
float64 sum and sum of absolute values after the third step.
``chip_smoke.py``'s ``lm_train`` phase holds the card to it without
importing JAX.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_lm_train_values.py

rewrites the section (~20 s on the CPU).  The tests below recompute it
with JAX, and hold the port's CPU run to it at :data:`TOL`: per variant,
the metrics' relative bound, and a leaf's sum within a share of its sum
of absolute values (the weights of elements whose AdamW step flips sign
move by ``2 lr`` a step, the others by bf16 rounding).
"""
import dataclasses
import hashlib
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro import optim as joptim
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.models import init_params as jinit_params
from repro_torch import configs, optim
from repro_torch.core import prng
from repro_torch.data import DataConfig, batch_for_model
from repro_torch.launch import steps
from repro_torch.models import init_params
from repro_torch.models.layers import tree_items
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

PATH = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "reference_values.json")
SECTION = "lm_train"
ARCH = "qwen3_4b"
STEPS, MICRO, BATCH, SEQ, SEED = 3, 2, 4, 32, 0
OPT = {"lr": 1e-3, "warmup_steps": 1, "total_steps": 10}
# Metrics to a relative bound; a leaf's sum to a share of its sum of
# absolute values.  The port on the CPU is seen within 1.6e-6 (float32)
# and 4.3e-4 (bfloat16) of the metrics and within 2.7e-7 and 1.7e-5 of the
# leaf sums; chip_smoke.py holds the card to the same bounds.
TOL = {"float32": {"metrics": 1e-5, "leaf_sum": 1e-4},
       "bfloat16": {"metrics": 5e-3, "leaf_sum": 2e-3}}


def _overrides(dtype: str) -> dict:
    return {"compute_dtype": dtype, "micro_batches": MICRO}


def _batches(cfg) -> list:
    dcfg = DataConfig(seed=SEED, seq_len=SEQ, global_batch=BATCH,
                      vocab_size=cfg.vocab_size)
    return [batch_for_model(cfg, dcfg, i) for i in range(STEPS)]


def digests(paths, leaves) -> dict:
    """sha256 (first 16 hex digits) of each leaf's bytes, by path."""
    return {p: hashlib.sha256(np.ascontiguousarray(a).tobytes())
            .hexdigest()[:16] for p, a in zip(paths, leaves)}


def _sums(paths, leaves) -> dict:
    out = {}
    for p, a in zip(paths, leaves):
        a = np.asarray(a, np.float64)
        out[p] = [float(a.sum()), float(np.abs(a).sum())]
    return out


def section() -> dict:
    """The section as the JAX package computes it now."""
    out = {"arch": ARCH, "steps": STEPS, "micro_batches": MICRO,
           "global_batch": BATCH, "seq_len": SEQ, "data_seed": SEED,
           "opt": OPT, "threefry_partitionable":
           bool(jax.config.jax_threefry_partitionable), "variants": {}}
    paths = [p for p, _ in tree_items(
        init_params(configs.get_smoke(ARCH), prng.PRNGKey(0, device="cpu")))]
    for dtype in ("float32", "bfloat16"):
        jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH),
                                   **_overrides(dtype))
        jocfg = joptim.OptConfig.from_model(jcfg, **OPT)
        params = jinit_params(jcfg, jax.random.PRNGKey(0))
        init_digests = digests(paths, jax.tree.map(
            lambda x: np.asarray(x).view(np.uint16)
            if x.dtype == jnp.bfloat16 else np.asarray(x),
            jax.tree.leaves(params)))
        mesh = jmesh.make_smoke_mesh()
        metrics = []
        with jax.set_mesh(mesh):
            fn, _ = jsteps.build_train_step(jcfg, mesh, opt_cfg=jocfg)
            state = joptim.init(params, jocfg)
            for b in _batches(jcfg):
                params, state, m = fn(params, state,
                                      jax.tree.map(jnp.asarray, b))
                metrics.append({k: float(v) for k, v in sorted(m.items())})
        out["variants"][dtype] = {
            "overrides": _overrides(dtype), "digests": init_digests,
            "metrics": metrics,
            "leaf_sums": _sums(paths, [jnp.asarray(x, jnp.float32)
                                       for x in jax.tree.leaves(params)])}
    return out


def port_run(cfg, device="cpu") -> tuple:
    """The port's three steps: (initial leaves, metrics per step, final
    leaves), leaves as (path, tensor) in sorted order (the initial ones
    copied: the train step updates the weights in place)."""
    ocfg = optim.OptConfig.from_model(cfg, **OPT)
    params = init_params(cfg, prng.PRNGKey(0, device=device))
    first = [(p, t.clone()) for p, t in tree_items(params)]
    fn, _ = steps.build_train_step(cfg, opt_cfg=ocfg, device=device)
    state = optim.init(params, ocfg)
    metrics = []
    for b in _batches(cfg):
        params, state, m = fn(params, state, {
            k: torch.from_numpy(v).to(device) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return first, metrics, tree_items(params)


def check(ref: dict, dtype: str, first, metrics, last) -> dict:
    """Hold one variant's run to the stored values at :data:`TOL`; returns
    the largest gaps seen."""
    want = ref["variants"][dtype]
    got = digests([p for p, _ in first],
                  [t.detach().cpu().view(torch.int16).numpy()
                   if t.dtype == torch.bfloat16 else t.detach().cpu().numpy()
                   for _, t in first])
    assert got == want["digests"], (dtype, "init differs")
    tol = TOL[dtype]
    m_gap = 0.0
    for g, w in zip(metrics, want["metrics"]):
        assert sorted(g) == sorted(w)
        for k in w:
            gap = abs(g[k] - w[k]) / max(abs(w[k]), 1e-6)
            m_gap = max(m_gap, gap if w[k] else abs(g[k]))
    sums = _sums([p for p, _ in last],
                 [t.detach().float().cpu().numpy() for _, t in last])
    s_gap = max(abs(sums[p][0] - s) / l1
                for p, (s, l1) in want["leaf_sums"].items())
    assert m_gap <= tol["metrics"], (dtype, m_gap)
    assert s_gap <= tol["leaf_sum"], (dtype, s_gap)
    return {"metrics_gap": m_gap, "leaf_sum_gap": s_gap}


def _load() -> dict:
    return json.loads(PATH.read_text())[SECTION]


def test_section_matches_jax():
    """The stored runs are what the JAX package computes now."""
    assert _load() == json.loads(json.dumps(section()))


def test_section_matches_port():
    """The port's train step on the CPU holds to the stored values."""
    ref = _load()
    assert ref["threefry_partitionable"]
    for dtype in ref["variants"]:
        cfg = dataclasses.replace(configs.get_smoke(ARCH),
                                  **ref["variants"][dtype]["overrides"])
        check(ref, dtype, *port_run(cfg))


if __name__ == "__main__":
    values = json.loads(PATH.read_text())
    values[SECTION] = section()
    PATH.write_text(json.dumps(values, indent=1) + "\n")
    print(f"wrote {SECTION} to {PATH}", file=sys.stderr)
