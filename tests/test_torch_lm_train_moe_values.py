"""The ``lm_train_moe`` section of ``src/repro_torch/reference_values.json``:
three steps of the JAX package's ``build_train_step`` (under its smoke
mesh) on the DeepSeek-V3 smoke config: multi-head latent attention at
(D, Dv) = (24, 16), a leading dense layer, two MoE layers of 8 routed
experts (top-2) and a shared one whose routers add the auxiliary loss,
and the multi-token-prediction head.  The config's own training plan:
bf16 master weights, an int8 first moment, a factored second moment,
gradients summed in bf16.  The batches, micro-batches and optimizer
settings are ``lm_train``'s (``tests/test_torch_lm_train_values.py``): 2
micro-batches of a global batch of 4 x 32 tokens from
``data.batch_for_model`` (seed 0, steps 0-2), ``OptConfig.from_model(cfg,
lr=1e-3, warmup_steps=1, total_steps=10)``, from
``init_params(PRNGKey(0))`` on JAX's default threefry stream.  Two
variants: "float32" computes in float32 on the config's bf16 weights with
the published routing; "bfloat16" is the config as published with
``tests/lm_parity.py``'s ``neutral_routing`` (capacity factor 8, every
expert selected), because one bf16 ulp between XLA's fused passes and
torch's per-op rounding flips near-tied experts otherwise (ROADMAP §3,
PR 22).  Each holds the digests of the initial leaves, each step's
metrics (``loss``, ``ce``, ``aux``, ``mtp``, ``grad_norm``), and each
updated leaf's float64 sum and sum of absolute values after the third
step.  ``chip_smoke.py``'s ``lm_train`` phase holds the card to it
without importing JAX; there the MoE's gather backward adds with atomics,
so its gradients do not repeat bit for bit and the card is held to the
bounds, not to bits.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_lm_train_moe_values.py

rewrites the section (~100 s on the CPU).  The tests below recompute it
with JAX, and hold the port's CPU run to it at :data:`TOL`.
"""
import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

import lm_parity
import test_torch_lm_train_values as base
from repro import configs as jconfigs
from repro import optim as joptim
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.models import init_params as jinit_params
from repro_torch import configs
from repro_torch.core import prng
from repro_torch.models import init_params
from repro_torch.models.layers import tree_items
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SECTION = "lm_train_moe"
ARCH = "deepseek_v3_671b"
# The metrics' relative bound and a leaf's sum gap over its sum of
# absolute values: lm_train's, but 5e-5 for the float32 variant's metrics
# where lm_train holds 1e-5.  This config keeps its weights in bf16 (bf16
# master) and sums its micro-batches' gradients in bf16, so a float32
# difference of an ulp that flips one bf16 rounding moves the later
# steps' metrics in the sixth digit: the port on the CPU is seen 8.3e-6
# from XLA (grad_norm, third step), the card 1.3e-5; leaf sums 2.3e-6 on
# both.  bfloat16 (neutral routing): 1.5e-3 and 1.2e-4 seen on the CPU.
TOL = {"float32": {"metrics": 5e-5, "leaf_sum": 1e-4},
       "bfloat16": base.TOL["bfloat16"]}


def _overrides(dtype: str) -> dict:
    over = {"compute_dtype": dtype, "micro_batches": base.MICRO}
    if dtype == "bfloat16":
        over.update(lm_parity.neutral_routing(ARCH))
    return over


def section() -> dict:
    """The section as the JAX package computes it now."""
    out = {"arch": ARCH, "steps": base.STEPS, "micro_batches": base.MICRO,
           "global_batch": base.BATCH, "seq_len": base.SEQ,
           "data_seed": base.SEED, "opt": base.OPT,
           "threefry_partitionable":
           bool(jax.config.jax_threefry_partitionable), "variants": {}}
    paths = [p for p, _ in tree_items(
        init_params(configs.get_smoke(ARCH), prng.PRNGKey(0, device="cpu")))]
    for dtype in ("float32", "bfloat16"):
        jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH),
                                   **_overrides(dtype))
        jocfg = joptim.OptConfig.from_model(jcfg, **base.OPT)
        params = jinit_params(jcfg, jax.random.PRNGKey(0))
        init_digests = base.digests(paths, jax.tree.map(
            lambda x: np.asarray(x).view(np.uint16)
            if x.dtype == jnp.bfloat16 else np.asarray(x),
            jax.tree.leaves(params)))
        metrics = []
        with jax.set_mesh(jmesh.make_smoke_mesh()):
            fn, _ = jsteps.build_train_step(jcfg, jmesh.make_smoke_mesh(),
                                            opt_cfg=jocfg)
            state = joptim.init(params, jocfg)
            for b in base._batches(jcfg):
                params, state, m = fn(params, state,
                                      jax.tree.map(jnp.asarray, b))
                metrics.append({k: float(v) for k, v in sorted(m.items())})
        out["variants"][dtype] = {
            "overrides": _overrides(dtype), "digests": init_digests,
            "metrics": metrics,
            "leaf_sums": base._sums(paths, [jnp.asarray(x, jnp.float32)
                                            for x in jax.tree.leaves(params)])}
    return out


def _load() -> dict:
    return json.loads(base.PATH.read_text())[SECTION]


def check(ref: dict, dtype: str, first, metrics, last) -> dict:
    """Hold one variant's run to the stored values at :data:`TOL`: the
    initial leaves' digests equal, each metric's relative gap and each
    leaf's sum gap; returns the largest gaps, by metric."""
    want = ref["variants"][dtype]
    got = base.digests([p for p, _ in first],
                       [t.detach().cpu().view(torch.int16).numpy()
                        if t.dtype == torch.bfloat16
                        else t.detach().cpu().numpy() for _, t in first])
    assert got == want["digests"], (dtype, "init differs")
    gaps = {}
    for g, w in zip(metrics, want["metrics"]):
        assert sorted(g) == sorted(w)
        for k in w:
            gap = abs(g[k] - w[k]) / abs(w[k]) if w[k] else abs(g[k])
            gaps[k] = max(gaps.get(k, 0.0), gap)
    sums = base._sums([p for p, _ in last],
                      [t.detach().float().cpu().numpy() for _, t in last])
    s_gap = max(abs(sums[p][0] - s) / l1
                for p, (s, l1) in want["leaf_sums"].items())
    assert max(gaps.values()) <= TOL[dtype]["metrics"], (dtype, gaps)
    assert s_gap <= TOL[dtype]["leaf_sum"], (dtype, s_gap)
    return {"metrics_gap": gaps, "leaf_sum_gap": s_gap}


def _gaps() -> dict:
    """The port's CPU run held to the stored section: each variant's
    largest gaps."""
    ref = _load()
    assert ref["threefry_partitionable"]
    assert set(ref["variants"]) == {"float32", "bfloat16"}
    gaps = {}
    for dtype, want in ref["variants"].items():
        cfg = dataclasses.replace(configs.get_smoke(ARCH),
                                  **want["overrides"])
        assert cfg.use_mla and cfg.use_mtp and cfg.n_moe_layers
        gaps[dtype] = check(ref, dtype, *base.port_run(cfg))
    return gaps


def test_section_matches_jax():
    """The stored runs are what the JAX package computes now."""
    assert _load() == json.loads(json.dumps(section()))


def test_section_matches_port():
    """The port's train step on the CPU holds to the stored values."""
    _gaps()


if __name__ == "__main__":
    values = json.loads(base.PATH.read_text())
    values[SECTION] = section()
    base.PATH.write_text(json.dumps(values, indent=1) + "\n")
    print(f"wrote {SECTION} to {base.PATH}", file=sys.stderr)
    print(_gaps(), file=sys.stderr)
