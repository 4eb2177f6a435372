"""The ``lm_train_ssm`` section of ``src/repro_torch/reference_values.json``:
three steps of the JAX package's ``build_train_step`` (under its smoke
mesh) on the Falcon-Mamba-7B smoke config (the SSM family: two Mamba-1
blocks of d_inner 128 and 8 states).  The batches, micro-batches and
optimizer settings are ``lm_train``'s
(``tests/test_torch_lm_train_values.py``): 2 micro-batches of a global
batch of 4 x 32 tokens from ``data.batch_for_model`` (seed 0, steps 0-2),
``OptConfig.from_model(cfg, lr=1e-3, warmup_steps=1, total_steps=10)``,
from ``init_params(PRNGKey(0))`` on JAX's default threefry stream; the
variants "float32" (float32 compute on the config's bf16 weights) and
"bfloat16" (the config as published).  Each holds the digests of the
initial leaves, each step's metrics and each updated leaf's float64 sum
and sum of absolute values after the third step.  ``chip_smoke.py``'s
``lm_train`` phase holds the card (the scan kernel and its backward) to
it at :data:`TOL` without importing JAX;
``tests/test_torch_lm_train_hybrid_values.py`` does the same for the
hybrid family's ``lm_train_hybrid``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_lm_train_ssm_values.py

rewrites the section (~30 s on the CPU).  The tests below recompute it
with JAX, and hold the port's CPU run to it at :data:`TOL`.
"""
import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np

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

SECTION = "lm_train_ssm"
ARCH = "falcon_mamba_7b"
# lm_train's bounds, but a bf16 leaf's sum to 5e-3 of its sum of absolute
# values where lm_train holds 2e-3: both configs zero-initialise the conv
# bias (256 elements in the smoke configs), whose AdamW steps are about lr
# each, so after three steps its sum of absolute values is ~0.5 and one
# element whose tiny gradient takes the other sign in bf16 moves the sum
# by 2 lr = 2e-3, 4e-3 of it.  The elementwise bound of that move is
# tests/test_torch_lm_train_ssm.py's train-step test.  Seen on the CPU:
# the hybrid's conv bias 2.5e-3 (one such element), every other leaf of
# both configs below 1e-4.
TOL = {"float32": base.TOL["float32"],
       "bfloat16": {"metrics": base.TOL["bfloat16"]["metrics"],
                    "leaf_sum": 5e-3}}


def section(arch: str = ARCH) -> dict:
    """The section of ``arch``'s smoke config as the JAX package computes
    it now."""
    out = {"arch": arch, "steps": base.STEPS, "micro_batches": base.MICRO,
           "global_batch": base.BATCH, "seq_len": base.SEQ,
           "data_seed": base.SEED, "opt": base.OPT,
           "threefry_partitionable":
           bool(jax.config.jax_threefry_partitionable), "variants": {}}
    paths = [p for p, _ in tree_items(
        init_params(configs.get_smoke(arch), prng.PRNGKey(0, device="cpu")))]
    for dtype in ("float32", "bfloat16"):
        over = base._overrides(dtype)
        jcfg = dataclasses.replace(jconfigs.get_smoke(arch), **over)
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
            "overrides": over, "digests": init_digests, "metrics": metrics,
            "leaf_sums": base._sums(paths, [jnp.asarray(x, jnp.float32)
                                            for x in jax.tree.leaves(params)])}
    return out


def load(name: str = SECTION) -> dict:
    return json.loads(base.PATH.read_text())[name]


def port_gaps(name: str = SECTION) -> dict:
    """The port's CPU run held to the stored section at :data:`TOL`: each
    variant's largest gaps."""
    ref = load(name)
    assert ref["threefry_partitionable"]
    assert set(ref["variants"]) == {"float32", "bfloat16"}
    gaps = {}
    for dtype, want in ref["variants"].items():
        cfg = dataclasses.replace(configs.get_smoke(ref["arch"]),
                                  **want["overrides"])
        gaps[dtype] = base.check(ref, dtype, *base.port_run(cfg), tols=TOL)
    return gaps


def write(name: str, arch: str) -> None:
    values = json.loads(base.PATH.read_text())
    values[name] = section(arch)
    base.PATH.write_text(json.dumps(values, indent=1) + "\n")
    print(f"wrote {name} to {base.PATH}", file=sys.stderr)
    print(port_gaps(name), file=sys.stderr)


def test_section_matches_jax():
    """The stored runs are what the JAX package computes now."""
    assert load() == json.loads(json.dumps(section()))


def test_section_matches_port():
    """The port's train step on the CPU holds to the stored values."""
    assert configs.get_smoke(load()["arch"]).family == "ssm"
    port_gaps()


if __name__ == "__main__":
    write(SECTION, ARCH)
