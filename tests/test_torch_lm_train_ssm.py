"""The port's training path of the SSM family (Falcon-Mamba-7B) and the
hybrid family (Hymba-1.5B) against the JAX package's on the CPU, at their
smoke configs: ``loss_fn`` and its gradients against
``jax.value_and_grad(loss_fn)``, the rematerialised forward against the
plain one, and two micro-batched steps of ``build_train_step`` against
the reference's under its smoke mesh, on the same parameters
(``init_params(PRNGKey(0))``, carried over bit for bit) and numpy
batches.  On the CPU autograd differentiates the selective scan's plain
chunked version (``kernels/ssm_scan.py::ssm_scan_plain``) and, in the
hybrid, the chunked attention under its sliding window of 16 (the
reference's ``swa_fast`` path, exact under causal masking).

The bounds are ``tests/test_torch_lm_train.py``'s, which ROADMAP §3 (PR
25) fixes for every family: float32 (on the config's bf16 weights) the
loss to 1e-5 and each bf16 gradient element within one bf16 ulp plus
1e-3 of its leaf's largest element, with under 1 % of the elements
differing; bfloat16 the loss to 2e-3 and each gradient leaf within 4e-2
of its largest element; after two steps the same metric and weight bounds
as there.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_lm_train as dense
from repro import configs as jconfigs
from repro import optim as joptim
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.models import init_params as jinit_params
from repro.models import loss_fn as jloss_fn
from repro_torch import configs, optim
from repro_torch.launch import steps
from repro_torch.models import convert
from repro_torch.models.layers import tree_items
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCHS = ("falcon_mamba_7b", "hymba_1_5b")
LR = dense.LR


def variant(arch: str, dtype: str):
    return tuple(dataclasses.replace(pkg.get_smoke(arch), compute_dtype=dtype)
                 for pkg in (jconfigs, configs))


@pytest.fixture(scope="module")
def start():
    """Both packages' parameters for each (arch, variant), from one init."""
    out = {}
    for arch in ARCHS:
        for dtype in ("float32", "bfloat16"):
            jcfg, cfg = variant(arch, dtype)
            jp = jinit_params(jcfg, jax.random.PRNGKey(0))
            out[arch, dtype] = (jcfg, cfg, jp, jax.tree.map(np.asarray, jp))
    return out


def test_smoke_configs_run_the_scan_and_the_window():
    fam = {a: configs.get_smoke(a) for a in ARCHS}
    assert fam["falcon_mamba_7b"].family == "ssm"
    assert fam["hymba_1_5b"].family == "hybrid"
    assert fam["hymba_1_5b"].attn_window > 0 and fam["hymba_1_5b"].causal
    assert all(c.remat and c.ssm_state == 8 for c in fam.values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(start, arch, dtype):
    jcfg, cfg, jp, host = start[arch, dtype]
    batch = dense._batch(cfg, 0)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jloss_fn(p, jcfg, b), has_aux=True))(
            jp, jax.tree.map(jnp.asarray, batch))
    params = convert.from_jax_params(host, device="cpu")
    loss, metrics, grads = dense._port_loss_grads(cfg, params, batch)
    assert sorted(metrics) == sorted(jm) == ["aux", "ce", "loss"]
    tol = 1e-5 if dtype == "float32" else 2e-3
    assert abs(float(loss) - float(jl)) <= tol
    assert abs(float(metrics["ce"].detach()) - float(jm["ce"])) <= tol
    differing = total = 0
    for (path, p), a, g in zip(tree_items(params), jax.tree.leaves(jg),
                               grads):
        assert g.dtype == p.dtype, path
        want, got = dense._f32(a), dense._f32(g)
        scale = np.abs(want).max()
        assert scale > 0, path
        if dtype == "float32":
            lim = (dense._bf16_ulp(np.maximum(np.abs(want), np.abs(got)))
                   + 1e-3 * scale)
        else:
            lim = 4e-2 * scale
        assert (np.abs(got - want) <= lim).all(), path
        differing += int((got != want).sum())
        total += want.size
    if dtype == "float32":
        assert differing < total / 100, (differing, total)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_plain_forward_bits(start, arch):
    _, cfg, _, host = start[arch, "float32"]
    batch = dense._batch(cfg, 1)
    assert cfg.remat
    runs = []
    for remat in (True, False):
        params = convert.from_jax_params(host, device="cpu")
        c = dataclasses.replace(cfg, remat=remat)
        runs.append(dense._port_loss_grads(c, params, batch))
    (l1, _, g1), (l2, _, g2) = runs
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(start, arch, dtype):
    """Two steps of 2 micro-batches (global batch 4) from the same
    parameters and state: the metrics, the new weights and the step
    count, at ``tests/test_torch_lm_train.py``'s bounds."""
    jcfg, cfg, _, host = start[arch, dtype]
    jcfg = dataclasses.replace(jcfg, micro_batches=2)
    cfg = dataclasses.replace(cfg, micro_batches=2)
    kw = dict(lr=LR, warmup_steps=1, total_steps=10)
    jocfg = joptim.OptConfig.from_model(jcfg, **kw)
    ocfg = optim.OptConfig.from_model(cfg, **kw)
    batches = [dense._batch(cfg, i, batch=4) for i in range(2)]
    mesh = jmesh.make_smoke_mesh()
    with jax.set_mesh(mesh):
        jfn, _ = jsteps.build_train_step(jcfg, mesh, opt_cfg=jocfg)
        jp = jax.tree.map(jnp.asarray, host)
        js = joptim.init(jp, jocfg)
        jms = []
        for b in batches:
            jp, js, jm = jfn(jp, js, jax.tree.map(jnp.asarray, b))
            jms.append({k: float(v) for k, v in jm.items()})
    fn, _ = steps.build_train_step(cfg, opt_cfg=ocfg, device="cpu")
    params = convert.from_jax_params(host, device="cpu")
    state = optim.init(params, ocfg)
    for b, jm in zip(batches, jms):
        params, state, m = fn(params, state,
                              {k: torch.from_numpy(v) for k, v in b.items()})
        assert sorted(m) == sorted(jm)
        rtol = 1e-5 if dtype == "float32" else 1e-3
        for k in jm:
            assert float(m[k]) == pytest.approx(jm[k], rel=rtol, abs=1e-6)
    assert int(state["step"]) == 2
    slack = 0.0 if dtype == "float32" else 2 * 2 * LR
    ulps = 1 if dtype == "float32" else 2
    for (path, t), a in zip(tree_items(params), jax.tree.leaves(jp)):
        want, got = dense._f32(a), dense._f32(t)
        lim = (ulps * dense._bf16_ulp(np.maximum(np.abs(want), np.abs(got)))
               + slack)
        assert (np.abs(got - want) <= lim).all(), path
