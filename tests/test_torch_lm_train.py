"""The port's training path against the JAX package's on the CPU, at the
qwen3 smoke config: ``loss_fn`` and its gradients against
``jax.value_and_grad(loss_fn)``, the rematerialised forward against the
plain one, and two micro-batched steps of ``build_train_step`` against
the reference's under its smoke mesh, on the same parameters
(``init_params(PRNGKey(0))``, carried over bit for bit) and the same
numpy batches (``data.batch_for_model``, bit for bit in both packages).

Variants: "float32" computes in float32 on the config's bf16 weights
(their gradients, and the updated weights, are bf16); "bfloat16" is the
config as published, bf16 throughout.  Tolerances:

* float32: the loss to 1e-5 (5e-7 seen); each bf16 gradient element
  within one bf16 ulp of the larger of the two values plus 1e-3 of its
  leaf's largest element: the float32 sums differ in their last bits
  (XLA fuses and orders them its own way), a few land across a bf16
  rounding boundary, and elements that nearly cancel differ by more ulps
  of themselves (70 of 106,880 elements differ, the largest 5.7e-4 of
  its leaf's scale); fewer than 1 % may differ.  After two steps the
  metrics to 1e-5 relative and each weight within one bf16 ulp (4
  elements seen).
* bfloat16: XLA and torch round the activations to bf16 at their own
  places and every gradient element moves, so the loss to 2e-3 (8.9e-4
  seen) and each gradient leaf within 4e-2 of its largest element (1.9e-2
  seen, at the norms' weights, which sum over every position); after two
  steps of lr 1e-3 the metrics to 1e-3 relative, and the weights within
  two bf16 ulps plus two steps' worth of AdamW's normalised update,
  ``2 * lr`` per step, where a tiny gradient element's sign differs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import optim as joptim
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.models import init_params as jinit_params
from repro.models import loss_fn as jloss_fn
from repro_torch import configs, optim
from repro_torch.data import DataConfig, batch_for_model
from repro_torch.launch import steps
from repro_torch.models import convert, loss_fn, transformer
from repro_torch.models.layers import tree_items
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCH = "qwen3_4b"
LR = 1e-3


def variant(dtype: str, **over):
    """The smoke config in both packages, computing in ``dtype``."""
    return tuple(dataclasses.replace(pkg.get_smoke(ARCH),
                                     compute_dtype=dtype, **over)
                 for pkg in (jconfigs, configs))


def _batch(cfg, step: int, batch: int = 2, seq: int = 32) -> dict:
    dcfg = DataConfig(seed=0, seq_len=seq, global_batch=batch,
                      vocab_size=cfg.vocab_size)
    return batch_for_model(cfg, dcfg, step)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each |x| (the spacing of bf16 numbers there)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _port_loss_grads(cfg, params, batch):
    leaves = [t.requires_grad_(True) for _, t in tree_items(params)]
    loss, metrics = loss_fn(params, cfg, {k: torch.from_numpy(v)
                                          for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    return loss.detach(), metrics, grads


@pytest.fixture(scope="module")
def start():
    """Both packages' parameters for each variant, from one init."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        jcfg, cfg = variant(dtype)
        jp = jinit_params(jcfg, jax.random.PRNGKey(0))
        out[dtype] = (jcfg, cfg, jp, jax.tree.map(np.asarray, jp))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_jax(start, dtype):
    jcfg, cfg, jp, host = start[dtype]
    batch = _batch(cfg, 0)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jloss_fn(p, jcfg, b), has_aux=True))(
            jp, jax.tree.map(jnp.asarray, batch))
    params = convert.from_jax_params(host, device="cpu")
    loss, metrics, grads = _port_loss_grads(cfg, params, batch)
    assert sorted(metrics) == sorted(jm) == ["aux", "ce", "loss"]
    tol = 1e-5 if dtype == "float32" else 2e-3
    assert abs(float(loss) - float(jl)) <= tol
    assert abs(float(metrics["ce"].detach()) - float(jm["ce"])) <= tol
    differing = total = 0
    for (path, p), a, g in zip(tree_items(params), jax.tree.leaves(jg),
                               grads):
        assert g.dtype == p.dtype == torch.bfloat16, path
        want, got = _f32(a), _f32(g)
        scale = np.abs(want).max()
        if dtype == "float32":
            lim = (_bf16_ulp(np.maximum(np.abs(want), np.abs(got)))
                   + 1e-3 * scale)
        else:
            lim = 4e-2 * scale
        assert (np.abs(got - want) <= lim).all(), path
        differing += int((got != want).sum())
        total += want.size
    if dtype == "float32":
        assert differing < total / 100, (differing, total)


def test_remat_gives_the_plain_forward_bits(start):
    """Rematerialised blocks (``cfg.remat``, torch.utils.checkpoint)
    recompute the same forward, so the loss and every gradient equal the
    un-rematted run's bit for bit."""
    _, cfg, _, host = start["float32"]
    batch = _batch(cfg, 1)
    assert cfg.remat
    runs = []
    for remat in (True, False):
        params = convert.from_jax_params(host, device="cpu")
        c = dataclasses.replace(cfg, remat=remat)
        runs.append(_port_loss_grads(c, params, batch))
    (l1, _, g1), (l2, _, g2) = runs
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def test_inference_forward_is_not_rematted(start, monkeypatch):
    """Under ``inference_mode`` (serving) the blocks run once, without
    ``torch.utils.checkpoint``."""
    _, cfg, _, host = start["bfloat16"]
    params = convert.from_jax_params(host, device="cpu")
    calls = []
    real = transformer.checkpoint
    monkeypatch.setattr(transformer, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    toks = torch.from_numpy(_batch(cfg, 0)["tokens"])
    with torch.inference_mode():
        transformer.forward(params, cfg, {"tokens": toks})
    assert not calls
    transformer.forward(params, cfg, {"tokens": toks})
    assert len(calls) == cfg.n_layers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_matches_jax(start, dtype):
    """Two steps of 2 micro-batches (global batch 4) from the same
    parameters and state: the metrics, the new weights and the step
    count."""
    jcfg, cfg, _, host = start[dtype]
    jcfg = dataclasses.replace(jcfg, micro_batches=2)
    cfg = dataclasses.replace(cfg, micro_batches=2)
    kw = dict(lr=LR, warmup_steps=1, total_steps=10)
    jocfg = joptim.OptConfig.from_model(jcfg, **kw)
    ocfg = optim.OptConfig.from_model(cfg, **kw)
    batches = [_batch(cfg, i, batch=4) for i in range(2)]
    mesh = jmesh.make_smoke_mesh()
    with jax.set_mesh(mesh):
        jfn, _ = jsteps.build_train_step(jcfg, mesh, opt_cfg=jocfg)
        jp = jax.tree.map(jnp.asarray, host)
        js = joptim.init(jp, jocfg)
        jms = []
        for b in batches:
            jp, js, jm = jfn(jp, js, jax.tree.map(jnp.asarray, b))
            jms.append({k: float(v) for k, v in jm.items()})
    fn, info = steps.build_train_step(cfg, opt_cfg=ocfg, device="cpu")
    assert info["opt_cfg"] == ocfg
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
        want, got = _f32(a), _f32(t)
        lim = ulps * _bf16_ulp(np.maximum(np.abs(want), np.abs(got))) + slack
        assert (np.abs(got - want) <= lim).all(), path
