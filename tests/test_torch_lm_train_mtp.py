"""``loss_fn`` of the MoE families against the JAX package's on the CPU:
the DeepSeek-V3 smoke config (multi-head latent attention, a leading
dense layer, MoE layers whose routers add the auxiliary loss, and the
multi-token-prediction head with its weighted loss), in float32, on the
same parameters
(``init_params(PRNGKey(0))``, bit for bit) and numpy batches.

Tolerances: every metric (``ce``, ``aux``, ``mtp``, ``loss``) to 1e-5
(5e-7 seen).  Each gradient leaf within 3e-3 of its largest element: the
float32 sums run in other orders and the MoE's dispatch and combine are
scatter-adds whose order differs, and the gradients of the layers at and
below the experts differ by up to 1.1e-3 of their scale (seen at
``layers.attn.wo``; 1e-4 to 7e-4 in the others).  Every
parameter, the ``mtp`` subtree's included, gets a gradient.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import init_params as jinit_params
from repro.models import loss_fn as jloss_fn
from repro_torch import configs
from repro_torch.data import DataConfig, batch_for_model
from repro_torch.models import convert, loss_fn
from repro_torch.models.layers import tree_items
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("arch", ["deepseek_v3_671b"])
def test_moe_loss_and_grads_match_jax(arch):
    over = dict(param_dtype="float32", compute_dtype="float32")
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), **over)
    cfg = dataclasses.replace(configs.get_smoke(arch), **over)
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    batch = batch_for_model(cfg, DataConfig(seed=0, seq_len=32,
                                            global_batch=2,
                                            vocab_size=cfg.vocab_size), 0)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jloss_fn(p, jcfg, b), has_aux=True))(
            jp, jax.tree.map(jnp.asarray, batch))
    params = convert.from_jax_params(jax.tree.map(np.asarray, jp),
                                     device="cpu")
    leaves = [t.requires_grad_(True) for _, t in tree_items(params)]
    loss, metrics = loss_fn(params, cfg, {k: torch.from_numpy(v)
                                          for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    keys = ["aux", "ce", "loss"] + (["mtp"] if cfg.use_mtp else [])
    assert sorted(metrics) == sorted(jm) == keys
    assert float(metrics["aux"].detach()) > 0
    for k in keys:
        assert abs(float(metrics[k].detach()) - float(jm[k])) <= 1e-5, k
    assert any(p.startswith("mtp.") for p, _ in tree_items(params)) \
        == cfg.use_mtp
    for (path, _), a, g in zip(tree_items(params), jax.tree.leaves(jg),
                               grads):
        want = np.asarray(jnp.asarray(a, jnp.float32))
        got = g.float().numpy()
        scale = np.abs(want).max()
        assert scale > 0, path
        assert np.abs(got - want).max() <= 3e-3 * scale, path
