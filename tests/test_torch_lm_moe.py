"""Port parity of the MoE family's modules against the JAX package on the
CPU: ``moe_apply`` (routing, capacity, the sort-based dispatch and the
gate-weighted combine), the parameter registry of the MoE configs and
their init.

Tolerances, each with its reason:

* float32 ``moe_apply``: rtol = atol = 1e-5, with the selected experts
  equal.  Both sides route in float32 and run the same products; torch
  and XLA sum them in other orders (measured gap 1.2e-6 at magnitude 3.8).
* the auxiliary loss: rtol = 1e-6.  The reference adds 1 / (T K) once
  per assignment in float32, the port multiplies the count by it (one
  rounding instead of up to T K; measured 9.0e-8 relative).
* bf16 ``moe_apply``: the selected experts equal (routing is float32 of
  the same bf16 inputs), each output within two bf16 ulps of itself
  (rtol 2^-6) plus one ulp of the largest output (2^-7 of max |out|, for
  outputs that are sums of cancelling terms).  XLA keeps excess precision
  in its fused bf16 elementwise passes (the SwiGLU), torch rounds after
  each operation (measured gap 0.031 at magnitude 3.5, two ulps there).
* registry, ``param_count`` and init: exact, bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import init_params as jinit_params
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro_torch import configs
from repro_torch.core import prng
from repro_torch.models import convert, init_params, layers, moe, transformer
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

RNG = np.random.default_rng(23)
ARCHS = ["moonshot_v1_16b_a3b", "deepseek_v3_671b"]
F32_TOL = 1e-5
AUX_RTOL = 1e-6


def _arr(shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def _params(cfg, dtype=np.float32):
    """Random MoE parameters at the init's scale (fan-in ** -0.5), the
    router float32 as its ParamDef; the router twice that, so that the
    routing probabilities spread."""
    out = {}
    for name, d in moe.moe_defs(cfg).items():
        a = _arr(d.shape, (2.0 if name == "router" else 1.0)
                 * d.shape[-2] ** -0.5)
        out[name] = a if d.dtype == "float32" else a.astype(dtype)
    return out


def _pair(cfg, jcfg, params, x):
    """(port out, port aux), (JAX out, JAX aux) as float32 numpy."""
    got, aux = moe.moe_apply(
        {n: torch.from_numpy(np.asarray(a, np.float32)).to(
            torch.float32 if a.dtype == np.float32 else torch.bfloat16)
         for n, a in params.items()},
        torch.from_numpy(x.astype(np.float32)).to(
            torch.float32 if x.dtype == np.float32 else torch.bfloat16), cfg)
    want, jaux = jmoe.moe_apply({n: jnp.asarray(a) for n, a in params.items()},
                                jnp.asarray(x), jcfg)
    return ((got.float().numpy(), aux.item()),
            (np.asarray(want.astype(jnp.float32)), float(jaux)))


def _configs(arch, **kw):
    return (dataclasses.replace(configs.get_smoke(arch), **kw),
            dataclasses.replace(jconfigs.get_smoke(arch), **kw))


def _expert_ids(p_router, x, k):
    """JAX's and the port's top-k expert ids for float32 tokens x."""
    logits = x.reshape(-1, x.shape[-1]).astype(np.float32) @ p_router
    _, jids = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), -1), k)
    _, ids = moe.top_k(torch.softmax(torch.from_numpy(logits), -1), k)
    return ids.numpy(), np.asarray(jids)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_jax_f32(arch):
    cfg, jcfg = _configs(arch)
    params = _params(cfg)
    x = _arr((2, 24, cfg.d_model))
    (got, aux), (want, jaux) = _pair(cfg, jcfg, params, x)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(aux, jaux, rtol=AUX_RTOL)
    ids, jids = _expert_ids(params["router"], x, cfg.top_k)
    assert np.array_equal(ids, jids)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_jax_bf16(arch):
    import ml_dtypes
    cfg, jcfg = _configs(arch)
    params = _params(cfg, ml_dtypes.bfloat16)
    x = _arr((2, 24, cfg.d_model)).astype(ml_dtypes.bfloat16)
    (got, aux), (want, jaux) = _pair(cfg, jcfg, params, x)
    np.testing.assert_allclose(got, want, rtol=2 ** -6,
                               atol=2 ** -7 * np.abs(want).max())
    np.testing.assert_allclose(aux, jaux, rtol=AUX_RTOL)
    ids, jids = _expert_ids(params["router"], x.astype(np.float32),
                            cfg.top_k)
    assert np.array_equal(ids, jids)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor", [0.25, 0.6])
def test_moe_apply_matches_jax_when_capacity_drops_tokens(arch,
                                                          capacity_factor):
    """Experts past their capacity drop assignments (their slot of the
    reference's scatter is (E - 1, C - 1), with a zero payload): the same
    tokens lose the same experts on both sides."""
    cfg, jcfg = _configs(arch, capacity_factor=capacity_factor)
    params = _params(cfg)
    x = _arr((2, 40, cfg.d_model))
    T = x.shape[0] * x.shape[1]
    ids, _ = _expert_ids(params["router"], x, cfg.top_k)
    counts = np.bincount(ids.reshape(-1), minlength=cfg.n_experts)
    assert counts.max() > moe._capacity(T, cfg)        # some are dropped
    (got, aux), (want, jaux) = _pair(cfg, jcfg, params, x)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(aux, jaux, rtol=AUX_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_router_ties_pick_the_lower_expert_as_jax(arch):
    """Router columns made equal in pairs give exactly tied
    probabilities: both sides take the lower expert id of a tie first."""
    cfg, jcfg = _configs(arch)
    params = _params(cfg)
    router = params["router"]
    router[:, 1::2] = router[:, 0::2]                # experts 2i, 2i + 1 tie
    params["router"] = router
    x = _arr((2, 16, cfg.d_model))
    ids, jids = _expert_ids(router, x, cfg.top_k)
    assert np.array_equal(ids, jids)
    assert (ids[:, 0] % 2 == 0).all() and (ids[:, 1] == ids[:, 0] + 1).all()
    (got, aux), (want, jaux) = _pair(cfg, jcfg, params, x)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(aux, jaux, rtol=AUX_RTOL)


def test_top_k_orders_ties_by_index():
    probs = torch.tensor([[0.2, 0.3, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25]])
    vals, idx = moe.top_k(probs, 3)
    assert idx.tolist() == [[1, 2, 0], [0, 1, 2]]
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    assert idx.tolist() == np.asarray(jidx).tolist()
    assert np.array_equal(vals.numpy(), np.asarray(jvals))


@pytest.mark.parametrize("n_tokens", [1, 4, 7, 80, 2048, 8192])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor", [0.25, 1.25, 8.0])
def test_capacity_matches_reference(n_tokens, arch, capacity_factor):
    for get in ("get", "get_smoke"):
        cfg = dataclasses.replace(getattr(configs, get)(arch),
                                  capacity_factor=capacity_factor)
        jcfg = dataclasses.replace(getattr(jconfigs, get)(arch),
                                   capacity_factor=capacity_factor)
        c = moe._capacity(n_tokens, cfg)
        assert c == jmoe._capacity(n_tokens, jcfg)
        assert c >= 4 and c % 4 == 0


def test_moe_apply_over_data_shards_raises():
    cfg, _ = _configs("moonshot_v1_16b_a3b")
    params = {n: torch.from_numpy(a) for n, a in _params(cfg).items()}
    x = torch.from_numpy(_arr((2, 4, cfg.d_model)))
    with pytest.raises(NotImplementedError, match="slice"):
        moe.moe_apply(params, x, cfg, data_shards=2)


def test_moe_apply_is_repeatable_bit_for_bit():
    """The combine sums each token's contributions in a fixed order."""
    cfg, _ = _configs("deepseek_v3_671b")
    params = {n: torch.from_numpy(a) for n, a in _params(cfg).items()}
    x = torch.from_numpy(_arr((2, 40, cfg.d_model)))
    a, _ = moe.moe_apply(params, x, cfg)
    b, _ = moe.moe_apply(params, x, cfg)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Registry and init.
# ---------------------------------------------------------------------------

def _def_items(defs, is_leaf):
    """(path, shape, dtype, init, scale) of each leaf in flatten order."""
    flat, _ = jax.tree_util.tree_flatten_with_path(defs, is_leaf=is_leaf)
    return [(".".join(str(k.key) for k in path), tuple(d.shape), d.dtype,
             d.init, d.scale, d.fsdp_dim, tuple(d.tp)) for path, d in flat]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_defs_and_count_match_reference(arch):
    """The full published configs: every leaf's path, shape, dtype and
    init, and the parameter counts.  No weights are made."""
    from repro.models.layers import ParamDef as JParamDef
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    got = [(path, tuple(d.shape), d.dtype, d.init, d.scale, d.fsdp_dim,
            tuple(d.tp))
           for path, d in layers.tree_items(transformer.param_defs(cfg))]
    want = _def_items(jtransformer.param_defs(jcfg),
                      lambda x: isinstance(x, JParamDef))
    assert got == want
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert (dataclasses.replace(cfg, n_layers=4).param_count()
            == dataclasses.replace(jcfg, n_layers=4).param_count())


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_bit_for_bit(arch):
    """Every leaf of the smoke config, the float32 router and the
    ``mtp`` subtree included, equal in bits."""
    cfg = configs.get_smoke(arch)
    want = jax.tree.leaves(jinit_params(jconfigs.get_smoke(arch),
                                        jax.random.PRNGKey(0)))
    got = layers.tree_items(init_params(cfg, prng.PRNGKey(0, device="cpu")))
    assert len(got) == len(want)
    assert any(p.endswith("moe.router") for p, _ in got)
    assert any(p.startswith("mtp.") for p, _ in got) == cfg.use_mtp
    for (path, g), w in zip(got, want):
        w = np.asarray(w)
        g = convert.to_numpy({"leaf": g})["leaf"]
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert g.tobytes() == w.tobytes(), path
