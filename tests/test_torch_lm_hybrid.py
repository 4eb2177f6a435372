"""Port parity of the hybrid family's pieces (the hymba smoke config:
sliding-window GQA attention beside a Mamba block in every layer) against
the JAX package on the CPU, on the same numpy inputs: the windowed
chunked attention and the kernel's plain oracle at S > window, the
rolling KV cache through prefill and decode, the hybrid block, and the
hybrid caches through ``convert``.

Tolerances, each with its reason:

* float32 attention: rtol = atol = 1e-5 (both sides run the chunked
  algorithm; sums in another order).
* float32 attention block and hybrid block: rtol = atol = 1e-4 (XLA's
  fused multiply-adds in rope and the conv, the scan's order).
* caches: positions equal; values to the same bounds; ``convert`` bit for
  bit.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_parity import cache_leaves
from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import transformer as jtransformer
from repro_torch import configs
from repro_torch.kernels import ref
from repro_torch.models import attention, convert, init_caches, transformer
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

RNG = np.random.default_rng(31)
ARCH = "hymba_1_5b"


def _arr(shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def _cfgs(**over):
    return tuple(dataclasses.replace(pkg.get_smoke(ARCH),
                                     param_dtype="float32",
                                     compute_dtype="float32", **over)
                 for pkg in (configs, jconfigs))


@pytest.mark.parametrize("window", [1, 7, 16, 24, 64])
@pytest.mark.parametrize("causal", [True, False])
def test_windowed_attention_matches_jax(window, causal):
    """S = 64 in chunks of 16, 5 query heads on 1 KV head: windows up to
    the chunk take the reference's ``swa_fast`` path (the diagonal and
    previous block), 24 and 64 scan every block under the mask; the port's
    chunked algorithm follows it step for step.  The kernel's plain oracle
    (``kernels.ref.flash_attention``, (B, H, S, D)) computes the mask
    itself and equals the reference in one block of 64.  Without causal
    masking ``swa_fast`` also drops every key past the query's own block,
    which the mask keeps (the window limits only the past): there, and
    only there, the reference's chunks differ from its mask (ROADMAP §3);
    no model runs it (the hybrid family is causal)."""
    q, k, v = _arr((2, 64, 5, 8)), _arr((2, 64, 1, 8)), _arr((2, 64, 1, 8))
    want = {c: np.asarray(jax.jit(functools.partial(
        jattn.flash_attention, causal=causal, window=window, chunk=c))(
            *(jnp.asarray(a) for a in (q, k, v)))) for c in (16, 64)}
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = attention.flash_attention(tq, tk, tv, causal=causal, window=window,
                                    chunk=16)
    np.testing.assert_allclose(got.numpy(), want[16], rtol=1e-5, atol=1e-5)
    plain = ref.flash_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                                tv.transpose(1, 2), causal=causal,
                                window=window).transpose(1, 2)
    np.testing.assert_allclose(plain.numpy(), want[64], rtol=1e-5, atol=1e-5)
    fast_drops_future = not causal and window <= 16
    assert np.allclose(want[16], want[64], rtol=1e-5, atol=1e-5) \
        != fast_drops_future


def _attn_params(cfg):
    return {n: _arr(d.shape, d.shape[0] ** -0.5)
            for n, d in attention.attn_defs(cfg).items()}


def test_rolling_cache_prefill_and_decode_match_jax():
    """A 40-token prefill into a window-16 rolling cache (``min(max_len,
    window)`` slots, the fill rolled so that slot = position % 16), then
    4 decode steps that overwrite the oldest slot: outputs and caches
    against the reference's."""
    cfg, jcfg = _cfgs()
    p = _attn_params(cfg)
    tp = {n: torch.from_numpy(a) for n, a in p.items()}
    jp = {n: jnp.asarray(a) for n, a in p.items()}
    B, S, L = 2, 40, 48
    x = _arr((B, S, cfg.d_model))
    pos = np.broadcast_to(np.arange(S), (B, S))
    cache = attention.init_cache(cfg, B, L, torch.float32, device="cpu")
    jcache = jattn.init_cache(jcfg, B, L, jnp.float32)
    assert cache.k.shape[1] == jcache.k.shape[1] == cfg.attn_window
    got, cache = attention.attention_apply(
        tp, torch.from_numpy(x), cfg, positions=torch.from_numpy(pos.copy()),
        cache=cache)
    apply = jax.jit(lambda p_, x_, pos_, c_, dp_: jattn.attention_apply(
        p_, x_, jcfg, positions=pos_, cache=c_, decode_pos=dp_))
    want, jcache = apply(jp, jnp.asarray(x), jnp.asarray(pos), jcache, None)
    outs = [(got, want)]
    for i in range(4):
        xs = _arr((B, 1, cfg.d_model))
        dpos = np.full((B,), S + i, np.int32)
        got, cache = attention.attention_apply(
            tp, torch.from_numpy(xs), cfg,
            positions=torch.from_numpy(dpos[:, None].copy()), cache=cache,
            decode_pos=torch.from_numpy(dpos))
        want, jcache = apply(jp, jnp.asarray(xs), jnp.asarray(dpos[:, None]),
                             jcache, jnp.asarray(dpos))
        outs.append((got, want))
    for g, w in outs:
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
    assert np.array_equal(cache.positions.numpy(),
                          np.asarray(jcache.positions))
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(jcache.v),
                               rtol=1e-5, atol=1e-5)


def _block_params(jcfg):
    """float32 numpy parameters of one hybrid block from the reference's
    registry: norms ones, ``a_log`` and ``dt_bias`` as the SSM inits make
    them, the rest normal at the init's fan-in scale, the gates unequal
    so that each path's gate counts."""
    from repro.models.layers import ParamDef

    def leaf(d):
        if d.init in ("ones", "zeros"):
            return np.full(d.shape, d.init == "ones", np.float32)
        if d.init == "ssm_a":
            return np.log(np.broadcast_to(np.arange(
                1, d.shape[-1] + 1, dtype=np.float32), d.shape)).astype(
                    np.float32)
        if d.init == "ssm_dt":
            return RNG.uniform(-4.0, -2.0, d.shape).astype(np.float32)
        fan_in = d.shape[-2] if len(d.shape) > 1 else d.shape[-1]
        return _arr(d.shape, fan_in ** -0.5)

    layer = jax.tree.map(leaf, jtransformer.block_defs(jcfg),
                         is_leaf=lambda x: isinstance(x, ParamDef))
    layer["gate_attn"] = np.full((1,), 0.75, np.float32)
    layer["gate_ssm"] = np.full((1,), 1.25, np.float32)
    return layer


def test_hybrid_block_matches_jax():
    """One hybrid block (``x += g_a attn(h) + g_s mamba(h)``, then the
    MLP) over a 40-token prefill with caches, then 3 decode steps."""
    cfg, jcfg = _cfgs()
    layer = _block_params(jcfg)
    tp = convert.from_jax_params(layer, device="cpu")
    jp = jax.tree.map(jnp.asarray, layer)
    B, S, L = 2, 40, 48
    x = _arr((B, S, cfg.d_model))
    pos = np.broadcast_to(np.arange(S), (B, S))
    caches = init_caches(cfg, B, L, torch.float32, device="cpu")["layers"]
    cache = transformer._cache_at(caches, 0)
    jcache = jax.tree.map(lambda a: a[0], jtransformer.init_caches(
        jcfg, B, L, jnp.float32)["layers"])
    got, cache, _ = transformer.block_apply(
        tp, torch.from_numpy(x), cfg, positions=torch.from_numpy(pos.copy()),
        cache=cache)
    apply = jax.jit(lambda p_, x_, pos_, c_, dp_: jtransformer.block_apply(
        p_, x_, jcfg, moe_layer=False, positions=pos_, cache=c_,
        decode_pos=dp_))
    want, jcache, _ = apply(jp, jnp.asarray(x), jnp.asarray(pos), jcache,
                            None)
    outs = [(got, want)]
    for i in range(3):
        xs = _arr((B, 1, cfg.d_model))
        dpos = np.full((B,), S + i, np.int32)
        got, cache, _ = transformer.block_apply(
            tp, torch.from_numpy(xs), cfg,
            positions=torch.from_numpy(dpos[:, None].copy()), cache=cache,
            decode_pos=torch.from_numpy(dpos))
        want, jcache, _ = apply(jp, jnp.asarray(xs),
                                jnp.asarray(dpos[:, None]), jcache,
                                jnp.asarray(dpos))
        outs.append((got, want))
    for g, w in outs:
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
    assert set(cache) == set(jcache) == {"attn", "ssm"}
    assert np.array_equal(cache["attn"].positions.numpy(),
                          np.asarray(jcache["attn"].positions))
    for field in ("conv", "state"):
        np.testing.assert_allclose(
            getattr(cache["ssm"], field).numpy(),
            np.asarray(getattr(jcache["ssm"], field)), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", [ARCH, "falcon_mamba_7b"])
def test_caches_through_convert(arch):
    """The reference's cache tree (the hybrid's dict of a rolling
    ``KVCache`` and an ``SSMCache``; the SSM family's ``SSMCache``),
    filled with numbers, carried across and back bit for bit; the port's
    ``init_caches`` has the reference's tree, shapes and dtypes."""
    jcfg = jconfigs.get_smoke(arch)
    cfg = configs.get_smoke(arch)
    tree = jax.tree.map(np.asarray, jtransformer.init_caches(jcfg, 2, 40))
    tree = jax.tree.map(lambda a: (RNG.standard_normal(a.shape) * 8)
                        .astype(a.dtype), tree)
    back = convert.caches_to_numpy(convert.caches_from_jax(tree,
                                                           device="cpu"))
    for keys, a, b in cache_leaves(tree, back):
        assert b.dtype == a.dtype and b.tobytes() == a.tobytes(), keys
    mine = convert.caches_to_numpy(init_caches(cfg, 2, 40, device="cpu"))
    for keys, a, m in cache_leaves(tree, mine):
        assert m.dtype == a.dtype and m.shape == a.shape, keys
