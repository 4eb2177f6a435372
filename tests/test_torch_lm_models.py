"""Port parity of the LM stack's modules against the JAX package on the
CPU: the model's chunked attention, the layers, the configs, the
parameter registry and init, and the weight conversion.

Tolerances, each with its reason:

* float32 attention: rtol = atol = 1e-5.  Both sides run the same
  chunked algorithm; torch and XLA sum the products and the softmax in
  other orders (measured gap 7.2e-7).
* bf16 attention: rtol = atol = 2^-8.  The inputs and p are bf16 on
  both sides, the scores and sums float32; the output is rounded to
  bf16, and a float32 difference at a rounding boundary flips one bf16
  ulp (measured gap 9.8e-4, one ulp at magnitude 0.25).
* float32 layers: rtol = atol = 1e-5 (``rsqrt``, ``sin``/``cos``, XLA's
  fused multiply-adds and libm's ``powf`` in ``rope_freqs`` differ from
  torch's by ulps).
* init: bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import config as jconfig
from repro.models import init_params as jinit_params
from repro.models import layers as jlayers
from repro_torch import configs
from repro_torch.core import prng
from repro_torch.models import (applicable_shapes, attention, convert,
                                init_params, layers, skip_reason,
                                transformer)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

RNG = np.random.default_rng(11)
DENSE = [a for a in configs.ARCH_IDS
         if configs.get(a).family in ("dense", "encoder")]


def _arr(shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# Attention.
# ---------------------------------------------------------------------------

def _attention_pair(s, h, hk, causal, window, dtype):
    q, k, v = _arr((2, s, h, 16)), _arr((2, s, hk, 16)), _arr((2, s, hk, 16))
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    want = jattn.flash_attention(*(jnp.asarray(a, jd) for a in (q, k, v)),
                                 causal=causal, window=window, chunk=32)
    got = attention.flash_attention(
        *(torch.from_numpy(a).to(td) for a in (q, k, v)), causal=causal,
        window=window, chunk=32)
    assert got.dtype == td and got.shape == (2, s, h, 16)
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("s", [32, 48, 64])
@pytest.mark.parametrize("h,hk", [(4, 4), (4, 2), (7, 1)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 16])
def test_chunked_attention_matches_jax_f32(s, h, hk, causal, window):
    """S = 32 and 64 take the chunked path (one and two blocks of 32),
    S = 48 the single-block fallback; window 16 at S = 64 the
    ``swa_fast`` path."""
    got, want = _attention_pair(s, h, hk, causal, window, "float32")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s", [48, 64])
@pytest.mark.parametrize("h,hk", [(4, 4), (4, 2), (7, 1)])
@pytest.mark.parametrize("window", [0, 16])
def test_chunked_attention_matches_jax_bf16(s, h, hk, window):
    got, want = _attention_pair(s, h, hk, True, window, "bfloat16")
    np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=2 ** -8)


def test_decode_attention_matches_jax():
    """One query against a half-filled cache, in float32."""
    B, S, H, Hk, D = 2, 16, 4, 2, 16
    q = _arr((B, 1, H, D))
    k, v = _arr((B, S, Hk, D)), _arr((B, S, Hk, D))
    positions = np.where(np.arange(S) < 9, np.arange(S), -1).astype(np.int32)
    positions = np.broadcast_to(positions, (B, S)).copy()
    pos = np.array([7, 8], np.int32)
    want = jattn.decode_attention(
        jnp.asarray(q), jattn.KVCache(jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(positions)),
        jnp.asarray(pos))
    got = attention.decode_attention(
        torch.from_numpy(q), attention.KVCache(
            torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(positions)), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("window", [0, 4])
def test_update_cache_equals_one_hot_select(window):
    B, S, Hk, D = 2, 6, 2, 4
    k = _arr((B, S, Hk, D))
    positions = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    new = _arr((B, 1, Hk, D))
    pos = np.array([9, 9], np.int32)
    want = jattn.update_cache(
        jattn.KVCache(jnp.asarray(k), jnp.asarray(k), jnp.asarray(positions)),
        jnp.asarray(new), jnp.asarray(new), jnp.asarray(pos), window=window)
    got = attention.update_cache(
        attention.KVCache(torch.from_numpy(k.copy()), torch.from_numpy(k.copy()),
                          torch.from_numpy(positions.copy())),
        torch.from_numpy(new), torch.from_numpy(new), torch.from_numpy(pos),
        window=window)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("window", [0, 16])
def test_attention_apply_prefill_and_decode_match_jax(window):
    """The attention block with its cache, in float32: a prefill of 40
    tokens into a cache of 48 slots (or a rolling window of 16, which the
    fill aligns so decode overwrites the oldest slot), then one decode
    step at position 40."""
    jcfg = dataclasses.replace(jconfigs.get_smoke("qwen3_4b"),
                               attn_window=window, param_dtype="float32",
                               compute_dtype="float32")
    cfg = dataclasses.replace(configs.get_smoke("qwen3_4b"),
                              attn_window=window, param_dtype="float32",
                              compute_dtype="float32")
    defs = jattn.attn_defs(jcfg)
    params = {n: _arr(d.shape, 0.2) if d.init == "normal"
              else np.ones(d.shape, np.float32) for n, d in defs.items()}
    B, S = 2, 40
    x, x1 = _arr((B, S, cfg.d_model)), _arr((B, 1, cfg.d_model))
    positions = np.broadcast_to(np.arange(S), (B, S)).copy()
    pos = np.full((B,), S, np.int32)
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    jc = jattn.init_cache(jcfg, B, 48, jnp.float32)
    jout, jc = jattn.attention_apply(jp, jnp.asarray(x), jcfg,
                                     positions=jnp.asarray(positions),
                                     cache=jc)
    jdec, jc = jattn.attention_apply(jp, jnp.asarray(x1), jcfg,
                                     positions=jnp.asarray(pos)[:, None],
                                     cache=jc, decode_pos=jnp.asarray(pos))
    tp = {n: torch.from_numpy(a) for n, a in params.items()}
    tc = attention.init_cache(cfg, B, 48, torch.float32, device="cpu")
    tout, tc = attention.attention_apply(tp, torch.from_numpy(x), cfg,
                                         positions=torch.from_numpy(positions),
                                         cache=tc)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    tdec, tc = attention.attention_apply(
        tp, torch.from_numpy(x1), cfg,
        positions=torch.from_numpy(pos)[:, None], cache=tc,
        decode_pos=torch.from_numpy(pos))
    np.testing.assert_allclose(tdec.numpy(), np.asarray(jdec), rtol=1e-5,
                               atol=1e-5)
    assert np.array_equal(tc.positions.numpy(), np.asarray(jc.positions))
    for g, w in ((tc.k, jc.k), (tc.v, jc.v)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# Layers.
# ---------------------------------------------------------------------------

def test_rms_norm_matches_jax():
    x, w = _arr((3, 5, 64)), _arr((64,))
    got = layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w))
    want = jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches_jax(theta):
    x = _arr((2, 40, 4, 16))
    positions = np.broadcast_to(np.arange(40), (2, 40)).copy()
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(positions),
                            theta)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(positions), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(layers.rope_freqs(16, theta).numpy(),
                               np.asarray(jlayers.rope_freqs(16, theta)),
                               rtol=1e-6)


@pytest.mark.parametrize("act", ["swiglu", "relu2"])
def test_mlp_apply_matches_jax(act):
    defs = jlayers.mlp_defs(32, 48, act)
    params = {n: _arr(d.shape, 0.2) for n, d in defs.items()}
    x = _arr((2, 7, 32))
    got = layers.mlp_apply({n: torch.from_numpy(a) for n, a in params.items()},
                           torch.from_numpy(x), act)
    want = jlayers.mlp_apply({n: jnp.asarray(a) for n, a in params.items()},
                             jnp.asarray(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# Configs and the parameter registry.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_configs_equal_reference(arch):
    for get in ("get", "get_smoke"):
        got = getattr(configs, get)(arch)
        want = getattr(jconfigs, get)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert ([s.name for s in applicable_shapes(got)]
                == [s.name for s in jconfig.applicable_shapes(want)])
        for shape in applicable_shapes(got):
            assert skip_reason(got, shape) == jconfig.skip_reason(
                want, jconfig.SHAPES_BY_NAME[shape.name])


@pytest.mark.parametrize("arch", DENSE)
def test_param_count_matches_reference(arch):
    """Arithmetic over the registry only; no weights are made."""
    assert configs.get(arch).param_count() == jconfigs.get(arch).param_count()
    assert (configs.get(arch).active_param_count()
            == jconfigs.get(arch).active_param_count())


@pytest.mark.parametrize("arch", ["qwen3_4b", "codeqwen15_7b", "yi_34b"])
def test_init_params_bit_for_bit(arch):
    """Every leaf, in ``jax.tree.flatten``'s order, equal in bits (bf16
    parameters, and float32 through a config override)."""
    for dtype in ("bfloat16", "float32"):
        jcfg = dataclasses.replace(jconfigs.get_smoke(arch),
                                   param_dtype=dtype)
        cfg = dataclasses.replace(configs.get_smoke(arch), param_dtype=dtype)
        want = jax.tree.leaves(jinit_params(jcfg, jax.random.PRNGKey(0)))
        got = layers.tree_items(init_params(cfg, prng.PRNGKey(0,
                                                              device="cpu")))
        assert len(got) == len(want)
        for (path, g), w in zip(got, want):
            w = np.asarray(w)
            g = convert.to_numpy({"leaf": g})["leaf"]
            assert g.dtype == w.dtype and g.shape == w.shape, path
            assert g.tobytes() == w.tobytes(), path


def test_init_slices_equal_one_draw():
    """A leaf drawn in slices equals the same leaf drawn at once."""
    d = layers.ParamDef((3, 40, 24), (None, None, None))
    key = prng.PRNGKey(5, device="cpu")
    whole = layers.init_param(key, d)
    saved = layers.INIT_SLICE
    try:
        layers.INIT_SLICE = 1000
        sliced = layers.init_param(key, d)
    finally:
        layers.INIT_SLICE = saved
    assert torch.equal(whole.view(torch.int16), sliced.view(torch.int16))


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "hymba_1_5b",
                                  "internvl2_76b", "hubert_xlarge"])
def test_later_families_raise(arch):
    """The SSM, hybrid, vision and audio configs run: no
    ``NotImplementedError``, finite float32 logits of the batch's
    shape."""
    cfg = configs.get_smoke(arch)
    params = init_params(cfg, prng.PRNGKey(0, device="cpu"))
    batch = ({"features": torch.ones(1, 4, cfg.d_model)}
             if cfg.frontend == "audio"
             else {"tokens": torch.zeros(1, 4, dtype=torch.int64)})
    logits, _, _, _ = transformer.forward(params, cfg, batch)
    assert logits.shape == (1, 4, cfg.vocab_size)
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()


# ---------------------------------------------------------------------------
# Weight conversion.
# ---------------------------------------------------------------------------

def test_convert_round_trips_the_bits():
    tree = {"a": RNG.standard_normal((3, 5)).astype(ml_dtypes.bfloat16),
            "b": {"c": _arr((4,)), "d": np.arange(6, dtype=np.int32)}}
    got = convert.from_jax_params(tree, device="cpu")
    assert got["a"].dtype == torch.bfloat16
    assert got["b"]["c"].dtype == torch.float32
    back = convert.to_numpy(got)
    for path in (("a",), ("b", "c"), ("b", "d")):
        x, y = tree, back
        for p in path:
            x, y = x[p], y[p]
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    # bf16 bits as torch reads them: the same float values.
    np.testing.assert_array_equal(got["a"].float().numpy(),
                                  tree["a"].astype(np.float32))
