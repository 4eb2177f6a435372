"""Port parity of multi-head latent attention (DeepSeek-V3's MLA) against
the JAX package on the CPU: the expanded prefill, the latent cache's
fill (prompts shorter and longer than the cache), the absorbed decode
step, and the attention it runs, with a value width and a scale of its
own.

Tolerances, each with its reason:

* float32: rtol = atol = 1e-5.  Both sides run the same products and the
  same chunked softmax; torch and XLA sum in other orders (measured gap
  7.2e-7 at magnitude 1).
* bf16: the caches' positions equal; the output within two bf16 ulps of
  itself (rtol 2^-6) plus one ulp of the largest output (2^-7 of max
  |out|).  XLA keeps excess precision in its fused bf16 elementwise
  passes (the norms, the rope), torch rounds after each operation, and a
  value at a rounding boundary lands one ulp apart (measured: the
  prefill equal, the decode step 0.0044 at magnitude 0.12, two ulps).
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
from repro.models import mla as jmla
from repro_torch import configs
from repro_torch.kernels import flash_attn
from repro_torch.models import attention, mla
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

RNG = np.random.default_rng(29)
F32_TOL = 1e-5
# One compile a shape instead of one a primitive.
JMLA_APPLY = jax.jit(jmla.mla_apply, static_argnames=("cfg",))
JFLASH = jax.jit(jattn.flash_attention,
                 static_argnames=("causal", "window", "chunk", "scale"))


def _arr(shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def _configs(dtype="float32"):
    return (dataclasses.replace(configs.get_smoke("deepseek_v3_671b"),
                                param_dtype=dtype, compute_dtype=dtype),
            dataclasses.replace(jconfigs.get_smoke("deepseek_v3_671b"),
                                param_dtype=dtype, compute_dtype=dtype))


def _params(cfg, np_dtype):
    """Random MLA weights at the init's scale; norms ones."""
    out = {}
    for name, d in mla.mla_defs(cfg).items():
        a = (np.ones(d.shape, np.float32) if d.init == "ones"
             else _arr(d.shape, d.shape[-2] ** -0.5))
        out[name] = a.astype(np_dtype)
    return out


def _t(a):
    """numpy (float32 or ml_dtypes bf16) -> torch of the same dtype."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


def _close(got, want, dtype):
    got, want = _np(got), _np(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -6,
                                   atol=2 ** -7 * np.abs(want).max())


def _run(dtype, S, Smax, decode):
    """Prefill S tokens (into a cache of Smax slots if given), then one
    absorbed decode step at position S if ``decode``, on both sides."""
    cfg, jcfg = _configs(dtype)
    np_dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    params = _params(cfg, np_dt)
    B = 2
    x = _arr((B, S, cfg.d_model)).astype(np_dt)
    x1 = _arr((B, 1, cfg.d_model)).astype(np_dt)
    positions = np.broadcast_to(np.arange(S), (B, S)).copy()
    pos = np.full((B,), S, np.int32)
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    tp = {n: _t(a) for n, a in params.items()}
    jc = tc = None
    if Smax:
        jc = jmla.init_mla_cache(jcfg, B, Smax, jdt)
        tc = mla.init_mla_cache(cfg, B, Smax, tdt, device="cpu")
    jout, jc = JMLA_APPLY(jp, jnp.asarray(x), cfg=jcfg,
                          positions=jnp.asarray(positions), cache=jc)
    tout, tc = mla.mla_apply(tp, _t(x), cfg,
                             positions=torch.from_numpy(positions), cache=tc)
    res = {"prefill": (tout, jout), "cache": (tc, jc)}
    if decode:
        jdec, jc = JMLA_APPLY(jp, jnp.asarray(x1), cfg=jcfg,
                              positions=jnp.asarray(pos)[:, None],
                              cache=jc, decode_pos=jnp.asarray(pos))
        tdec, tc = mla.mla_apply(tp, _t(x1), cfg,
                                 positions=torch.from_numpy(pos)[:, None],
                                 cache=tc, decode_pos=torch.from_numpy(pos))
        res.update(decode=(tdec, jdec), cache=(tc, jc))
    return res


def _caches_close(tc, jc, dtype):
    assert np.array_equal(tc.positions.numpy(), np.asarray(jc.positions))
    _close(tc.ckv, jc.ckv, dtype)
    _close(tc.kpe, jc.kpe, dtype)


@pytest.mark.parametrize("S", [48, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expanded_prefill_matches_jax(S, dtype):
    """S = 64 takes the chunked attention (two blocks of 32), S = 48 its
    single-block fallback."""
    res = _run(dtype, S, 0, decode=False)
    got, want = res["prefill"]
    assert got.shape == (2, S, 64) and res["cache"] == (None, None)
    _close(got, want, dtype)


@pytest.mark.parametrize("S,Smax", [(40, 48), (64, 48)])
def test_cache_fill_matches_jax(S, Smax):
    """A prompt shorter than the cache leaves slots with position -1 and
    zeros; a longer one keeps its last Smax tokens."""
    res = _run("float32", S, Smax, decode=False)
    _close(*res["prefill"], "float32")
    tc, jc = res["cache"]
    _caches_close(tc, jc, "float32")
    span = min(S, Smax)
    assert (tc.positions[:, span:] == -1).all()
    assert torch.equal(tc.positions[0, :span],
                       torch.arange(S - span, S, dtype=torch.int32))


@pytest.mark.parametrize("S,Smax", [(40, 48), (64, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_absorbed_decode_matches_jax(S, Smax, dtype):
    """One decode step at position S after the prefill: into a free slot,
    or into the last slot of a full cache (the reference's clamp)."""
    res = _run(dtype, S, Smax, decode=True)
    _close(*res["prefill"], dtype)
    got, want = res["decode"]
    assert got.shape == (2, 1, 64)
    _close(got, want, dtype)
    _caches_close(*res["cache"], dtype)


# ---------------------------------------------------------------------------
# The attention MLA runs: a value width and a scale of its own.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,dv", [(24, 16), (192, 128)])
@pytest.mark.parametrize("s", [48, 64])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("scale", [None, 0.3])
def test_attention_with_value_width_and_scale_matches_jax(d, dv, s, causal,
                                                          scale):
    """The model's attention and the kernel's plain version (its CPU path,
    on (B, H, S, D) transposes) against the JAX models' attention, in
    float32: q, k of width D, v of Dv, the scale given or D ** -0.5."""
    h, hk = 4, 2
    q, k, v = _arr((2, s, h, d)), _arr((2, s, hk, d)), _arr((2, s, hk, dv))
    want = np.asarray(JFLASH(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        chunk=32, scale=scale))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = attention.flash_attention(tq, tk, tv, causal=causal, chunk=32,
                                    scale=scale)
    assert got.shape == (2, s, h, dv)
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)
    before = flash_attn.LAUNCHES
    plain = flash_attn.flash_attention(tq.transpose(1, 2),
                                       tk.transpose(1, 2),
                                       tv.transpose(1, 2), causal=causal,
                                       scale=scale)
    assert flash_attn.LAUNCHES == before     # CPU: the plain version
    np.testing.assert_allclose(plain.transpose(1, 2).numpy(), want,
                               rtol=F32_TOL, atol=F32_TOL)


def test_attention_with_value_width_bf16_matches_jax():
    q, k = _arr((2, 64, 4, 24)), _arr((2, 64, 4, 24))
    v = _arr((2, 64, 4, 16))
    want = jattn.flash_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal=True,
        chunk=32, scale=24 ** -0.5)
    got = attention.flash_attention(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        causal=True, chunk=32, scale=24 ** -0.5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -8, atol=2 ** -8)


def test_kernel_wrapper_takes_an_output_of_the_value_width():
    q, k = torch.randn(1, 2, 8, 24), torch.randn(1, 2, 8, 24)
    v = torch.randn(1, 2, 8, 16)
    out = torch.empty(1, 2, 8, 16)
    got = flash_attn.flash_attention(q, k, v, scale=0.5, out=out)
    assert got is out
    torch.testing.assert_close(got, flash_attn.flash_attention_plain(
        q, k, v, scale=0.5))
    with pytest.raises(ValueError):
        flash_attn.flash_attention(q, k, v, out=torch.empty(1, 2, 8, 24))
    with pytest.raises(ValueError):
        flash_attn.flash_attention(q, k, torch.randn(1, 2, 9, 16))
