"""Port parity of the SSM family's modules (``repro_torch.models.ssm``,
the selective scan's plain version, the SSM inits and XLA's ``expm1``)
against the JAX package on the CPU, on the same numpy inputs.

Tolerances, each with its reason:

* ``xla_math.expm1`` and the two SSM inits (``ssm_a``, ``ssm_dt``): bit
  for bit, in bf16 and float32 leaves.
* the scan, the conv and the block in float32: rtol = atol = 1e-4 (the
  conv 1e-5: XLA may fuse its multiply-adds).  The
  reference's chunk is one ``lax.associative_scan`` (a tree of products
  and sums) and its ``exp`` XLA's polynomial; the port's plain version is
  a sequential first-order scan with torch's ``exp``: float32 rounding
  in another order (measured gap 2.4e-7 at magnitude 1).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro_torch import configs
from repro_torch.core import prng, xla_math
from repro_torch.kernels import ssm_scan as kscan
from repro_torch.models import convert, layers, ssm
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

RNG = np.random.default_rng(23)
F32_TOL = 1e-4


def _arr(shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def _cfgs(arch="falcon_mamba_7b"):
    return configs.get_smoke(arch), jconfigs.get_smoke(arch)


def _params(cfg):
    """float32 numpy parameters of one Mamba block: a_log and dt_bias as
    the inits make them, the rest normal at the init's fan-in scale."""
    p = {n: _arr(d.shape, (d.shape[-2] if len(d.shape) > 1
                           else d.shape[-1]) ** -0.5)
         for n, d in ssm.ssm_defs(cfg).items()}
    p["a_log"] = np.log(np.broadcast_to(
        np.arange(1, cfg.ssm_state + 1, dtype=np.float32),
        p["a_log"].shape)).astype(np.float32)
    p["dt_bias"] = RNG.uniform(-4.0, -2.0, p["dt_bias"].shape).astype(
        np.float32)
    return p


def _both(p):
    return ({n: torch.from_numpy(np.array(a)) for n, a in p.items()},
            {n: jnp.asarray(a) for n, a in p.items()})


def test_expm1_bit_for_bit():
    """Over the values ``-u`` takes in the ``ssm_dt`` init (u in [1e-3,
    1e-1]), both branches' edges, zero, the clamps and the tails."""
    x = np.concatenate([
        -RNG.uniform(1e-3, 1e-1, 200_000), RNG.uniform(-3.0, 3.0, 50_000),
        RNG.uniform(-1e-3, 1e-3, 20_000),
        np.array([0.0, -0.0, 0.5, -0.5, 0.50001, 8e-4, -8e-4, 16.0, 40.0,
                  -40.0, 100.0, -100.0, 1e-30, -1e-30])]).astype(np.float32)
    want = np.asarray(jnp.expm1(jnp.asarray(x)))
    got = xla_math.expm1(torch.from_numpy(x)).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("init,shape", [("ssm_a", (3, 40, 8)),
                                        ("ssm_a", (128, 16)),
                                        ("ssm_dt", (3, 160)),
                                        ("ssm_dt", (8192,))])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ssm_inits_bit_for_bit(init, shape, dtype):
    tp = (None,) * len(shape)
    jd = jlayers.ParamDef(shape, tp, fsdp_dim=None, dtype=dtype, init=init)
    td = layers.ParamDef(shape, tp, fsdp_dim=None, dtype=dtype, init=init)
    for seed in (0, 7):
        want = np.asarray(jlayers.init_param(jax.random.PRNGKey(seed), jd))
        got = convert.to_numpy({"x": layers.init_param(
            prng.PRNGKey(seed, device="cpu"), td)})["x"]
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes(), (init, dtype, seed)


def _scan_inputs(cfg, b, s):
    p = _params(cfg)
    xc = _arr((b, s, cfg.d_inner), 0.5)
    state = _arr((b, cfg.d_inner, cfg.ssm_state), 0.5)
    return p, xc, state


@pytest.mark.parametrize("s", [1, 37, 300, 512])
def test_ssm_scan_matches_jax(s):
    """S = 1, 37 and 300 are one chunk (300 does not divide by 256), 512
    two chunks of 256; the start state is not zero."""
    cfg, jcfg = _cfgs()
    p, xc, state = _scan_inputs(cfg, 2, s)
    tp, jp = _both(p)
    y, h = ssm.ssm_scan(tp, torch.from_numpy(xc), torch.from_numpy(state))
    wy, wh = jax.jit(jssm.ssm_scan)(jp, jnp.asarray(xc), jnp.asarray(state))
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(wh), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("s", [0, 1, 300, 512])
def test_ssm_scan_plain_chunks_equal_one_sequence(s):
    """The plain version's chunks carry the state exactly: chunk 256 (or
    the whole of S) against one chunk of 1 step at a time, to float32
    rounding of the einsum's order only; an empty sequence returns the
    start state."""
    gen = torch.Generator().manual_seed(s)
    b, di, n = 2, 24, 8
    dt = torch.rand(b, s, di, generator=gen) * 0.2
    x, bm, cm = (torch.randn(b, s, k, generator=gen) for k in (di, n, n))
    a = -torch.rand(di, n, generator=gen) * 4
    d, h0 = torch.randn(di, generator=gen), torch.randn(b, di, n,
                                                        generator=gen)
    y1, h1 = kscan.ssm_scan_plain(dt, x, bm, cm, a, d, h0)
    y2, h2 = kscan.ssm_scan_plain(dt, x, bm, cm, a, d, h0, chunk=1)
    torch.testing.assert_close(y1, y2, rtol=1e-6, atol=1e-6)
    assert torch.equal(h1, h2)
    before = kscan.LAUNCHES
    y3, h3 = kscan.ssm_scan(dt, x, bm, cm, a, d, h0)     # CPU: plain
    assert kscan.LAUNCHES == before
    assert torch.equal(y3, y1) and torch.equal(h3, h1)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    cfg, _ = _cfgs()
    p = _params(cfg)
    x = _arr((2, 9, cfg.d_inner))
    conv = _arr((2, cfg.d_conv - 1, cfg.d_inner)) if with_state else None
    tp, jp = _both(p)
    out, st = ssm._causal_conv(
        tp, torch.from_numpy(x),
        None if conv is None else torch.from_numpy(conv))
    wout, wst = jssm._causal_conv(
        jp, jnp.asarray(x), None if conv is None else jnp.asarray(conv))
    np.testing.assert_allclose(out.numpy(), np.asarray(wout), rtol=1e-5,
                               atol=1e-5)
    assert np.array_equal(st.numpy(), np.asarray(wst))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_apply_prefill_then_decode_matches_jax(dtype):
    """The Mamba block over a 40-token prefill, then 3 decode steps, each
    package on its own returned caches: float32 at 1e-4; bf16 activations
    at 2^-6 of each output's largest magnitude (the block rounds to bf16
    after in_proj, the conv, the scan and the gate, where XLA's fused
    passes keep excess precision: measured 0.0117 at magnitude 1.37) and
    the float32 state at 2e-2."""
    cfg, jcfg = _cfgs()
    cfg = dataclasses.replace(cfg, compute_dtype=dtype)
    jcfg = dataclasses.replace(jcfg, compute_dtype=dtype)
    p = _params(cfg)
    tp, jp = _both(p)
    td = layers.DTYPES[dtype]
    jd = jnp.dtype(dtype)
    x = _arr((2, 40, cfg.d_model))
    steps = [_arr((2, 1, cfg.d_model)) for _ in range(3)]
    got, cache = ssm.ssm_apply(tp, torch.from_numpy(x).to(td), cfg)
    want, jcache = jax.jit(lambda p_, x_: jssm.ssm_apply(p_, x_, jcfg))(
        jp, jnp.asarray(x, jd))
    outs = [(got, want)]
    step = jax.jit(lambda p_, x_, c_: jssm.ssm_apply(p_, x_, jcfg, cache=c_,
                                                     decode=True))
    for xs in steps:
        got, cache = ssm.ssm_apply(tp, torch.from_numpy(xs).to(td), cfg,
                                   cache=cache, decode=True)
        want, jcache = step(jp, jnp.asarray(xs, jd), jcache)
        outs.append((got, want))
    for g, w in outs:
        g, w = g.float().numpy(), np.asarray(w.astype(jnp.float32))
        tol = F32_TOL if dtype == "float32" else 2 ** -6 * np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=F32_TOL if dtype == "float32"
                                   else 0, atol=tol)
    assert cache.conv.dtype == td and cache.state.dtype == torch.float32
    np.testing.assert_allclose(cache.state.numpy(), np.asarray(jcache.state),
                               rtol=F32_TOL if dtype == "float32" else 2e-2,
                               atol=F32_TOL if dtype == "float32" else 2e-2)


def test_init_ssm_cache_matches_jax():
    cfg, jcfg = _cfgs("hymba_1_5b")
    got = ssm.init_ssm_cache(cfg, 3, device="cpu")
    want = jssm.init_ssm_cache(jcfg, 3)
    for g, w in zip(convert.to_numpy(got._asdict()).values(), want):
        assert g.shape == w.shape and g.dtype == np.asarray(w).dtype
        assert not g.astype(np.float32).any()


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "hymba_1_5b"])
def test_registry_and_param_count_match_reference(arch):
    """The full configs' parameter registries (paths, shapes, dtypes,
    inits) and counts, over the registry only: Falcon-Mamba-7B's 7.27 B
    and Hymba-1.5B's 1.66 B parameters."""
    from repro.models import transformer as jtransformer
    from repro_torch.models import transformer
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    got = [(p, d.shape, d.dtype, d.init, d.scale) for p, d in
           layers.tree_items(transformer.param_defs(cfg))]
    flat, _ = jax.tree_util.tree_flatten_with_path(
        jtransformer.param_defs(jcfg),
        is_leaf=lambda x: isinstance(x, jlayers.ParamDef))
    want = [(".".join(str(k.key) for k in path), tuple(d.shape), d.dtype,
             d.init, d.scale) for path, d in flat]
    assert got == want
    assert cfg.param_count() == jcfg.param_count()


def test_init_params_are_freed_without_the_garbage_collector():
    """``init_tree`` once rebuilt the tree in a recursive closure, a
    reference cycle that held every weight until the garbage collector
    ran (on the card, a served model's weights stayed allocated into the
    next model's run).  With the collector off, dropping the weights
    frees them."""
    import gc
    import weakref
    from repro_torch.models import init_params
    cfg = configs.get_smoke("falcon_mamba_7b")
    gc.disable()
    try:
        params = init_params(cfg, prng.PRNGKey(0, device="cpu"))
        leaf = weakref.ref(params["layers"]["ssm"]["a_log"])
        del params
        assert leaf() is None
    finally:
        gc.enable()
