"""The port's optimizer (``repro_torch.optim``) against the JAX package's
on the same numpy inputs, on the CPU.

* ``quant``: bit for bit.
* ``schedule``: the cosine and the division are float32 on both sides;
  torch's ``cos`` may sit an ulp from XLA's: 2 float32 ulps of the value.
* ``update`` from one state and one set of gradients, for every moment
  dtype, the factored second moment and both master dtypes, one step and
  five (both inits bit for bit first).  AdamW's step ``lr * m / (sqrt(v)
  + eps)`` rounds an ulp or two of each factor differently (XLA fuses
  some multiply-adds; torch's ``cos``, ``pow`` and ``sqrt`` may sit an ulp
  from XLA's), and the float32 parameters take the difference as it
  is, in ulps of a value that shrinks under weight decay: 16 float32
  ulps of the value (9 seen), or one bf16 ulp for bf16 parameters (one
  element in 2,000 seen differing, by one ulp), plus ``1e-4 * lr``.
  Moments: float32 within 1e-4 relative (1.6e-5 seen, where ``m`` nears
  zero after five steps) plus 1e-7; an int8 moment's codes within one
  step of rounding, and where a code flips the float32 master moves by
  part of that step's ``lr``: ``0.1 * lr`` beside int8 moments.
* The reference's own behaviour tests (``tests/test_substrates.py``),
  ported: AdamW at int8 + factored still fits a quadratic, int8 moments
  track float32 ones, and the schedule's warmup and cosine.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.models import param_defs as jparam_defs
from repro.optim import quant as jquant
from repro_torch import configs, optim
from repro_torch.models import convert, param_defs
from repro_torch.optim import quant
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

F32_ULP = float(np.finfo(np.float32).eps)


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32)
                      if x.dtype == jnp.bfloat16 else x)


# ---------------------------------------------------------------------------
# Quantization: bit for bit.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(64,), (3, 128), (2, 5, 256), (1,),
                                   (7, 3), (), (33, 1000)])
@pytest.mark.parametrize("scale", [1e-4, 1.0, 3.7, 1e3])
def test_quantize_bit_equal(shape, scale):
    rng = np.random.default_rng(len(shape) * 7 + int(scale * 10))
    x = np.asarray(rng.standard_normal(shape) * scale, np.float32)
    if x.size > 2:
        x.reshape(-1)[:2] = 0.0            # zero rows scale by 1.0
    want = jquant.quantize(jnp.asarray(x))
    got = quant.quantize(_t(x))
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(
        quant.dequantize(got).numpy(), np.asarray(jquant.dequantize(want)))
    assert quant.factored_dims(shape) == jquant.factored_dims(shape)


def test_quantize_zero_channel_and_halfway_rounding():
    """A channel of zeros keeps scale 1; values at q + 1/2 round to even,
    as jnp.round does."""
    x = np.array([[0.0, 0.0, 0.0], [127.0, 0.5, 1.5],
                  [127.0, 2.5, -2.5]], np.float32)
    got, want = quant.quantize(_t(x)), jquant.quantize(jnp.asarray(x))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.q.numpy()[1:, 1:],
                                  [[0, 2], [2, -2]])
    assert got.scale[0].item() == 1.0


# ---------------------------------------------------------------------------
# Schedule and update against the reference.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 57, 99, 100, 150])
def test_schedule_matches_reference(step):
    cfg = optim.OptConfig(lr=3e-3, warmup_steps=10, total_steps=100)
    jcfg = joptim.OptConfig(lr=3e-3, warmup_steps=10, total_steps=100)
    got = optim.schedule(cfg, torch.tensor(step, dtype=torch.int32))
    want = np.asarray(joptim.schedule(jcfg, jnp.asarray(step, jnp.int32)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2 * F32_ULP, atol=0)


_SHAPES = {"w": (16, 24), "b": (24,), "blocks": {"k": (3, 8, 16),
                                                 "s": ()}}


def _tree(fn, shapes=_SHAPES):
    return {k: _tree(fn, v) if isinstance(v, dict) else fn(k, v)
            for k, v in shapes.items()}


def _inputs(param_dtype: str, seed: int):
    """Parameters and five gradients as numpy (float32 values rounded to
    the parameter dtype for bf16), by leaf name."""
    rng = np.random.default_rng(seed)
    params = _tree(lambda k, s: np.asarray(rng.standard_normal(s) * 0.5,
                                           np.float32))
    grads = [_tree(lambda k, s: np.asarray(rng.standard_normal(s) * 0.1,
                                           np.float32)) for _ in range(5)]
    if param_dtype == "bfloat16":
        import ml_dtypes
        cast = lambda x: x.astype(ml_dtypes.bfloat16)  # noqa: E731
        params = jax.tree.map(cast, params)
        grads = [jax.tree.map(cast, g) for g in grads]
    return params, grads


_MODES = [
    # (moment_dtype, factored, master_dtype, param_dtype)
    ("float32", False, "float32", "float32"),
    ("float32", False, "float32", "bfloat16"),
    ("bfloat16", False, "float32", "bfloat16"),
    ("int8", False, "float32", "bfloat16"),
    ("float32", True, "float32", "bfloat16"),
    ("int8", True, "bfloat16", "bfloat16"),
    ("bfloat16", False, "bfloat16", "bfloat16"),
]


def _leaves(tree) -> list:
    """Every array of a state tree, ``QTensor``s opened, in sorted order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if type(tree).__name__ == "QTensor":
        return [tree.q, tree.scale]
    return [tree]


@pytest.mark.parametrize("mode", _MODES, ids=["-".join(map(str, m))
                                              for m in _MODES])
@pytest.mark.parametrize("n_steps", [1, 5])
def test_update_matches_reference(mode, n_steps):
    moment, factored, master, pdtype = mode
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=20, weight_decay=0.1,
              moment_dtype=moment, factored_second_moment=factored,
              master_dtype=master)
    cfg, jcfg = optim.OptConfig(**kw), joptim.OptConfig(**kw)
    params, grads = _inputs(pdtype, seed=3)
    jp = jax.tree.map(jnp.asarray, params)
    js = joptim.init(jp, jcfg)
    p = convert.from_jax_params(params, device="cpu")
    s = optim.init(p, cfg)
    # The two inits agree bit for bit.
    for a, b in zip(_leaves(s), _leaves(convert.opt_state_from_jax(
            jax.tree.map(np.asarray, js), device="cpu"))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for i in range(n_steps):
        jp, js = joptim.update(jax.tree.map(jnp.asarray, grads[i]), js, jp,
                               jcfg)
        p, s = optim.update(convert.from_jax_params(grads[i], device="cpu"),
                            s, p, cfg)
    assert int(s["step"]) == int(js["step"]) == n_steps
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(p)):
        assert str(b.dtype).endswith(str(a.dtype))
        # One bf16 ulp is 2^-8 to 2^-7 of the value.
        rtol = 16 * F32_ULP if pdtype == "float32" else 2.0 ** -7
        np.testing.assert_allclose(_np(b), _np(a), rtol=rtol,
                                   atol=1e-4 * cfg.lr)
    jstate = convert.opt_state_from_jax(jax.tree.map(np.asarray, js),
                                        device="cpu")
    assert len(_leaves(jstate)) == len(_leaves(s))
    for a, b in zip(_leaves(jstate), _leaves(s)):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == torch.int8:           # q: one rounding step apart
            assert (a.int() - b.int()).abs().max() <= 1
            continue
        rtol = 2.0 ** -7 if a.dtype == torch.bfloat16 else 1e-4
        # Where an int8 code flips, m moves by one scale and the float32
        # master by a part of that step's lr (2.9e-4 seen at lr 1e-2).
        atol = 0.1 * cfg.lr if moment == "int8" else 1e-7
        np.testing.assert_allclose(_np(b), _np(a), rtol=rtol, atol=atol)


def test_global_norm_sq_sums_leaves_in_sorted_order():
    params, grads = _inputs("float32", seed=4)
    want = np.asarray(joptim.global_norm_sq(jax.tree.map(jnp.asarray,
                                                         grads[0])))
    got = optim.global_norm_sq(convert.from_jax_params(grads[0],
                                                       device="cpu"))
    np.testing.assert_allclose(got.numpy(), want, rtol=4 * F32_ULP)


@pytest.mark.parametrize("moment,factored,master", [
    ("float32", False, "float32"), ("int8", True, "float32"),
    ("bfloat16", False, "bfloat16")])
def test_state_defs_match_reference(moment, factored, master):
    """The state's ParamDef mirror has the reference's leaves, shapes and
    dtypes (the smoke qwen3 tree), and :func:`init` builds exactly it."""
    kw = dict(moment_dtype=moment, factored_second_moment=factored,
              master_dtype=master)
    jdefs = joptim.state_defs(jparam_defs(configs.get_smoke("qwen3_4b")),
                              joptim.OptConfig(**kw))
    defs = optim.state_defs(param_defs(configs.get_smoke("qwen3_4b")),
                            optim.OptConfig(**kw))
    is_def = lambda x: hasattr(x, "fsdp_dim")  # noqa: E731
    want = [(d.shape, d.dtype) for d in jax.tree.leaves(jdefs,
                                                        is_leaf=is_def)]
    got = [(d.shape, d.dtype) for d in _leaves(defs)]
    assert got == want


# ---------------------------------------------------------------------------
# The reference's behaviour tests, ported.
# ---------------------------------------------------------------------------

def _quadratic_grad(w: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    w = w.detach().requires_grad_(True)
    (g,) = torch.autograd.grad(torch.mean((w - target) ** 2), [w])
    return g


def test_adamw_converges_quadratic():
    """Full int8+factored config still optimizes a quadratic."""
    cfg = optim.OptConfig(lr=0.05, weight_decay=0.0, warmup_steps=1,
                          total_steps=200, moment_dtype="int8",
                          factored_second_moment=True)
    target = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (8, 16)).astype(np.float32))
    params = {"w": torch.zeros((8, 16))}
    state = optim.init(params, cfg)
    for _ in range(200):
        g = {"w": _quadratic_grad(params["w"], target)}
        params, state = optim.update(g, state, params, cfg)
    assert float(torch.mean((params["w"] - target) ** 2)) < 1e-2


def test_moment_dtypes_agree():
    """int8 moments track f32 moments to within quantization error."""
    target = torch.ones((4, 64)) * 3
    outs = {}
    for md in ("float32", "int8"):
        cfg = optim.OptConfig(lr=0.02, weight_decay=0.0, warmup_steps=1,
                              moment_dtype=md)
        params = {"w": torch.zeros((4, 64))}
        state = optim.init(params, cfg)
        for _ in range(50):
            g = {"w": _quadratic_grad(params["w"], target)}
            params, state = optim.update(g, state, params, cfg)
        outs[md] = params["w"]
    np.testing.assert_allclose(outs["float32"], outs["int8"],
                               rtol=0.15, atol=0.05)


def test_schedule_warmup_cosine():
    cfg = optim.OptConfig(lr=1.0, warmup_steps=10, total_steps=100)
    step = lambda n: torch.tensor(n, dtype=torch.int32)  # noqa: E731
    assert float(optim.schedule(cfg, step(0))) < 0.11
    assert float(optim.schedule(cfg, step(10))) == pytest.approx(1.0)
    assert float(optim.schedule(cfg, step(100))) == pytest.approx(
        0.1, abs=1e-3)


def test_from_model_reads_the_config():
    cfg = dataclasses.replace(configs.get_smoke("qwen3_4b"),
                              moment_dtype="int8", master_dtype="bfloat16",
                              factored_second_moment=True)
    o = optim.OptConfig.from_model(cfg, lr=1e-3)
    assert (o.moment_dtype, o.master_dtype, o.factored_second_moment,
            o.lr) == ("int8", "bfloat16", True, 1e-3)
