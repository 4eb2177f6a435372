"""Port parity of the LM serving path as a whole: the reference's weights
carried across by ``from_jax_params``, then prefill and greedy decode
through ``build_prefill_step``/``build_decode_step`` on both sides, on
the same numpy prompts (tests/lm_parity.py), for the dense smoke configs
qwen3 (GQA, qk_norm), codeqwen (MHA, qkv_bias) and yi (one KV head).

Tolerances, each with its reason:

* float32 end to end (float32 KV caches on both sides): logits to
  rtol = atol = 1e-4 and every greedy token equal.  The two sides sum
  the same products in other orders (measured gap 3.1e-6 at logit
  magnitude 4, over the three configs and four prompt seeds).
* float32 through the serve steps as built: the reference keeps its KV
  cache in bf16 (its ``init_caches`` default) even in a float32 config,
  and its decode rounds p and the PV product to the cache's dtype.  A
  float32 key, p or PV sum that lies at a bf16 rounding boundary rounds
  apart on the two sides and moves later logits by about one bf16 ulp of
  a head output (measured up to 2.2e-3).  Prefill logits hold 1e-4;
  decode logits, fed the reference's tokens, hold atol = 1e-2; greedy
  tokens agree wherever the reference's top-2 margin exceeds 2e-2.
* bf16: logits to atol = 0.0625 (one bf16 ulp at magnitude 8), with
  the decode steps fed the reference's greedy tokens so both sides see
  the same inputs.  XLA and torch round bf16 intermediates in other
  places: in the projections, the residual adds and the norms (measured
  gap up to 0.035 at logit magnitude 4).  Greedy tokens must agree
  wherever the reference's top-2 margin exceeds twice the bound.
"""
import jax
import numpy as np
import pytest
import torch

from lm_parity import jax_serve, port_serve, prompts, top2_margin, variant
from repro.models import init_params as jinit_params
from repro_torch import configs
from repro_torch.core import prng
from repro_torch.models import convert, forward, init_caches, init_params
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCHS = ["qwen3_4b", "codeqwen15_7b", "yi_34b"]
# (prompt_len, decode steps): the prefill spans prompt_len + steps + 1
# tokens, so qwen3 takes two attention chunks of 32, codeqwen one, and
# yi the single-block fallback (48 is no multiple of 32).
LENGTHS = {"qwen3_4b": (59, 4), "codeqwen15_7b": (27, 4), "yi_34b": (43, 4)}
BF16_ATOL = 0.0625


F32_STEPS_ATOL = 1e-2


def _run(arch, dtype, forced_from_jax=False, cache_dtype="bfloat16"):
    jcfg, cfg = variant(arch, dtype)
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    params = convert.from_jax_params(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    prompt_len, n_steps = LENGTHS[arch]
    toks = prompts(cfg.vocab_size, 2, prompt_len + n_steps + 1, seed=3)
    want = jax_serve(jcfg, jparams, toks, prompt_len, n_steps,
                     cache_dtype=cache_dtype)
    forced = want["tokens"][:-1] if forced_from_jax else None
    got = port_serve(cfg, params, toks, prompt_len, n_steps, forced=forced,
                     cache_dtype=cache_dtype)
    return got, want


def _caches_agree(got, want, rtol):
    """Positions equal; keys and values within ``rtol``."""
    gc, wc = got["caches"]["layers"], want["caches"]["layers"]
    assert np.array_equal(gc.positions.numpy(), wc.positions)
    for g, w in ((gc.k, wc.k), (gc.v, wc.v)):
        np.testing.assert_allclose(g.float().numpy(), w.astype(np.float32),
                                   rtol=rtol, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_jax_f32(arch):
    got, want = _run(arch, "float32", cache_dtype="float32")
    np.testing.assert_allclose(got["prefill_logits"], want["prefill_logits"],
                               rtol=1e-4, atol=1e-4)
    for g, w in zip(got["decode_logits"], want["decode_logits"]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    for g, w in zip(got["tokens"], want["tokens"]):
        assert np.array_equal(g, w)
    _caches_agree(got, want, rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_steps_match_jax_f32_with_bf16_cache(arch):
    got, want = _run(arch, "float32", forced_from_jax=True)
    np.testing.assert_allclose(got["prefill_logits"], want["prefill_logits"],
                               rtol=1e-4, atol=1e-4)
    assert np.array_equal(got["tokens"][0], want["tokens"][0])
    for g, w, gt, wt in zip(got["decode_logits"], want["decode_logits"],
                            got["tokens"][1:], want["tokens"][1:]):
        np.testing.assert_allclose(g, w, rtol=0, atol=F32_STEPS_ATOL)
        clear = top2_margin(w) > 2 * F32_STEPS_ATOL
        assert np.array_equal(gt[clear], wt[clear])
    # A float32 key at a bf16 rounding boundary rounds apart: one ulp.
    _caches_agree(got, want, rtol=2 ** -7)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_jax_bf16(arch):
    got, want = _run(arch, "bfloat16", forced_from_jax=True)
    logits = [got["prefill_logits"]] + got["decode_logits"]
    ref = [want["prefill_logits"]] + want["decode_logits"]
    for g, w, gt, wt in zip(logits, ref, got["tokens"], want["tokens"]):
        np.testing.assert_allclose(g, w, rtol=0, atol=BF16_ATOL)
        clear = top2_margin(w) > 2 * BF16_ATOL
        assert np.array_equal(gt[clear], wt[clear])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(arch):
    """tests/test_arch_smoke.py's check on the port: a prefill of S - 1
    tokens and one decode step give the full forward's last logits
    within its bf16 bound of 0.35."""
    cfg = configs.get_smoke(arch)
    params = init_params(cfg, prng.PRNGKey(0, device="cpu"))
    B, S = 2, 32
    tokens = torch.from_numpy(prompts(cfg.vocab_size, B, S, seed=0))
    full, _, _, _ = forward(params, cfg, {"tokens": tokens})
    caches = init_caches(cfg, B, S, device="cpu")
    _, caches, _, _ = forward(params, cfg, {"tokens": tokens[:, :-1]},
                              caches=caches)
    lg, _, _, _ = forward(params, cfg, {"tokens": tokens[:, -1:]},
                          caches=caches,
                          decode_pos=torch.full((B,), S - 1,
                                                dtype=torch.int32))
    assert lg.dtype == torch.float32 and lg.shape == (B, 1, cfg.vocab_size)
    assert (lg[:, 0] - full[:, -1]).abs().max().item() < 0.35


def test_prefill_projects_only_the_last_row():
    """``last_only`` gives the same row as the full projection."""
    cfg = configs.get_smoke("qwen3_4b")
    params = init_params(cfg, prng.PRNGKey(0, device="cpu"))
    tokens = torch.from_numpy(prompts(cfg.vocab_size, 2, 20, seed=1))
    full, _, _, hidden = forward(params, cfg, {"tokens": tokens})
    last, _, _, _ = forward(params, cfg, {"tokens": tokens}, last_only=True)
    assert last.shape == (2, 1, cfg.vocab_size)
    assert torch.equal(last[:, 0], full[:, -1])
    assert hidden.shape == (2, 20, cfg.d_model)


def test_serve_example_runs_on_cpu():
    from repro_torch.examples import serve_lm
    from repro_torch.kernels import flash_attn
    before = flash_attn.LAUNCHES
    out = serve_lm.serve(configs.get_smoke("qwen3_4b"), batch=2,
                         prompt_len=10, tokens=4, device="cpu")
    assert out["tokens"].shape == (2, 4)
    assert out["prefill_calls"] == 2 and out["peak_bytes"] is None
    assert flash_attn.LAUNCHES == before     # CPU: the plain attention
    assert torch.isfinite(out["first_logits"]).all()
