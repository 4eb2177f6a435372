"""The serve parity cases of one MoE-family smoke config, shared by
tests/test_torch_lm_serve_moe.py (moonshot) and test_torch_lm_serve_mla.py
(deepseek-v3), each a file of its own so that the JAX runs spread over
the workers.  A file imports these tests and fixtures and defines the
module-scoped fixture ``family``: ``{"arch": ..., "bf16_atol": ...}``.
Its docstring states the tolerances.
"""
import dataclasses

import numpy as np
import pytest
import torch

from lm_parity import neutral_routing, prompts, serve_both, top2_margin
from repro_torch import configs
from repro_torch.core import prng
from repro_torch.launch import steps
from repro_torch.models import convert, forward, init_caches, init_params

# 64 prefill tokens: two attention chunks of 32.
PROMPT_LEN, N_STEPS = 59, 4
F32_TOL = 1e-4


@pytest.fixture(scope="module")
def f32_run(family):
    return serve_both(family["arch"], "float32", PROMPT_LEN, N_STEPS,
                      cache_dtype="float32")


@pytest.fixture(scope="module")
def bf16_run(family):
    return serve_both(family["arch"], "bfloat16", PROMPT_LEN, N_STEPS,
                      forced_from_jax=True,
                      **neutral_routing(family["arch"]))


def test_prefill_matches_jax_f32(f32_run):
    got, want = f32_run
    np.testing.assert_allclose(got["prefill_logits"], want["prefill_logits"],
                               rtol=F32_TOL, atol=F32_TOL)
    assert np.array_equal(got["tokens"][0], want["tokens"][0])


def test_decode_matches_jax_f32(f32_run):
    got, want = f32_run
    for g, w in zip(got["decode_logits"], want["decode_logits"]):
        np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL)
    for g, w in zip(got["tokens"], want["tokens"]):
        assert np.array_equal(g, w)


def test_prefill_caches_match_jax_f32(f32_run):
    got, want = f32_run
    caches = convert.caches_to_numpy(got["caches"])
    assert set(caches) == set(want["caches"]) == {"dense_layers", "layers"}
    for name, c in caches.items():
        w = want["caches"][name]._asdict()
        assert np.array_equal(c["positions"], w["positions"])
        for field in c:
            np.testing.assert_allclose(c[field], w[field], rtol=F32_TOL,
                                       atol=F32_TOL)


def test_decode_from_jax_caches_matches_jax_f32(f32_run):
    """The reference's prefill caches carried across
    (``convert.caches_from_jax``) and one port decode step on them."""
    got, want = f32_run
    cfg, params = got["cfg"], got["params"]
    caches = convert.caches_from_jax(want["caches"], device="cpu")
    decode, _ = steps.build_decode_step(cfg, batch=2,
                                        max_len=PROMPT_LEN + N_STEPS + 1,
                                        device="cpu")
    tok = torch.tensor(want["tokens"][0], dtype=torch.int64)
    logits, _ = decode(params, caches, tok[:, None],
                       torch.full((2,), PROMPT_LEN, dtype=torch.int32))
    np.testing.assert_allclose(logits[:, 0].numpy(),
                               want["decode_logits"][0], rtol=F32_TOL,
                               atol=F32_TOL)


def test_serve_matches_jax_bf16(bf16_run, family):
    got, want = bf16_run
    atol = family["bf16_atol"]
    logits = [got["prefill_logits"]] + got["decode_logits"]
    ref = [want["prefill_logits"]] + want["decode_logits"]
    for g, w, gt, wt in zip(logits, ref, got["tokens"], want["tokens"]):
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)
        clear = top2_margin(w) > 2 * atol
        assert np.array_equal(gt[clear], wt[clear])


def test_decode_matches_full_forward(family):
    """A prefill of S - 1 tokens and one decode step give the full
    forward's last logits within tests/test_arch_smoke.py's 0.35."""
    arch = family["arch"]
    cfg = dataclasses.replace(configs.get_smoke(arch),
                              **neutral_routing(arch))
    params = init_params(cfg, prng.PRNGKey(0, device="cpu"))
    B, S = 2, 32
    tokens = torch.from_numpy(prompts(cfg.vocab_size, B, S, seed=0))
    full, _, aux, _ = forward(params, cfg, {"tokens": tokens})
    assert aux.item() > 0
    caches = init_caches(cfg, B, S, device="cpu")
    _, caches, _, _ = forward(params, cfg, {"tokens": tokens[:, :-1]},
                              caches=caches)
    lg, _, _, _ = forward(params, cfg, {"tokens": tokens[:, -1:]},
                          caches=caches,
                          decode_pos=torch.full((B,), S - 1,
                                                dtype=torch.int32))
    assert lg.dtype == torch.float32 and lg.shape == (B, 1, cfg.vocab_size)
    assert (lg[:, 0] - full[:, -1]).abs().max().item() < 0.35


def test_serve_example_runs_on_cpu(family):
    from repro_torch.examples import serve_lm
    from repro_torch.kernels import flash_attn
    before = flash_attn.LAUNCHES
    out = serve_lm.serve(configs.get_smoke(family["arch"]), batch=2,
                         prompt_len=10, tokens=4, device="cpu")
    assert out["tokens"].shape == (2, 4)
    assert flash_attn.LAUNCHES == before     # CPU: the plain attention
    assert torch.isfinite(out["first_logits"]).all()
