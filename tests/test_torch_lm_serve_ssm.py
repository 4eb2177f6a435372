"""Port parity of the SSM and hybrid families' serving paths (the
falcon-mamba smoke config: 2 Mamba-1 layers, no attention; the hymba
smoke config: 2 layers of window-16 GQA attention, 5 query heads on 1 KV
head, beside a Mamba block, then an MLP): the reference's weights carried
across by ``from_jax_params``, then prefill and greedy decode through
``build_prefill_step``/``build_decode_step`` on both sides, on the same
numpy prompts (tests/lm_parity.py).  The prefill covers 64 tokens, so
hymba's rolling KV cache (16 slots) wraps and its prefill takes the
window's chunked path; decode writes positions 59-62 over the oldest
slots.

Tolerances, each with its reason:

* float32 end to end (float32 caches on both sides): logits to rtol =
  atol = 1e-4, every greedy token equal (measured gaps 1.2e-6 and
  2.6e-6 at logit magnitude 3-4); the caches' positions equal and their
  values to 1e-4; a decode step of the port from the reference's own
  prefill caches to 1e-4.
* bf16: logits to atol = 0.0625 (four bf16 ulps at magnitude 2-4; the
  gaps over the decode steps of five prompt seeds measured 0.031-0.039
  for falcon-mamba and 0.037-0.051 for hymba: the Mamba block rounds to
  bf16 after in_proj, the conv, the scan and the gate, where XLA's fused
  passes keep excess precision), the decode steps fed the reference's
  greedy tokens; greedy tokens equal wherever the reference's top-2
  margin exceeds twice the bound.
* decode against the full forward (tests/test_arch_smoke.py's check):
  its bf16 bound of 0.35.
"""
import numpy as np
import pytest
import torch

from lm_parity import cache_leaves, prompts, serve_both, top2_margin
from repro_torch import configs
from repro_torch.core import prng
from repro_torch.launch import steps
from repro_torch.models import convert, forward, init_caches, init_params
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCHS = ("falcon_mamba_7b", "hymba_1_5b")
PROMPT_LEN, N_STEPS = 59, 4
F32_TOL, BF16_ATOL = 1e-4, 0.0625


@pytest.fixture(scope="module", params=ARCHS)
def f32_run(request):
    return serve_both(request.param, "float32", PROMPT_LEN, N_STEPS,
                      cache_dtype="float32")


@pytest.fixture(scope="module", params=ARCHS)
def bf16_run(request):
    return serve_both(request.param, "bfloat16", PROMPT_LEN, N_STEPS,
                      forced_from_jax=True)


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
    """Every leaf of the cache tree (an ``SSMCache`` stack; the hybrid's
    dict of a rolling ``KVCache`` and an ``SSMCache``)."""
    got, want = f32_run
    leaves = cache_leaves(want["caches"],
                          convert.caches_to_numpy(got["caches"]))
    assert len(leaves) == (2 if got["cfg"].family == "ssm" else 5)
    for keys, w, g in leaves:
        assert g.dtype == w.dtype and g.shape == w.shape, keys
        if keys[-1] == "positions":
            assert np.array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL)


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


def test_serve_matches_jax_bf16(bf16_run):
    got, want = bf16_run
    logits = [got["prefill_logits"]] + got["decode_logits"]
    ref = [want["prefill_logits"]] + want["decode_logits"]
    for g, w, gt, wt in zip(logits, ref, got["tokens"], want["tokens"]):
        np.testing.assert_allclose(g, w, rtol=0, atol=BF16_ATOL)
        clear = top2_margin(w) > 2 * BF16_ATOL
        assert np.array_equal(gt[clear], wt[clear])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(arch):
    """A prefill of S - 1 tokens and one decode step give the full
    forward's last logits within tests/test_arch_smoke.py's 0.35 (S = 40:
    past hymba's window of 16)."""
    cfg = configs.get_smoke(arch)
    params = init_params(cfg, prng.PRNGKey(0, device="cpu"))
    B, S = 2, 40
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


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_example_runs_on_cpu(arch):
    from repro_torch.examples import serve_lm
    from repro_torch.kernels import flash_attn, ssm_scan
    before = flash_attn.LAUNCHES, ssm_scan.LAUNCHES
    out = serve_lm.serve(configs.get_smoke(arch), batch=2, prompt_len=20,
                         tokens=4, device="cpu")
    assert out["tokens"].shape == (2, 4)
    # CPU: the plain attention and the plain scan.
    assert (flash_attn.LAUNCHES, ssm_scan.LAUNCHES) == before
    assert torch.isfinite(out["first_logits"]).all()
