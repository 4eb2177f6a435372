"""Port parity of the stub modality frontends (``embed_inputs``) against
the JAX package on the CPU: the hubert-xlarge smoke config (audio: the
batch's precomputed frame embeddings ``features`` replace the token
embedding, and the config has no ``embed``; an encoder, bidirectional)
and the internvl2-76b smoke config (vision: the batch's patch
embeddings ``img_embeds`` spliced over the first 8 token embeddings of
a dense decoder).  The reference's weights carried across, the same
numpy batch on both sides; the port's own init equals the reference's
bit for bit.

Tolerances: float32 logits to rtol = atol = 1e-4 (sums in another
order); bf16 logits to atol = 0.0625 (the dense family's bound, four bf16
ulps at magnitude 2-4: one ulp of difference at XLA's fused rounding
sites, tests/test_torch_lm_serve.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_parity import variant
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.models import init_params as jinit_params
from repro.models import transformer as jtransformer
from repro_torch.core import prng
from repro_torch.launch import steps
from repro_torch.models import convert, init_params, layers, transformer
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

F32_TOL, BF16_ATOL = 1e-4, 0.0625


def _batch(cfg, seed: int = 5) -> dict:
    """numpy inputs: audio frames (2, 32, d_model); or 24 tokens and, for
    vision, (2, n_frontend_tokens, d_model) patch embeddings."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        return {"features": rng.standard_normal(
            (2, 32, cfg.d_model)).astype(np.float32)}
    out = {"tokens": rng.integers(0, cfg.vocab_size, (2, 24))}
    if cfg.frontend == "vision":
        out["img_embeds"] = rng.standard_normal(
            (2, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return out


def _both(arch, dtype):
    jcfg, cfg = variant(arch, dtype)
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    params = convert.from_jax_params(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jcfg, cfg, jparams, params


def _port_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ["hubert_xlarge", "internvl2_76b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frontend_forward_matches_jax(arch, dtype):
    jcfg, cfg, jparams, params = _both(arch, dtype)
    batch = _batch(cfg)
    want, _, _, _ = jax.jit(lambda p, b: jtransformer.forward(
        p, jcfg, b, remat=False))(jparams, jax.tree.map(jnp.asarray, batch))
    got, _, _, _ = transformer.forward(params, cfg, _port_batch(batch))
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float32
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL,
                                   atol=F32_TOL)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=BF16_ATOL)


def test_vision_frontend_splices_the_patch_embeddings():
    """The first ``n_frontend_tokens`` positions' embeddings are the batch's
    ``img_embeds``, the rest the tokens'; without ``img_embeds`` the
    tokens alone, as in the reference."""
    _, cfg = variant("internvl2_76b", "float32")
    params = init_params(cfg, prng.PRNGKey(0, device="cpu"))
    batch = _port_batch(_batch(cfg))
    x = transformer.embed_inputs(params, cfg, batch, torch.float32)
    n = cfg.n_frontend_tokens
    assert torch.equal(x[:, :n], batch["img_embeds"])
    assert torch.equal(x[:, n:], params["embed"][batch["tokens"][:, n:]])
    plain = transformer.embed_inputs(params, cfg, {"tokens": batch["tokens"]},
                                     torch.float32)
    assert torch.equal(plain, params["embed"][batch["tokens"]])


@pytest.mark.parametrize("arch", ["hubert_xlarge", "internvl2_76b"])
def test_frontend_configs_init_bit_for_bit(arch):
    """The port's init (no ``embed`` in the audio config) is the
    reference's, leaf by leaf."""
    jcfg, cfg = variant(arch, "bfloat16")
    want = jax.tree.leaves(jinit_params(jcfg, jax.random.PRNGKey(0)))
    got = layers.tree_items(init_params(cfg, prng.PRNGKey(0, device="cpu")))
    assert ("embed" in dict(got)) == (cfg.frontend != "audio")
    assert len(got) == len(want)
    for (path, g), w in zip(got, want):
        g = convert.to_numpy({"x": g})["x"]
        assert g.tobytes() == np.asarray(w).tobytes(), path


def test_prefill_step_with_patch_embeddings_matches_jax():
    """The vision config through both packages' ``build_prefill_step``
    (bf16 caches), ``img_embeds`` in the batch: last logits within the
    bf16 bound (the float32 config's activations meet bf16 caches on both
    sides) and the caches' positions equal."""
    jcfg, cfg, jparams, params = _both("internvl2_76b", "float32")
    batch = _batch(cfg)
    mesh = jmesh.make_smoke_mesh()
    with jax.set_mesh(mesh):
        jprefill, _ = jsteps.build_prefill_step(jcfg, mesh, batch=2,
                                                seq_len=24)
        want, jcaches = jprefill(jparams, {
            "tokens": jnp.asarray(batch["tokens"], jnp.int32),
            "img_embeds": jnp.asarray(batch["img_embeds"])})
    prefill, _ = steps.build_prefill_step(cfg, batch=2, seq_len=24,
                                          device="cpu")
    got, caches = prefill(params, _port_batch(batch))
    np.testing.assert_allclose(got[:, -1].numpy(), np.asarray(want[:, -1]),
                               rtol=0, atol=BF16_ATOL)
    assert np.array_equal(caches["layers"].positions.numpy(),
                          np.asarray(jcaches["layers"].positions))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
