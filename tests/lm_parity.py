"""The serving loop of ``examples/serve_lm.py`` in both packages, on the
same numpy prompts, for the LM parity tests and the ``lm_serve`` section
of ``src/repro_torch/reference_values.json``.

A run prefills the given (B, L) prompt tokens through
``build_prefill_step``, takes the greedy token of the last position,
then makes ``n_steps`` decode steps through ``build_decode_step`` at
positions ``prompt_len + i`` (with L = prompt_len + n_steps + 1, as the
example sizes it).  ``forced`` (n_steps,
B) feeds given tokens to the decode steps instead of each side's own
greedy ones, so two runs stay comparable where a near tie could flip a
bf16 argmax.  The caches are any of the stacks' trees (a KV cache, a
latent cache under multi-head latent attention, an SSM cache, or the
hybrid family's dict of a KV and an SSM cache; ``dense_layers`` beside
``layers`` in a MoE config).  ``cache_dtype`` float32 keeps the
KV cache in float32
instead of the serve steps' bf16 (the reference's ``init_caches``
default), which makes a float32 config float32 end to end: each side's
prefill is then its ``build_prefill_step`` function run on float32
caches.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.models import transformer as jtransformer
from repro_torch import configs
from repro_torch.launch import steps
from repro_torch.models import transformer

def variant(arch: str, dtype: str, **overrides):
    """The smoke config of ``arch`` in both packages, parameters and
    compute in ``dtype``, with ``overrides`` of other fields."""
    return tuple(dataclasses.replace(pkg.get_smoke(arch), param_dtype=dtype,
                                     compute_dtype=dtype, **overrides)
                 for pkg in (jconfigs, configs))


def prompts(vocab: int, batch: int, length: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (batch, length))


def _jax_prefill_f32_cache(cfg, batch: int, seq_len: int):
    """``build_prefill_step``'s function with float32 caches."""

    def fn(params, batch_in):
        caches = jtransformer.init_caches(cfg, batch, seq_len,
                                          dtype=jnp.float32)
        logits, new_caches, _, _ = jtransformer.forward(
            params, cfg, batch_in, caches=caches, remat=False)
        return logits[:, -1:], new_caches

    return jax.jit(fn)


def jax_serve(cfg, params, tokens: np.ndarray, prompt_len: int,
              n_steps: int, forced=None, cache_dtype="bfloat16") -> dict:
    """The reference's loop on the CPU; every output as numpy, the
    prefill's caches among them."""
    B, L = tokens.shape
    mesh = jmesh.make_smoke_mesh()
    with jax.set_mesh(mesh):
        if cache_dtype == "float32":
            prefill = _jax_prefill_f32_cache(cfg, B, L)
        else:
            prefill, _ = jsteps.build_prefill_step(cfg, mesh, batch=B,
                                                   seq_len=L)
        decode, _ = jsteps.build_decode_step(cfg, mesh, batch=B, max_len=L)
        logits, caches = prefill(params, {"tokens": jnp.asarray(tokens,
                                                                jnp.int32)})
        out = {"prefill_logits": np.asarray(logits[:, -1]),
               "caches": jax.tree.map(np.array, caches)}   # copies
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
        toks, steps_out = [np.asarray(tok)], []
        for i in range(n_steps):
            if forced is not None:
                tok = jnp.asarray(forced[i], jnp.int32)
            pos = jnp.full((B,), prompt_len + i, jnp.int32)
            logits, caches = decode(params, caches, tok[:, None], pos)
            tok = jnp.argmax(logits[:, 0], axis=-1).astype(jnp.int32)
            steps_out.append(np.asarray(logits[:, 0]))
            toks.append(np.asarray(tok))
    out.update(decode_logits=steps_out, tokens=toks)
    return out


def _port_prefill_f32_cache(cfg, batch: int, seq_len: int, device):
    """The port's ``build_prefill_step`` function with float32 caches."""

    @torch.inference_mode()
    def fn(params, batch_in):
        caches = transformer.init_caches(cfg, batch, seq_len, torch.float32,
                                         device=device)
        logits, new_caches, _, _ = transformer.forward(
            params, cfg, batch_in, caches=caches, last_only=True)
        return logits, new_caches

    return fn


def clone_cache(c):
    """A copy of one stack's cache: a NamedTuple of tensors, or the hybrid
    family's dict of them."""
    if isinstance(c, dict):
        return {k: clone_cache(v) for k, v in c.items()}
    return type(c)(*(t.clone() for t in c))


def cache_leaves(tree, mine) -> list:
    """``(path, reference leaf, port leaf)`` for every leaf of a
    reference cache tree (its cache NamedTuples, a hybrid stack's dict of
    them) and the port's ``convert.caches_to_numpy`` tree of the same
    shape."""
    out = []
    for path, ref in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [getattr(k, "key", getattr(k, "name", None)) for k in path]
        got = mine
        for key in keys:
            got = got[key]
        out.append((keys, ref, got))
    return out


def port_serve(cfg, params, tokens: np.ndarray, prompt_len: int,
               n_steps: int, device="cpu", forced=None,
               cache_dtype="bfloat16") -> dict:
    """The port's loop on ``device``; outputs as numpy, the prefill's
    caches as tensors."""
    B, L = tokens.shape
    if cache_dtype == "float32":
        prefill = _port_prefill_f32_cache(cfg, B, L, device)
    else:
        prefill, _ = steps.build_prefill_step(cfg, batch=B, seq_len=L,
                                              device=device)
    decode, _ = steps.build_decode_step(cfg, batch=B, max_len=L,
                                        device=device)
    logits, caches = prefill(params, {"tokens": torch.as_tensor(
        tokens, dtype=torch.int64, device=device)})
    out = {"prefill_logits": logits[:, -1].cpu().numpy(),
           "caches": {name: clone_cache(c) for name, c in caches.items()}}
    tok = logits[:, -1].argmax(-1)
    toks, steps_out = [tok.cpu().numpy()], []
    for i in range(n_steps):
        if forced is not None:
            tok = torch.tensor(forced[i], dtype=torch.int64, device=device)
        pos = torch.full((B,), prompt_len + i, dtype=torch.int32,
                         device=device)
        logits, caches = decode(params, caches, tok[:, None], pos)
        tok = logits[:, 0].argmax(-1)
        steps_out.append(logits[:, 0].cpu().numpy())
        toks.append(tok.cpu().numpy())
    out.update(decode_logits=steps_out, tokens=toks)
    return out


def neutral_routing(arch: str) -> dict:
    """Overrides that take the MoE router's discrete decisions out of a
    bf16 comparison, as tests/test_arch_smoke.py does: no capacity drops
    (capacity factor 8) and every expert selected (top-k = n_experts), so
    the gates still weight each expert by its router probability.  With
    the published top-k, one bf16 ulp of difference in a hidden state
    flips a near-tied expert choice of a token (1 to 4 of 80 tokens a
    layer in the smoke configs), which moves its logits by up to 1.6."""
    return {"capacity_factor": 8.0,
            "top_k": configs.get_smoke(arch).n_experts}


def serve_both(arch: str, dtype: str, prompt_len: int, n_steps: int, *,
               forced_from_jax: bool = False, cache_dtype="bfloat16",
               seed: int = 3, **overrides):
    """The reference's weights carried across, then both serving loops on
    the same 2 prompts of ``prompt_len + n_steps + 1`` tokens: (port
    run, JAX run); the port run also holds the config and weights it
    ran (``cfg``, ``params``)."""
    from repro.models import init_params as jinit_params
    from repro_torch.models import convert

    jcfg, cfg = variant(arch, dtype, **overrides)
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    params = convert.from_jax_params(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    toks = prompts(cfg.vocab_size, 2, prompt_len + n_steps + 1, seed=seed)
    want = jax_serve(jcfg, jparams, toks, prompt_len, n_steps,
                     cache_dtype=cache_dtype)
    forced = want["tokens"][:-1] if forced_from_jax else None
    got = port_serve(cfg, params, toks, prompt_len, n_steps, forced=forced,
                     cache_dtype=cache_dtype)
    got.update(cfg=cfg, params=params)
    return got, want


def top2_margin(logits: np.ndarray) -> np.ndarray:
    """Per row, the gap between the largest and second-largest logit."""
    top = np.sort(np.asarray(logits, np.float64), axis=-1)
    return top[..., -1] - top[..., -2]
