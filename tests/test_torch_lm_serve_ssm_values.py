"""The ``lm_serve_ssm`` section of ``src/repro_torch/reference_values.json``:
the falcon-mamba (SSM) and hymba (hybrid) smoke configs served by the
JAX package as ``examples/serve_lm.py`` serves them (tests/lm_parity.py:
2 numpy-seeded prompts, a prefill over 64 tokens, 4 greedy decode
steps), float32 end to end (float32 caches) and bf16 through the serve
steps as built (bf16 caches, the decode steps fed the stored tokens);
and the hubert-xlarge (audio) and internvl2-76b (vision) smoke configs'
forwards on stored numpy inputs, float32 and bf16, their last 4
positions' logits.  Each holds the digests of ``init_params(PRNGKey(0))``'s
leaves.  ``chip_smoke.py``'s ``lm_serve`` phase holds the card to it
without importing JAX.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_lm_serve_ssm_values.py

rewrites the section (~30 s on the CPU).  The tests below recompute it
with JAX, and hold the port's CPU run to it at the parity tests'
tolerances (tests/test_torch_lm_serve_ssm.py, test_torch_lm_frontends.py).
"""
import hashlib
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from lm_parity import jax_serve, port_serve, prompts, top2_margin, variant
from repro.models import init_params as jinit_params
from repro.models import transformer as jtransformer
from repro_torch.core import prng
from repro_torch.models import init_params, layers, param_defs, transformer
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

PATH = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "reference_values.json")
SECTION = "lm_serve_ssm"
SERVE_ARCHS = ("falcon_mamba_7b", "hymba_1_5b")
FRONTEND_ARCHS = ("hubert_xlarge", "internvl2_76b")
BATCH, PROMPT_LEN, STEPS, SEED = 2, 59, 4, 0
FRONTEND_LEN, LAST = 32, 4
F32_TOL, BF16_ATOL = 1e-4, 0.0625


def _floats(x) -> list:
    return np.asarray(x, np.float32).tolist()


def digests(paths, leaves) -> dict:
    """sha256 (first 16 hex digits) of each leaf's bytes, by path."""
    return {p: hashlib.sha256(np.ascontiguousarray(a).tobytes())
            .hexdigest()[:16] for p, a in zip(paths, leaves)}


def _jax_digests(cfg, params) -> dict:
    paths = [p for p, _ in layers.tree_items(param_defs(cfg))]
    return digests(paths, jax.tree.map(np.asarray, jax.tree.leaves(params)))


def _port_digests(params) -> dict:
    items = layers.tree_items(params)
    return digests([p for p, _ in items],
                   [t.view(torch.int16).numpy()
                    if t.dtype == torch.bfloat16 else t.numpy()
                    for _, t in items])


def frontend_inputs(cfg) -> dict:
    """The stored numpy batch of a frontend config: audio frames (2, 32,
    d_model); or 32 tokens and (2, n_frontend_tokens, d_model) patch
    embeddings."""
    rng = np.random.default_rng(SEED)
    if cfg.frontend == "audio":
        return {"features": rng.standard_normal(
            (BATCH, FRONTEND_LEN, cfg.d_model)).astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, FRONTEND_LEN)),
            "img_embeds": rng.standard_normal(
                (BATCH, cfg.n_frontend_tokens, cfg.d_model)).astype(
                    np.float32)}


def section() -> dict:
    """The section as the JAX package computes it now."""
    out = {}
    for arch in SERVE_ARCHS:
        entry = {"arch": arch, "batch": BATCH, "prompt_len": PROMPT_LEN,
                 "steps": STEPS, "seed": SEED, "variants": {}}
        for dtype in ("float32", "bfloat16"):
            jcfg, cfg = variant(arch, dtype)
            params = jinit_params(jcfg, jax.random.PRNGKey(0))
            toks = prompts(jcfg.vocab_size, BATCH, PROMPT_LEN + STEPS + 1,
                           SEED)
            run = jax_serve(jcfg, params, toks, PROMPT_LEN, STEPS,
                            cache_dtype=dtype)
            entry["prompts"] = toks.tolist()
            entry["variants"][dtype] = {
                "cache_dtype": dtype, "overrides": {},
                "digests": _jax_digests(cfg, params),
                "prefill_logits": _floats(run["prefill_logits"]),
                "decode_logits": [_floats(x) for x in run["decode_logits"]],
                "tokens": [np.asarray(t).tolist() for t in run["tokens"]]}
        out[arch] = entry
    for arch in FRONTEND_ARCHS:
        entry = {"arch": arch, "frontend": True, "last": LAST,
                 "variants": {}}
        for dtype in ("float32", "bfloat16"):
            jcfg, cfg = variant(arch, dtype)
            params = jinit_params(jcfg, jax.random.PRNGKey(0))
            batch = frontend_inputs(cfg)
            logits, _, _, _ = jax.jit(lambda p, b: jtransformer.forward(
                p, jcfg, b, remat=False))(params,
                                          jax.tree.map(jnp.asarray, batch))
            entry["inputs"] = {k: np.asarray(v).tolist()
                               for k, v in batch.items()}
            entry["variants"][dtype] = {
                "digests": _jax_digests(cfg, params),
                "logits": _floats(np.asarray(logits)[:, -LAST:])}
        out[arch] = entry
    return out


def _load() -> dict:
    return json.loads(PATH.read_text())[SECTION]


def test_section_matches_jax():
    """The stored runs are what the JAX package computes now."""
    assert _load() == json.loads(json.dumps(section()))


def _check(got, want, dtype):
    atol = F32_TOL if dtype == "float32" else BF16_ATOL
    rtol = F32_TOL if dtype == "float32" else 0.0
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def test_section_matches_port():
    """The port on the CPU: its init gives the stored leaf digests; its
    serve loop the stored logits (float32 at 1e-4 with its own greedy
    tokens equal; bf16, fed the stored tokens, within 0.0625 and tokens
    equal where the stored top-2 margin is clear); its frontend forwards
    the stored logits at the same bounds."""
    for arch, ref in _load().items():
        for dtype, want in ref["variants"].items():
            _, cfg = variant(arch, dtype)
            params = init_params(cfg, prng.PRNGKey(0, device="cpu"))
            assert _port_digests(params) == want["digests"], (arch, dtype)
            if ref.get("frontend"):
                batch = {k: torch.tensor(v) for k, v in ref["inputs"].items()}
                logits, _, _, _ = transformer.forward(params, cfg, batch)
                _check(logits[:, -ref["last"]:].numpy(), want["logits"],
                       dtype)
                continue
            forced = None if dtype == "float32" else want["tokens"][:-1]
            run = port_serve(cfg, params, np.asarray(ref["prompts"]),
                             ref["prompt_len"], ref["steps"], forced=forced,
                             cache_dtype=want["cache_dtype"])
            logits = [run["prefill_logits"]] + run["decode_logits"]
            stored = [want["prefill_logits"]] + want["decode_logits"]
            for g, w, gt, wt in zip(logits, stored, run["tokens"],
                                    want["tokens"]):
                _check(g, w, dtype)
                w = np.asarray(w, np.float32)
                clear = (top2_margin(w) > 2 * BF16_ATOL
                         if dtype == "bfloat16" else np.ones(len(wt), bool))
                assert np.array_equal(gt[clear], np.asarray(wt)[clear])


if __name__ == "__main__":
    values = json.loads(PATH.read_text())
    values[SECTION] = section()
    PATH.write_text(json.dumps(values, indent=1) + "\n")
    print(f"wrote {SECTION} to {PATH}", file=sys.stderr)
