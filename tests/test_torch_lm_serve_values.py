"""The ``lm_serve_moe`` section of ``src/repro_torch/reference_values.json``:
the moonshot (MoE) and deepseek-v3 (MLA + MoE) smoke configs served by
the JAX package as ``examples/serve_lm.py`` serves them
(tests/lm_parity.py): 2 numpy-seeded prompts, a prefill over 64 tokens,
4 greedy decode steps.  Two variants an architecture: float32 end to
end (float32 caches) with the published routing, and bf16 through the
serve steps as built (bf16 caches) with the routing neutralised
(``lm_parity.neutral_routing``; its overrides are stored beside it) and
the decode steps fed the stored tokens.  Each holds the digests of
``init_params(PRNGKey(0))``'s leaves, the prefill's last logits, each
decode step's logits and the greedy tokens.  ``chip_smoke.py``'s
``lm_serve`` phase holds the card to it without importing JAX.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_lm_serve_values.py

rewrites the section (~40 s on the CPU).  The tests below recompute it
with JAX, and hold the port's CPU run to it at the serve tests'
tolerances (tests/test_torch_lm_serve_moe.py).
"""
import hashlib
import json
import sys
from pathlib import Path

import jax
import numpy as np
import torch

from lm_parity import (jax_serve, neutral_routing, port_serve, prompts,
                       top2_margin, variant)
from repro.models import init_params as jinit_params
from repro_torch.core import prng
from repro_torch.models import init_params, layers, param_defs
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

PATH = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "reference_values.json")
SECTION = "lm_serve_moe"
ARCHS = ("moonshot_v1_16b_a3b", "deepseek_v3_671b")
BATCH, PROMPT_LEN, STEPS, SEED = 2, 59, 4, 0
F32_TOL = 1e-4
# The bf16 bounds of tests/test_torch_lm_serve_moe.py and
# test_torch_lm_serve_mla.py (MLA rounds at more sites).
BF16_ATOL = {"moonshot_v1_16b_a3b": 0.0625, "deepseek_v3_671b": 0.125}


def _floats(x) -> list:
    return np.asarray(x, np.float32).tolist()


def digests(paths, leaves) -> dict:
    """sha256 (first 16 hex digits) of each leaf's bytes, by path."""
    return {p: hashlib.sha256(np.ascontiguousarray(a).tobytes())
            .hexdigest()[:16] for p, a in zip(paths, leaves)}


def _overrides(arch: str, dtype: str) -> dict:
    return {} if dtype == "float32" else neutral_routing(arch)


def section() -> dict:
    """The section as the JAX package computes it now."""
    out = {}
    for arch in ARCHS:
        entry = {"arch": arch, "batch": BATCH, "prompt_len": PROMPT_LEN,
                 "steps": STEPS, "seed": SEED, "variants": {}}
        for dtype in ("float32", "bfloat16"):
            over = _overrides(arch, dtype)
            jcfg, cfg = variant(arch, dtype, **over)
            params = jinit_params(jcfg, jax.random.PRNGKey(0))
            toks = prompts(jcfg.vocab_size, BATCH, PROMPT_LEN + STEPS + 1,
                           SEED)
            run = jax_serve(jcfg, params, toks, PROMPT_LEN, STEPS,
                            cache_dtype=dtype)
            paths = [p for p, _ in layers.tree_items(param_defs(cfg))]
            entry["prompts"] = toks.tolist()
            entry["variants"][dtype] = {
                "cache_dtype": dtype, "overrides": over,
                "digests": digests(paths, jax.tree.map(
                    np.asarray, jax.tree.leaves(params))),
                "prefill_logits": _floats(run["prefill_logits"]),
                "decode_logits": [_floats(x) for x in run["decode_logits"]],
                "tokens": [np.asarray(t).tolist() for t in run["tokens"]]}
        out[arch] = entry
    return out


def _load() -> dict:
    return json.loads(PATH.read_text())[SECTION]


def test_section_matches_jax():
    """The stored runs are what the JAX package computes now."""
    assert _load() == json.loads(json.dumps(section()))


def test_section_matches_port():
    """The port on the CPU: its init gives the stored leaf digests; its
    serve loop the stored logits (float32 at 1e-4 with its own greedy
    tokens equal; bf16, fed the stored tokens, within the serve tests'
    bound and tokens equal where the stored top-2 margin is clear)."""
    for arch, ref in _load().items():
        toks = np.asarray(ref["prompts"])
        for dtype, want in ref["variants"].items():
            _, cfg = variant(arch, dtype, **want["overrides"])
            params = init_params(cfg, prng.PRNGKey(0, device="cpu"))
            items = layers.tree_items(params)
            got = digests([p for p, _ in items],
                          [t.view(torch.int16).numpy()
                           if t.dtype == torch.bfloat16 else t.numpy()
                           for _, t in items])
            assert got == want["digests"], (arch, dtype)
            forced = None if dtype == "float32" else want["tokens"][:-1]
            run = port_serve(cfg, params, toks, ref["prompt_len"],
                             ref["steps"], forced=forced,
                             cache_dtype=want["cache_dtype"])
            atol = F32_TOL if dtype == "float32" else BF16_ATOL[arch]
            rtol = F32_TOL if dtype == "float32" else 0.0
            logits = [run["prefill_logits"]] + run["decode_logits"]
            stored = [want["prefill_logits"]] + want["decode_logits"]
            for g, w, gt, wt in zip(logits, stored, run["tokens"],
                                    want["tokens"]):
                w = np.asarray(w, np.float32)
                np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
                clear = (top2_margin(w) > 2 * atol if dtype == "bfloat16"
                         else np.ones(len(wt), bool))
                assert np.array_equal(gt[clear], np.asarray(wt)[clear])


if __name__ == "__main__":
    values = json.loads(PATH.read_text())
    values[SECTION] = section()
    PATH.write_text(json.dumps(values, indent=1) + "\n")
    print(f"wrote {SECTION} to {PATH}", file=sys.stderr)
