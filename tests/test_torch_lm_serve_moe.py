"""Port parity of the MoE family's serving path (the moonshot smoke
config: GQA attention, one leading dense layer, then layers of 8 routed
experts, top-2, and 2 shared experts): the reference's weights carried
across by ``from_jax_params``, then prefill and greedy decode through
``build_prefill_step``/``build_decode_step`` on both sides, on the same
numpy prompts (tests/lm_parity.py).  One JAX run per dtype, shared by
the module's tests (tests/lm_serve_family.py).

Tolerances, each with its reason:

* float32 end to end (float32 caches on both sides), the published
  routing: logits to rtol = atol = 1e-4, every greedy token equal
  (measured gap 2.4e-6 at logit magnitude 4); the caches' positions
  equal and their values to 1e-4; a decode step of the port from the
  reference's own prefill caches to 1e-4.
* bf16, with the router's discrete decisions neutralised
  (``lm_parity.neutral_routing``: no drops, every expert selected, as
  tests/test_arch_smoke.py does, because one bf16 ulp flips a near-tied
  expert choice): logits to atol = 0.0625 (one bf16 ulp at magnitude 8),
  the decode steps fed the reference's greedy tokens; greedy tokens equal
  wherever the reference's top-2 margin exceeds twice the bound
  (measured gap 0.055).
* decode against the full forward (tests/test_arch_smoke.py's check):
  its bf16 bound of 0.35, with its neutralised routing.
"""
import pytest

from lm_serve_family import (  # noqa: F401  (the shared tests and fixtures)
    bf16_run, f32_run, test_decode_from_jax_caches_matches_jax_f32,
    test_decode_matches_full_forward, test_decode_matches_jax_f32,
    test_prefill_caches_match_jax_f32, test_prefill_matches_jax_f32,
    test_serve_example_runs_on_cpu, test_serve_matches_jax_bf16)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def family():
    return {"arch": "moonshot_v1_16b_a3b", "bf16_atol": 0.0625}
