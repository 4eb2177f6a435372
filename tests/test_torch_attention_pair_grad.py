"""Attention's gradient at multi-head latent attention's (D, Dv) pairs on
the CPU: the port's backward (``kernels.flash_attn_bwd``, whose CPU path
is its plain version, autograd through the float32 reference attention)
against ``jax.vjp`` of the JAX package's chunked attention
(``repro.models.attention.flash_attention``), on the same numpy inputs.

The pairs are DeepSeek-V3's (192, 128) and its smoke config's (24, 16),
at MLA's scale ``D ** -0.5`` (``(qk_nope + qk_rope) ** -0.5``) and at
another, causal and full, with groups of 1 and 4 query heads a KV head,
lengths that the reference cuts into 16-row chunks and a ragged one it
takes as one block.  Tolerance: each gradient within 1e-5 of its largest
element (float32 sums in other orders and another blocking of the
softmax; 1.1e-6 seen).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattention
from repro_torch.kernels import flash_attn_bwd
from repro_torch.models import attention
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5


@pytest.mark.parametrize("d,dv", [(192, 128), (24, 16)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,hk,s", [(4, 4, 48), (4, 1, 37)])
@pytest.mark.parametrize("scale", [None, 0.37])
def test_pair_backward_matches_jax(d, dv, causal, h, hk, s, scale):
    rng = np.random.default_rng(d + dv + h + hk + s)
    q = (0.5 * rng.standard_normal((2, s, h, d))).astype(np.float32)
    k = (0.5 * rng.standard_normal((2, s, hk, d))).astype(np.float32)
    v = rng.standard_normal((2, s, hk, dv)).astype(np.float32)
    do = rng.standard_normal((2, s, h, dv)).astype(np.float32)
    out, vjp = jax.vjp(lambda a, b, c: jattention.flash_attention(
        a, b, c, causal=causal, chunk=16, scale=scale), q, k, v)
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    t_out = attention.chunked_attention(tq, tk, tv, causal=causal, chunk=16,
                                        scale=scale)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(out), rtol=0,
                               atol=1e-5)
    before = flash_attn_bwd.LAUNCHES
    got = flash_attn_bwd.flash_attention_bwd(
        *(x.transpose(1, 2) for x in (tq, tk, tv, t_out, tdo)),
        torch.zeros(2, h, s), causal=causal, scale=scale)
    assert flash_attn_bwd.LAUNCHES == before
    for g, w, width in zip(got, want, (d, d, dv)):
        g = g.transpose(1, 2).numpy()
        w = np.asarray(w)
        assert g.shape == w.shape and g.shape[-1] == width
        assert np.abs(g - w).max() <= TOL * np.abs(w).max()
