"""Port parity: the flash-attention kernel's wrapper against the JAX
package, at the shapes and tolerance of tests/test_kernels.py
(rtol = atol = 2e-3, the reference's own).  On the CPU the wrapper runs
its plain version; the CUDA kernel is held against that on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import flash_attn, ops, ref
from repro_torch.models import attention
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

RNG = np.random.default_rng(7)


def _arr(shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("s,d", [(64, 16), (128, 32), (256, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_jax_kernel_and_reference(s, d, causal):
    q, k, v = (_arr((2, 2, s, d), 0.5) for _ in range(3))
    before = flash_attn.LAUNCHES
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal)
    assert flash_attn.LAUNCHES == before     # CPU: the plain version
    assert got.dtype == torch.float32 and got.shape == (2, 2, s, d)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    kernel = np.asarray(jops.flash_attention(jq, jk, jv, causal=causal))
    plain = np.asarray(jref.flash_attention(jq, jk, jv, causal=causal))
    np.testing.assert_allclose(got.numpy(), kernel, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got.numpy(), plain, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(
        ref.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal=causal).numpy(),
        plain, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("h,hk", [(4, 2), (7, 1)])
def test_grouped_heads_equal_repeated_kv(h, hk):
    """Query head h reads KV head h // (H // Hk): the same as the
    reference on K and V repeated per group."""
    q, k, v = _arr((2, h, 48, 16)), _arr((2, hk, 48, 16)), _arr((2, hk, 48,
                                                                16))
    got = flash_attn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), causal=True)
    rep = h // hk
    want = jref.flash_attention(jnp.asarray(q),
                                jnp.repeat(jnp.asarray(k), rep, axis=1),
                                jnp.repeat(jnp.asarray(v), rep, axis=1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)


def test_plain_version_keeps_q_dtype():
    q = torch.from_numpy(_arr((1, 2, 32, 16))).to(torch.bfloat16)
    out = flash_attn.flash_attention(q, q, q)
    assert out.dtype == torch.bfloat16
    assert torch.isfinite(out.float()).all()


@pytest.mark.parametrize("shapes", [
    ((2, 4, 16, 8), (2, 3, 16, 8)),      # H not a multiple of Hk
    ((2, 4, 16, 8), (1, 4, 16, 8)),      # batch differs
    ((2, 4, 16, 8), (2, 4, 16, 16)),     # head dim differs
    ((4, 16, 8), (4, 16, 8)),            # not 4-D
])
def test_wrapper_rejects_mismatched_shapes(shapes):
    qs, ks = shapes
    q, k = torch.zeros(qs), torch.zeros(ks)
    with pytest.raises(ValueError):
        flash_attn.flash_attention(q, k, k)


def _layout(t):
    return flash_attn.layout_error(t.shape, t.stride(), t.data_ptr())


@pytest.mark.parametrize("d", [8, 16, 64, 128])
def test_kernel_layout_accepts_the_models_transposed_views(d):
    """The model's (B, S, H, D) projections and output, seen as (B, H, S,
    D) through transpose(1, 2), and contiguous heads: all readable."""
    x = torch.zeros(2, 48, 4, d)
    assert _layout(x.transpose(1, 2)) is None
    assert _layout(x.transpose(1, 2).contiguous()) is None


@pytest.mark.parametrize("shape,strides,base,why", [
    ((2, 4, 16, 64), (4096, 1024, 1, 16), 0, "feature axis"),
    ((2, 4, 16, 64), (4096, 1024, 64, 1), 8, "16-byte boundary"),
    ((2, 4, 16, 64), (4096, 1028, 64, 1), 0, "multiples of 8"),
    ((2, 4, 16, 64), (4100, 1024, 64, 1), 0, "multiples of 8"),
    ((2, 4, 16, 64), (4096, 1024, 68, 1), 0, "multiples of 8"),
])
def test_kernel_layout_rejects_what_it_cannot_read(shape, strides, base, why):
    assert why in flash_attn.layout_error(shape, strides, base)


def test_kernel_layout_ignores_strides_of_single_axes():
    """An axis of extent 1 is never stepped: any stride there is fine."""
    assert flash_attn.layout_error((1, 1, 16, 64), (3, 5, 64, 1), 32) is None
    assert flash_attn.layout_error((1, 2, 16, 64), (3, 5, 64, 1),
                                   32) is not None


@pytest.mark.parametrize("causal", [True, False])
def test_cpu_path_takes_any_layout_and_writes_out(causal):
    """The plain path reads strided views and a non-unit feature stride
    alike, and fills ``out`` in place."""
    q, k, v = (torch.from_numpy(_arr(s)) for s in
               ((2, 40, 4, 16), (2, 40, 2, 16), (2, 40, 2, 16)))
    want = flash_attn.flash_attention(
        q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(), causal=causal)
    out = torch.empty(2, 40, 4, 16)
    got = flash_attn.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                     v.transpose(1, 2), causal=causal,
                                     out=out.transpose(1, 2))
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(out.transpose(1, 2), want)
    # Features along the old sequence axis: a stride of H * D on D.
    qo, ko, vo = (t.transpose(1, 3).transpose(1, 2) for t in (q, k, v))
    assert qo.stride()[-1] != 1
    odd = flash_attn.flash_attention(qo, ko, vo, causal=causal)
    assert torch.equal(odd, flash_attn.flash_attention(
        qo.contiguous(), ko.contiguous(), vo.contiguous(), causal=causal))


def test_wrapper_rejects_an_out_of_another_shape():
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="out"):
        flash_attn.flash_attention(q, q, q, out=torch.zeros(1, 2, 8, 8))


@pytest.mark.parametrize("d,h,hk,causal", [(80, 4, 4, False),
                                          (192, 6, 2, True)])
def test_model_attention_at_the_configs_head_widths(d, h, hk, causal):
    """hubert-xlarge's D 80 (an encoder: bidirectional) and
    nemotron-4-340b's D 192 (causal, grouped heads): the port's chunked
    attention, the function its kernel replaces on the card, equals JAX's
    model attention on the same inputs in float32 to 1e-5 (the two sum
    in other orders; tests/test_torch_lm_models.py), and the kernel's
    wrapper takes the width."""
    assert d in flash_attn.HEAD_DIMS
    q, k, v = _arr((2, 48, h, d)), _arr((2, 48, hk, d)), _arr((2, 48, hk, d))
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal, chunk=16)
    got = attention.chunked_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # The kernel's contract on (B, H, S, D) heads, its plain version here.
    heads = flash_attn.flash_attention(
        *(torch.from_numpy(a).transpose(1, 2) for a in (q, k, v)),
        causal=causal)
    np.testing.assert_allclose(heads.transpose(1, 2).numpy(), got.numpy(),
                               rtol=1e-5, atol=1e-5)
